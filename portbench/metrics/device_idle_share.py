"""device_idle_share: 100 x (1 - device-busy seconds / traced seconds)
over the profiled part of the window (busy: the union of the device
operations the profiler saw)."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
