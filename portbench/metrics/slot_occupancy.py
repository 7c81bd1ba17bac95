"""slot_occupancy: the mean share of the engine's slots that held a
request in a window step, in %."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return 100.0 * sum(len(s.cols) for s in steps) / (len(steps) * run.slots)
