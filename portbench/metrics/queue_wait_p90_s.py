"""queue_wait_p90_s: 90th percentile of the seconds from a request's
submission to the start of the step that placed it in a slot, as the
harness sees it; one never placed counts to the drain's end."""
from portbench.bench.timeline import due, percentile


def read(run):
    return percentile([(r.placed_t if r.placed_t is not None
                        else run.t_drained) - r.submit_t
                       for r in due(run) if r.submit_t is not None], 90)
