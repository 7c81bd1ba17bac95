"""offer_lag_p90_ms: 90th percentile of how late the load generator
submitted a request after its due time (it submits between engine
steps), in ms."""
from portbench.bench.timeline import due, percentile


def read(run):
    return percentile([1e3 * (r.submit_t - r.due_t) for r in due(run)
                       if r.submit_t is not None], 90)
