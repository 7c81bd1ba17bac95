"""tpot_p90_ms: 90th percentile (nearest rank) over every request due in
the window of (last token - first token) / (output tokens - 1), in ms; an
unfinished request counts to the drain's end."""
from portbench.bench.timeline import percentile, tpot_ms


def read(run):
    return percentile(tpot_ms(run), 90)
