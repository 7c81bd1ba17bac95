"""ttft_p90_s: 90th percentile (nearest rank) over every request due in
the window of the seconds from its due time to its first token on the
host; a refused or unanswered request counts to the drain's end."""
from portbench.bench.timeline import percentile, ttft_s


def read(run):
    return percentile(ttft_s(run), 90)
