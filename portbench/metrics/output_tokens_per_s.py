"""output_tokens_per_s: every token the engine generated in the window's
steps, over the window's seconds."""
from portbench.bench.timeline import output_tokens_per_s


def read(run):
    return output_tokens_per_s(run)
