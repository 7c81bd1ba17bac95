"""mfu: the model's operations in the window's steps (each token through
the products it touches, the routed experts only, its attention over its
context, and the head once a slot) over window seconds x 989e12 bf16
FLOP/s, in %."""
from portbench.bench.roofline import PEAK_FLOPS, model_flops


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    flops = sum(model_flops(run.model, s.cols) for s in steps)
    return 100.0 * flops / (run.window_s * PEAK_FLOPS["bfloat16"])
