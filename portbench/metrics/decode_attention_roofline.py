"""decode_attention_roofline: the bound seconds of the ``decode_attention``
calls of the profiled steps (``bench.roofline.decode_attention_bound``,
from the harness's count of each slot's length) over the device seconds of
the ``decode_attention_*`` kernels the profiler saw, in %."""
from portbench.bench.roofline import decode_attention_bound
from portbench.bench.trace import kernel_seconds


def read(run):
    t = kernel_seconds(run.trace, "decode_attention")
    if t is None:
        return None
    bound = sum(decode_attention_bound(run.model, s.cols)
                for s in run.steps if s.profiled)
    return 100.0 * bound / t
