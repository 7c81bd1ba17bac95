"""queue_matmul_roofline: the bound seconds of the ``queue_matmul`` calls
of the profiled steps (``bench.roofline.queue_matmul_bound``) over the
device seconds of the ``queue_matmul_*`` kernels the profiler saw, in %."""
from portbench.bench.roofline import queue_matmul_bound
from portbench.bench.trace import kernel_seconds


def read(run):
    t = kernel_seconds(run.trace, "queue_matmul")
    if t is None:
        return None
    bound = sum(queue_matmul_bound(run.model, s.cols)
                for s in run.steps if s.profiled)
    return 100.0 * bound / t
