"""The slice kernel's share of its roofline, in %: the least time the
traced frames' work needs on an H100 (`work.py`: the larger of the bytes
at 3.35 TB/s and the operations at 67 TFLOP/s, counted by the benchmark
from the cell's inputs) over the kernel's device time in the profiler's
trace (kernels named `swslice_kernel`)."""


def read(run):
    if run.trace is None or run.bound_s is None:
        return None
    k1 = run.trace.kernel_s(k1=True)
    if k1 <= 0:
        return None
    return 100.0 * run.bound_s / k1
