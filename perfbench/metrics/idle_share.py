"""The device's idle share: 1 less the union of the kernel and memory-copy
intervals of the profiler's trace over the traced window."""

from perfbench.trace import union_seconds


def read(run):
    if not run.trace_s or not run.kernels:
        return None
    return 100.0 * (1.0 - union_seconds([(a, b) for _, a, b in run.kernels]) / run.trace_s)
