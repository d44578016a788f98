"""Device ms of one replay of `serve_device`'s `admit` graph: the CUDA
events of the program's `replay.admit` spans (`sequoia_torch/trace.py`),
mean over the traced window. In a traced run that is the profiler's first
`trace_seconds` of the first batch: the first admission wave, every slot
admitted together, before any harvest."""

from perfbench.metrics import _spans


def read(run):
    ms = [s.device_ms for s in _spans.spans("replay.admit") if s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
