"""Device us a prompt token of the eager prefill: the CUDA events of the
program's `prefill` spans over their prompt tokens (the counter
`prefill_tokens`, `sequoia_torch/trace.py`), over the traced window. In a
traced run that is the first sampled request's prefill, with the
profiler's launch cost inside."""

from perfbench.metrics import _spans


def read(run):
    ms = [s.device_ms for s in _spans.spans("prefill") if s.device_ms is not None]
    tokens = _spans.counters().get("prefill_tokens")
    return 1e3 * sum(ms) / tokens if ms and tokens else None
