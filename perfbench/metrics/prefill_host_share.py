"""The host's share of the eager prefill: the host ms of the program's
`prefill` spans over their device ms (`sequoia_torch/trace.py`), summed
over the traced window. Near 100%, the host's launches pace the prefill and
the device waits for them; far below, the device paces it."""

from perfbench.metrics import _spans


def read(run):
    spans = [s for s in _spans.spans("prefill") if s.device_ms]
    if not spans:
        return None
    return 100.0 * sum(s.host_ms for s in spans) / sum(s.device_ms for s in spans)
