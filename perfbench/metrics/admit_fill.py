"""The share of `serve_device`'s admission entries that carry a prompt
chunk: the program's counters `admit_valid / admit_entries` over the traced
window (`sequoia_torch/trace.py`; W entries a step, the others idle). In a
traced run that is the first admission wave, which fills every entry; the
refills after each harvest, which step a few slots, come later."""

from perfbench.metrics import _spans


def read(run):
    c = _spans.counters()
    return 100.0 * c.get("admit_valid", 0) / c["admit_entries"] if c.get("admit_entries") else None
