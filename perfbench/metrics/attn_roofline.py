"""Tree attention's share of its roofline, draft's and target's calls.

Kernels: every launch whose name holds `tree_attention` (the single and
batched kernels of `csrc/tree_attention.cu` and
`csrc/tree_attention_batched_sm90.cu`, their split-K merge included). Work:
each forward call the traffic needed (`perfbench/work.py`), its attention's
flops and bytes a launch as the model's family counts them
(`families/<model_type>.py::attention`: the flops of every query-key pair,
and the bytes of the queries, the output and each distinct cache row read
once). Over a bf16 cache only: another cache format returns nothing.
"""

from perfbench.metrics._roofline import bound_s
from perfbench.trace import kernel_seconds

PATTERNS = ("tree_attention",)


def call_bound(call, d) -> float:
    return sum(n * bound_s(f, b) for f, b, n in d.attention(call))


def read(run):
    if run.cell.config["kv_cache"] != "bf16":
        return None
    t = kernel_seconds(run.kernels, PATTERNS)
    if not t or not run.calls:
        return None
    return 100.0 * sum(call_bound(c, run.dims[c.model]) for c in run.calls) / t
