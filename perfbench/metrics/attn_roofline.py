"""Tree attention's share of its roofline, draft's and target's calls.

Kernels: every launch whose name holds `tree_attention` (the single and
batched kernels of `csrc/tree_attention.cu` and
`csrc/tree_attention_batched_sm90.cu`, their split-K merge included). Work:
each forward call the traffic needed (`perfbench/work.py`), one launch a
layer: 4 H D flops a query-key pair (scores and values), and the bytes of
the queries, the output and each distinct K and V row read once. Over a
bf16 cache only: another cache format returns nothing.
"""

from perfbench.metrics._roofline import bound_s
from perfbench.trace import kernel_seconds

PATTERNS = ("tree_attention",)


def flops(call, d) -> float:
    return 4.0 * d.heads * d.head_dim * call.keys


def nbytes(call, d) -> float:
    return 2.0 * (2 * call.rows * d.heads * d.head_dim + 2 * call.kv_rows * d.kv_heads * d.head_dim)


def read(run):
    if run.cell.config["kv_cache"] != "bf16":
        return None
    t = kernel_seconds(run.kernels, PATTERNS)
    if not t or not run.calls:
        return None
    bound = sum(run.dims[c.model].layers * bound_s(flops(c, run.dims[c.model]),
                                                   nbytes(c, run.dims[c.model]))
                for c in run.calls)
    return 100.0 * bound / t
