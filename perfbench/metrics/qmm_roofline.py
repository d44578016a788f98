"""The int8 weight-only projections' share of their roofline (the target's
seven projections a layer and its head).

Kernels: every launch whose name holds `qmm8_sm90`
(`csrc/quant_matmul_int8_sm90.cu`). Work: each target forward call's rows
through each projection `[K, N]`: 2 R K N flops, and the int8 weight, its f32
column scales, the bf16 input and the output (bf16; f32 for the head's
logits) once. Only where the target is served int8.
"""

from perfbench.gen import PROJECTIONS
from perfbench.metrics._roofline import bound_s
from perfbench.trace import kernel_seconds

PATTERNS = ("qmm8_sm90",)


def launch_bound(rows: int, K: int, N: int, out_bytes: int = 2) -> float:
    return bound_s(2.0 * rows * K * N, K * N + 4 * N + 2 * rows * K + out_bytes * rows * N)


def call_bound(call, d) -> float:
    layer = sum(launch_bound(call.rows, *d.shape(n)) for n in PROJECTIONS)
    return d.layers * layer + launch_bound(call.rows, d.hidden, d.vocab, out_bytes=4)


def read(run):
    if run.formats["target"] != "int8":
        return None
    t = kernel_seconds(run.kernels, PATTERNS)
    calls = [c for c in run.calls if c.model == "target"]
    if not t or not calls:
        return None
    return 100.0 * sum(call_bound(c, run.dims["target"]) for c in calls) / t
