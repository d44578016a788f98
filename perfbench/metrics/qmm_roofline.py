"""The int8 weight-only matrix products' share of their roofline: the
target's weight matrices as its family lists them
(`families/<model_type>.py::matmuls`), the head's among them.

Kernels: every launch whose name holds `qmm8_sm90`
(`csrc/quant_matmul_int8_sm90.cu`). Work: each target forward call's rows
through each matrix `[K, N]`: 2 R K N flops, and the int8 weight, its f32
column scales, the bf16 input and the output (bf16; f32 for the head's
logits) once. Only where the target is served int8.
"""

from perfbench.metrics._roofline import bound_s
from perfbench.trace import kernel_seconds

PATTERNS = ("qmm8_sm90",)


def launch_bound(rows: int, K: int, N: int, out_bytes: int = 2) -> float:
    return bound_s(2.0 * rows * K * N, K * N + 4 * N + 2 * rows * K + out_bytes * rows * N)


def call_bound(call, d) -> float:
    return sum(n * sum(launch_bound(call.rows, K, N, ob) for K, N, ob in shapes)
               for n, shapes in d.matmuls())


def read(run):
    if run.formats["target"] != "int8":
        return None
    t = kernel_seconds(run.kernels, PATTERNS)
    calls = [c for c in run.calls if c.model == "target"]
    if not t or not calls:
        return None
    return 100.0 * sum(call_bound(c, run.dims["target"]) for c in calls) / t
