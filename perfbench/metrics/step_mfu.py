"""The whole step's share of the chip's bf16 peak: the model flops the
traffic needed in the traced window (both models: every projection, the
head and attention's 4 H D flops a query-key pair, for the rows of
`perfbench/work.py`) over the traced window's seconds at 989 TFLOP/s. The
card's power limit is printed beside it (`device.power_limit_w`)."""

from perfbench.metrics._roofline import PEAKS


def flops(call, d) -> float:
    # projection_params: every layer's projections and the head
    return 2.0 * call.rows * d.projection_params() + 4.0 * d.heads * d.head_dim * call.keys * d.layers


def read(run):
    if not run.trace_s or not run.calls:
        return None
    total = sum(flops(c, run.dims[c.model]) for c in run.calls)
    return 100.0 * total / (run.trace_s * PEAKS["bf16_flops_per_s"])
