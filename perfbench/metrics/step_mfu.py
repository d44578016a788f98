"""The whole step's share of the chip's bf16 peak: the model flops the
traffic needed in the traced window (both models: each query row through
every weight matrix, and attention's flops, as each model's family counts
them, `families/<model_type>.py`, for the rows of `perfbench/work.py`) over
the traced window's seconds at 989 TFLOP/s. The card's power limit is
printed beside it (`device.power_limit_w`)."""

from perfbench.metrics._roofline import PEAKS


def flops(call, d) -> float:
    return call.rows * d.row_flops() + sum(f * n for f, _, n in d.attention(call))


def read(run):
    if not run.trace_s or not run.calls:
        return None
    total = sum(flops(c, run.dims[c.model]) for c in run.calls)
    return 100.0 * total / (run.trace_s * PEAKS["bf16_flops_per_s"])
