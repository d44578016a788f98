"""The reference's own rule for weights served in fewer bits.

Symmetric, one scale per output column. int8 / int4: scale = max |w| over
the column / (2^(bits-1) - 1), the weight rounded to the nearest multiple of
it (halves to even) and clipped to +-(2^(bits-1) - 1). fp8: scale = max |w|
/ 448 (e4m3's largest value), the scaled weight rounded to the nearest e4m3
value. `as_served` returns the values the product then sees, in float32.
"bf16" is the drawn bf16 value itself.
"""

from __future__ import annotations

import torch

LEVELS = {"int8": 127.0, "int4": 7.0}


def as_served(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """`w` `[in, out]` (bf16) as format `fmt` serves it, in float32."""
    wf = w.float()
    if fmt == "bf16":
        return wf
    if fmt == "fp8":
        scale = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 448.0
        return (wf / scale).to(torch.float8_e4m3fn).float() * scale
    top = LEVELS[fmt]
    scale = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / top
    return torch.round(wf / scale).clamp(-top, top) * scale
