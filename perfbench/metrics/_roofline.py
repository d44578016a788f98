"""Shared by the roofline and MFU readers: the chip's peaks and a bound."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time one launch can take: its operations at the bf16 peak
    or its bytes at the HBM peak, whichever is longer."""
    return max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])
