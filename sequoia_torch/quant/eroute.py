"""E-aware precision routing: pick precision by predicted tokens/sec, not
latency alone.

Port of `sequoia_tpu/quant/eroute.py`. A precision change moves BOTH terms
of the speculative throughput E[accepted] / t_iter: activation quantization
(w8a8) may shrink the verify latency but costs acceptance (the target's
distribution moves away from the draft's). On the JAX package's distilled 8L
pair (QUALITY_r03.json) int8 weights gave E = 3.757 accepted per step and
int8 + w8a8 E = 3.480, so a latency win has to be larger than
3.757 / 3.480 - 1 = 8% of the iteration before w8a8 pays; routing on latency
alone cannot see that.

This module owns the decision:
  * measured per-precision acceptance deltas (of that trained pair;
    overridable with fresh numbers),
  * `e_adjusted_tokens_per_sec`, the objective,
  * `route_w8a8`, which compares E / t across the two precisions and flips
    the global w8a8 switch (`qtensor.set_w8a8`) accordingly. The two
    iteration times are the caller's, measured on its own device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

from .qtensor import set_w8a8

# Accepted-per-step deltas against the same pair's weight-only precision
# (distilled 8L-256h target / 2L-128h draft, 400 steps, held-out rows:
# QUALITY_r03.json). They are properties of a trained pair, not of a device.
# Keyed by what the knob CHANGES: w8a8 against int8 weight-only, an int8 /
# int4 KV cache against a bf16 one. Negative = the knob costs acceptance.
# They depend on the pair's scale, so callers can pass fresh values.
MEASURED_ACCEPT_DELTA: Dict[str, float] = {
    "w8a8": 3.480 - 3.757,      # -0.277 accepted/step (QUALITY_r03)
    "kv_int8": 3.560 - 3.853,   # -0.293 vs the bf16-KV baseline (QUALITY_r03)
    "kv_int4": 3.718 - 3.853,   # -0.135 (QUALITY_r03)
}


class PrecisionChoice(NamedTuple):
    use_w8a8: bool
    base_tps: float      # E/t with weight-only int8
    w8a8_tps: float      # E/t with w8a8 enabled (E penalized by the delta)
    e_base: float
    e_w8a8: float


def e_adjusted_tokens_per_sec(expected_accepted: float, iter_s: float) -> float:
    """The serving objective: tokens emitted per second = E[accepted + bonus
    per step] / step latency."""
    return expected_accepted / max(iter_s, 1e-12)


def w8a8_choice(
    iter_s_base: float,
    iter_s_w8a8: float,
    e_base: float,
    accept_delta: Optional[float] = None,
) -> PrecisionChoice:
    """Decide w8a8 from BOTH terms. `e_base` is the pair's accepted/step at
    weight-only precision (measured or DP-planned); `accept_delta` is the
    measured E cost of activation quantization (default:
    MEASURED_ACCEPT_DELTA['w8a8'])."""
    if accept_delta is None:
        accept_delta = MEASURED_ACCEPT_DELTA["w8a8"]
    e_w8a8 = max(e_base + accept_delta, 1e-6)
    base_tps = e_adjusted_tokens_per_sec(e_base, iter_s_base)
    w8a8_tps = e_adjusted_tokens_per_sec(e_w8a8, iter_s_w8a8)
    return PrecisionChoice(
        use_w8a8=w8a8_tps > base_tps,
        base_tps=base_tps,
        w8a8_tps=w8a8_tps,
        e_base=e_base,
        e_w8a8=e_w8a8,
    )


def route_w8a8(
    iter_s_base: float,
    iter_s_w8a8: float,
    e_base: float,
    accept_delta: Optional[float] = None,
) -> PrecisionChoice:
    """Apply the decision globally: flips `qtensor`'s w8a8 mode to "on" or
    "off" (overriding the row threshold of "auto") and returns the choice
    with both predicted tokens/sec for reporting."""
    choice = w8a8_choice(iter_s_base, iter_s_w8a8, e_base, accept_delta)
    set_w8a8("on" if choice.use_w8a8 else "off")
    return choice
