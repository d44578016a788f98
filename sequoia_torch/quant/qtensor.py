"""Weight-only quantization for target models.

Port of `sequoia_tpu/quant/qtensor.py`. An int8 (or packed-int4) weight with
per-output-channel scales streams half (a quarter) of the bf16 bytes, and
a small-batch forward is bound by the weight stream. The dequantization
happens inside the matmul kernel (`kernels/quant_matmul.py`): the weight
crosses device memory in its quantized form and is expanded in registers.

Which kernel runs follows the weight's layout (int8, packed int4,
panel-tiled int4) and, for int8 weights, the w8a8 mode (`set_w8a8`): with it
the activations are quantized per row to int8 and the product runs on the
int8 tensor cores. Whether the kernel or its plain version runs follows the
tensor's device alone: on a CUDA tensor `matmul` launches the hand-written
kernel, on a CPU tensor it runs the kernel's plain version. There is no
other route.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_tiled,
    quant_matmul_w8a8,
    unpack_int4,
    untile,
)


class QuantizedTensor(NamedTuple):
    """Symmetric per-output-channel quantized matrix.

    q:     int8 `[..., in, out]`, or packed int4 `[..., in/2, out]`
    scale: f32  `[..., 1, out]`
    The bit width follows from the shapes: int4 stores half the `in` rows.
    A stacked weight `[L, ...]` is sliced per layer with `layer(w, i)`, not
    `w[i]` (that indexes the tuple).
    """

    q: torch.Tensor
    scale: torch.Tensor


WeightLike = Union[torch.Tensor, QuantizedTensor]


def layer(w: WeightLike, i: int) -> WeightLike:
    """Layer `i` of a stacked weight, float or quantized."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(w.q[i], w.scale[i])
    return w[i]


def quantize_int8(w: torch.Tensor) -> QuantizedTensor:
    """w: `[..., in, out]` float -> int8 with per-out-channel scale."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def quantize_int4(w: torch.Tensor) -> QuantizedTensor:
    """int4 symmetric per-out-channel, packed two values a byte along `in`
    in the HALF-SPLIT layout: packed row r holds w[r] in the low nibble and
    w[in/2 + r] in the high nibble. The bytes equal the JAX package's: the
    nibbles are combined in int16 and the low byte reinterpreted as int8
    (JAX shifts int8 and lets it wrap, which is the same bits)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / 7.0
    return QuantizedTensor(q=pack_int4(torch.round(wf / scale).clamp(-7, 7)), scale=scale)


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """int4 values `[..., K, N]` (integers in [-8, 7], any dtype) -> the
    half-split packed `[..., K/2, N]` int8: the inverse of `unpack_int4`,
    bit for bit."""
    if v.shape[-2] % 2:
        raise ValueError("int4 packing needs an even `in` dim")
    half = v.shape[-2] // 2
    w = v.to(torch.int16)
    packed = (w[..., :half, :] & 0x0F) | ((w[..., half:, :] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def tile_int4(w: QuantizedTensor, bn0: int = 128) -> QuantizedTensor:
    """Packed int4 `[..., Kq, N]` -> N-panel layout `[..., nt, Kq, bn0]`
    (N zero-padded to a multiple of bn0): panel n is one contiguous
    `Kq * bn0`-byte block, read by `kernels.quant_matmul.quant_matmul_tiled`
    (its CUDA kernel takes `bn0 == 128`). The scale keeps the logical N."""
    q = w.q
    *lead, Kq, N = q.shape
    pad = (-N) % bn0
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    nt = (N + pad) // bn0
    q = q.reshape(*lead, Kq, nt, bn0).transpose(-3, -2).contiguous()
    return QuantizedTensor(q=q, scale=w.scale)


def untile_int4(w: QuantizedTensor) -> QuantizedTensor:
    """Inverse of `tile_int4`."""
    return QuantizedTensor(q=untile(w.q, w.scale.shape[-1]), scale=w.scale)


def is_tiled(w: QuantizedTensor) -> bool:
    """Panel-tiled int4 marker: q carries one more axis than the scale."""
    return w.q.ndim == w.scale.ndim + 1


# W8A8: an int8 weight with at least `min_rows` activation rows is multiplied
# int8 x int8 -> int32 on the int8 tensor cores, after a per-row symmetric
# int8 quantization of the activations: a precision choice of the model, like
# the weight quantization itself. "auto" (the default) does so for a tensor
# on the card with at least `_W8A8_MIN_ROWS` rows; "on" / "off" force it. The
# default of 96 rows is the JAX package's, not a measurement on this card.
_W8A8 = "auto"
_W8A8_MIN_ROWS = 96
# W4A8: a row-major packed int4 weight multiplied int4 x int8 on the int8
# tensor cores after the same per-row activation quantization
# (`quant_matmul(..., unpack="w4a8")`). JAX reaches it only through its
# kernel's `unpack` argument; "on" sends every such matmul of the forward
# there. Off by default.
_W4A8 = "off"


def set_w8a8(mode: str, min_rows: int = None) -> None:
    global _W8A8, _W8A8_MIN_ROWS
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"w8a8 mode must be auto, on or off, got {mode!r}")
    _W8A8 = mode
    if min_rows is not None:
        _W8A8_MIN_ROWS = int(min_rows)


def set_w4a8(mode: str) -> None:
    global _W4A8
    if mode not in ("on", "off"):
        raise ValueError(f"w4a8 mode must be on or off, got {mode!r}")
    _W4A8 = mode


def w8a8_setting() -> tuple:
    """`(w8a8 mode, min_rows, w4a8 mode)` of the activation-quantization
    switches: a captured graph holds the routes it was captured with, so the
    engines key their graphs on them."""
    return _W8A8, _W8A8_MIN_ROWS, _W4A8


def _use_w8a8(x: torch.Tensor) -> bool:
    if _W8A8 == "off":
        return False
    if _W8A8 == "on":
        return True
    rows = x.shape[-2] if x.dim() >= 2 else 1
    return rows >= _W8A8_MIN_ROWS and x.device.type == "cuda"


def quantizes_activations(x: torch.Tensor, w: WeightLike) -> bool:
    """True when `matmul(x, w)` quantizes x per row to int8 (w8a8 on an
    int8 weight, w4a8 on a row-major packed int4 one): the routes whose
    product depends on each row's maximum."""
    if not isinstance(w, QuantizedTensor) or is_tiled(w):
        return False
    if w.q.shape[-2] == x.shape[-1]:
        return _use_w8a8(x)
    return _W4A8 == "on"


def matmul(x: torch.Tensor, w: WeightLike, *, out_dtype=None, amax=None) -> torch.Tensor:
    """`x @ w`, with the dequantization inside the kernel for a
    `QuantizedTensor` (JAX's `preferred_element_type` is `out_dtype`; None
    keeps x's dtype). A float weight goes to `torch.matmul`. `amax` (f32
    `[R, 1]`): the row maxima the activation quantizer scales by, on the
    routes of `quantizes_activations` only (a row-parallel shard of K takes
    those of the whole row)."""
    if amax is not None and not quantizes_activations(x, w):
        raise ValueError("matmul: amax on a route that does not quantize activations")
    if not isinstance(w, QuantizedTensor):
        if out_dtype is None:
            return x @ w
        if x.dtype == out_dtype:
            return x @ w.to(out_dtype)
        if x.device.type == "cuda":
            return torch.mm(x, w, out_dtype=out_dtype)
        return (x.float() @ w.float()).to(out_dtype)
    bits = 8 if w.q.shape[-2] == x.shape[-1] else 4
    if bits == 4 and w.q.shape[-2] * 2 != x.shape[-1]:
        raise ValueError(f"weight {tuple(w.q.shape)} does not fit x {tuple(x.shape)}")
    if is_tiled(w):
        return quant_matmul_tiled(x, w.q, w.scale, out_dtype=out_dtype)
    if bits == 8 and _use_w8a8(x):
        # JAX's `_matmul_w8a8`: per-row activation quantization, the
        # int8 x int8 product and the f32 rescale, here one wrapper call.
        return quant_matmul_w8a8(x, w.q, w.scale, out_dtype=out_dtype, amax=amax)
    if bits == 4 and _W4A8 == "on":
        return quant_matmul(x, w.q, w.scale, bits=4, unpack="w4a8", out_dtype=out_dtype,
                            amax=amax)
    return quant_matmul(x, w.q, w.scale, bits=bits, out_dtype=out_dtype)


def dequantize(w: QuantizedTensor, in_dim: int, dtype=torch.float32) -> torch.Tensor:
    if is_tiled(w):
        w = untile_int4(w)
    q = w.q if w.q.shape[-2] == in_dim else unpack_int4(w.q)
    return (q.float() * w.scale).to(dtype)
