"""Fused dequantize + matmul for int8 and packed-int4 weights: CUDA kernels
and plain version.

Port of `sequoia_tpu/kernels/quant_matmul.py::quant_matmul` (`bits=8`:
`_kernel_int8`; `bits=4`: `_kernel_int4`, whose "shift" and "float" unpack
variants compute the same numbers, so one kernel stands for both).
`out [R, N] = (x [R, K] @ dequant(q)) * scale [1, N]`, accumulated in f32,
scaled once at the end, cast to `out_dtype` (default x's dtype).

Layouts, as in JAX:
- int8: q `[K, N]` int8;
- int4: q `[K/2, N]` int8, half-split packed: byte `[k, n]` holds w[k, n]
  in its low nibble and w[K/2 + k, n] in its high nibble, both signed
  (a nibble 0x8 is -8).

On a CUDA tensor `quant_matmul` launches the kernel of
`csrc/quant_matmul.cu` (or raises); on a CPU tensor it runs
`quant_matmul_plain`. What differs from the TPU version: no block-size
arguments (Pallas's VMEM budget has no meaning here); no padding of q, x or
scale (the kernel masks ragged edges); the K axis is split across blocks,
with f32 partials summed by a second small kernel, where the output tiles
alone would leave the card's SMs idle; bf16 x runs on the tensor cores
(`mma.sync`), f32 x on the CUDA cores in full f32; the w4a8 variant is not
ported yet.
"""

from __future__ import annotations

import functools
import math

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NAME = {8: "quant_matmul_int8", 4: "quant_matmul_int4"}
# Kernel geometry, as in csrc/quant_matmul.cu.
_BN = 128                   # output columns per block
_STAGE = {8: 64, 4: 32}     # q rows per K stage
_TARGET_BLOCKS = 264        # two blocks for each of the H100's 132 SMs


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """`[..., in/2, out]` half-split packed -> `[..., in, out]` int8, each
    nibble sign-extended (0x8 is -8)."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = (((p >> 4) & 0x0F) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def quant_matmul_plain(x, q, scale, *, bits: int, out_dtype=None):
    """`(x.float() @ q.float()) * scale` in f32 (int4: q unpacked first)."""
    w = q if bits == 8 else unpack_int4(q)
    y = (x.float() @ w.float()) * scale.float().reshape(1, -1)
    return y.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=1024)
def split_k(R: int, K: int, N: int, bits: int) -> tuple:
    """`(splits, q rows per split)` for the tensor-core kernel: enough
    blocks to fill the card, but the f32 partials stay within half the
    weight's bytes, and every split holds whole K stages."""
    mt = 1 if R <= 16 else 2 if R <= 32 else 4          # 16-row MMA tiles per block
    tiles = math.ceil(R / (16 * mt)) * math.ceil(N / _BN)
    Kq = K if bits == 8 else K // 2
    stages = math.ceil(Kq / _STAGE[bits])
    want = math.ceil(_TARGET_BLOCKS / tiles)
    cap = max(1, Kq // (8 * R))
    splits = max(1, min(want, cap, stages))
    per = math.ceil(stages / splits)
    return math.ceil(stages / per), per * _STAGE[bits]


def _check(x, q, scale, bits, out_dtype):
    if bits not in (8, 4):
        raise ValueError(f"quant_matmul: bits must be 8 or 4, got {bits}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} and q {tuple(q.shape)} "
                         "must be 2-D")
    R, K = x.shape
    Kq, N = q.shape
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"quant_matmul: x {x.dtype} / out {out_dtype}: "
                        "float32 or bfloat16 only")
    if q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: q must be int8, got {q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: scale must be float32, got {scale.dtype}")
    if Kq * (1 if bits == 8 else 2) != K:
        raise ValueError(f"quant_matmul: q {tuple(q.shape)} does not fit x "
                         f"{tuple(x.shape)} at {bits} bits")
    if scale.numel() != N or scale.shape[-1] != N:
        raise ValueError(f"quant_matmul: scale {tuple(scale.shape)} for N={N}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    for name, t in (("x", x), ("q", q)):
        if t.data_ptr() % 16:   # the kernel loads 16 bytes at a time
            raise ValueError(f"quant_matmul: {name} is not 16-byte aligned")


def quant_matmul(x, q, scale, *, bits: int, out_dtype=None):
    """`out [R, N]` = `x @ dequant(q) * scale` (see module doc)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale, bits=bits, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    _check(x, q, scale, bits, out_dtype)
    R, K = x.shape
    N = q.shape[1]
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    splits, per = split_k(R, K, N, bits) if x.dtype == torch.bfloat16 else (1, 0)
    # The f32 partials of the K splits. Freed on return, which is safe: the
    # caching allocator hands the block only to work queued after this
    # launch on the same stream.
    ws = (torch.empty((splits, R, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = build.load()
    fn = lib.sequoia_quant_matmul_int8 if bits == 8 else lib.sequoia_quant_matmul_int4
    rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), R, K, N, splits, per,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, _NAME[bits])
    build.launches[_NAME[bits]] += 1
    return out
