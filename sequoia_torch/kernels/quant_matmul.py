"""Fused dequantize + matmul for int8 and packed-int4 weights: CUDA kernels
and plain versions.

Port of `sequoia_tpu/kernels/quant_matmul.py`:
- `quant_matmul` with `bits=8` (`_kernel_int8`) and `bits=4` (`_kernel_int4`,
  whose "shift" and "float" unpack variants compute the same numbers, so one
  kernel stands for both and for "auto"):
  `out [R, N] = (x [R, K] @ dequant(q)) * scale [1, N]`, accumulated in f32,
  scaled once at the end, cast to `out_dtype` (default x's dtype);
- `quant_matmul(..., bits=4, unpack="w4a8")` (`_kernel_int4_w4a8`): the
  activations are quantized per row to int8 first (`quantize_activations`),
  the products run int8 x int8 -> int32 on the int8 tensor cores, and
  `out = float(acc) * sx [R, 1] * scale [1, N]`. The int8-weight product
  with quantized activations is `quant_matmul_w8a8`, the route that
  `quant/qtensor.py`'s w8a8 mode needs at every row count. The int32 sum
  runs over the whole K. (JAX casts each K block's int32 partial to f32 and
  adds in f32, which equals one int32 sum while the total stays under 2^24:
  at int4 for K <= 16512, since 127 * 8 * K < 2^24.)
- `quant_matmul_tiled` (`_kernel_int4_tiled`): the int4 product over the
  N-panel layout `q [nt, K/2, bn0]` of `quant/qtensor.py::tile_int4`; the
  logical N is `scale.shape[-1]`.

Layouts, as in JAX:
- int8: q `[K, N]` int8;
- int4: q `[K/2, N]` int8, half-split packed: byte `[k, n]` holds w[k, n]
  in its low nibble and w[K/2 + k, n] in its high nibble, both signed
  (a nibble 0x8 is -8);
- tiled int4: q `[nt, K/2, bn0]`, panel n holding columns
  `[n bn0, (n + 1) bn0)` of the packed matrix, zero past N.

On a CUDA tensor each function launches its kernel (or raises); on a CPU
tensor it runs its plain version. The kernels:
- bf16 x and x8: wgmma + TMA, the weight streamed once for R <= 256, K
  split inside a thread-block cluster (`split_cluster`): int8 weights
  (`quant_matmul_int8_wgmma`) and w8a8 (`quant_matmul_w8a8_wgmma`) on
  `csrc/quant_matmul_int8_sm90.cu`; int4 (`quant_matmul_int4_wgmma`), tiled
  int4 (`quant_matmul_tiled_wgmma`) and w4a8 (`quant_matmul_w4a8`, the x8
  instantiation) on `csrc/quant_matmul_int4_sm90.cu`.
  `quant_matmul_int8_sm90_model`, `quant_matmul_int4_sm90_model` and
  `quant_matmul_w4a8_sm90_model` are CPU models of their decompositions, on
  no path;
- the activation quantizer of w4a8 and w8a8 (`quantize_activations`):
  `csrc/quant_matmul_a8.cu`; the matmul after it is a programmatic
  dependent launch, whose set-up overlaps the quantizer;
- f32 x, every weight format (the f32 models): x split exactly into three
  bf16 planes (`split_bf16x3`, `csrc/split_bf16x3.cu`), then the planes
  instantiation of the int8 or int4 wgmma kernel, a programmatic dependent
  launch after the split: one weight fragment feeds a wgmma per plane, each
  product exact, so only the f32 summation differs from the plain version
  (counters `quant_matmul_int8`, `quant_matmul_int4`, `quant_matmul_tiled`;
  `quant_matmul_f32x3_model` is the CPU model of its decomposition).
What differs from the TPU versions: no block-size arguments (Pallas's VMEM
budget has no meaning here); no padding of q, x or scale (the kernels mask
ragged edges); the K axis is split across the blocks of a cluster where the
output tiles alone would leave the card's SMs idle; the tiled kernels take
`bn0 == 128` only (the plain version any `bn0`).
"""

from __future__ import annotations

import functools
import math

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
UNPACK = ("auto", "shift", "float", "w4a8")
_BN = 128                   # the tiled kernels' bn0
# Kernel geometry, as in csrc/quant_matmul_int8_sm90.cu and
# csrc/quant_matmul_int4_sm90.cu.
SM90_BM = 128               # output columns per block (two warpgroups of 64)
# Logical k per stage: 128 bytes of a bf16 x row (int8), of an x8 row
# (w8a8), or 64 packed q rows (int4 and w4a8: their low and high nibbles).
SM90_KB = {"int8": 64, "w8a8": 128, "int4": 128, "w4a8": 128, "int8_f32": 64, "int4_f32": 128}
SM90_MAX_RT = 256           # rows per block (wgmma's largest N)
# The planes instantiations (f32 x) hold three x tiles a stage, so their row
# tiles stop lower (kMaxRTPlanes of the two kernels).
SM90_F32_MAX_RT = {"int8_f32": 128, "int4_f32": 64}
# Each kind's x type, as the C entries number it: bf16, int8 x8, bf16 planes.
_XTYPE = {"int8": 0, "int4": 0, "w8a8": 1, "w4a8": 1, "int8_f32": 2, "int4_f32": 2}
SM90_MAX_SPLIT = 4          # blocks per cluster, each a slice of K


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """`[..., in/2, out]` half-split packed -> `[..., in, out]` int8, each
    nibble sign-extended (0x8 is -8)."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = (((p >> 4) & 0x0F) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def untile(q: torch.Tensor, N: int) -> torch.Tensor:
    """N-panel `[..., nt, Kq, bn0]` -> row-major `[..., Kq, N]`."""
    *lead, nt, Kq, bn0 = q.shape
    return q.transpose(-3, -2).reshape(*lead, Kq, nt * bn0)[..., :N].contiguous()


def quantize_activations_plain(x: torch.Tensor, amax: torch.Tensor = None):
    """Per-row symmetric int8: `sx [R, 1] = max(amax |x|, 1e-8) / 127` (f32),
    `x8 = clip(round(x / sx), -127, 127)`. True divisions (the divisor is a
    tensor: PyTorch multiplies by the reciprocal of a Python scalar on the
    card) and round-half-to-even, so x8 and sx equal JAX's bit for bit.
    `amax` (f32 `[R, 1]`, at least each row's own): the row maxima to scale
    by instead of x's, e.g. those of the whole row when x is one shard of
    its K (a row-parallel layer under tensor parallelism)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = amax.clamp_min(1e-8) / torch.full((), 127.0, device=x.device)
    x8 = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    return x8, sx


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 x `[R, K]` -> bf16 planes `[3, R, K]` with x = b0 + b1 + b2, by
    truncation on the f32 bit patterns: b0 is x with its low 16 bits zeroed,
    r = x - b0 (exact), b1 is r with its low 16 bits zeroed, b2 = r - b1
    (exact); each plane is the high half of its f32 bits, each residual
    takes x's sign (so -0 gives three -0). b0 and b1 are bf16 values by
    construction; b2 has at most 8 significant bits, all at or above 2^-133
    (bf16's least subnormal) wherever |x| >= 2^-110, so there the planes sum
    back to x exactly (in f32, in plane order). Below, b2 is truncated
    toward zero: |x - (b0 + b1 + b2)| < 2^-133. `csrc/split_bf16x3.cu` does
    the same, bit for bit."""
    u = x.contiguous().view(torch.int32)
    sign = u & torch.iinfo(torch.int32).min
    high = -(1 << 16)                    # 0xFFFF0000
    r = (x - (u & high).view(torch.float32)).view(torch.int32) | sign
    r2 = (r.view(torch.float32) - (r & high).view(torch.float32)).view(torch.int32) | sign
    # An arithmetic shift leaves each high half as a signed 16-bit integer.
    return (torch.stack([u, r, r2]) >> 16).to(torch.int16).view(torch.bfloat16)


QUANT_MAX_VECS, QUANT_MAX_THREADS = 4, 512


def quantizer_block(K: int, itemsize: int, aligned: bool = True) -> tuple:
    """`(elements per load, threads per block)` of the activation quantizer
    for rows of K elements of `itemsize` bytes, as `csrc/quant_matmul_a8.cu`
    picks them: 16-byte vectors where K and the pointers allow
    (`aligned`), else single elements; one thread per load, whole warps,
    at most 512 threads. One block per row."""
    e = 16 // itemsize
    if K % e or not aligned:
        e = 1
    return e, min(QUANT_MAX_THREADS, -(-(K // e) // 32) * 32)


def _int_dot(x8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x8 @ w` of two int8 matrices, exact. int32 on the CPU; PyTorch has
    no integer matmul on the card, where f64 holds every sum exactly."""
    if x8.device.type == "cpu":
        return x8.int() @ w.int()
    return x8.double() @ w.double()


def quant_matmul_a8_plain(x8, sx, q, scale, *, bits: int, out_dtype):
    """`float(x8 @ w) * sx * scale`, the integer product exact."""
    w = q if bits == 8 else unpack_int4(q)
    y = _int_dot(x8, w).float() * sx.reshape(-1, 1) * scale.float().reshape(1, -1)
    return y.to(out_dtype)


def quant_matmul_plain(x, q, scale, *, bits: int, out_dtype=None, unpack: str = "auto",
                      amax=None):
    """`(x.float() @ q.float()) * scale` in f32 (int4: q unpacked first);
    `unpack="w4a8"`: x quantized per row (by `amax` when given), then the
    exact integer product."""
    out_dtype = out_dtype or x.dtype
    if unpack == "w4a8":
        x8, sx = quantize_activations_plain(x, amax)
        return quant_matmul_a8_plain(x8, sx, q, scale, bits=bits, out_dtype=out_dtype)
    w = q if bits == 8 else unpack_int4(q)
    y = (x.float() @ w.float()) * scale.float().reshape(1, -1)
    return y.to(out_dtype)


def quant_matmul_w8a8_plain(x, q, scale, *, out_dtype=None, amax=None):
    x8, sx = quantize_activations_plain(x, amax)
    return quant_matmul_a8_plain(x8, sx, q, scale, bits=8, out_dtype=out_dtype or x.dtype)


def quant_matmul_tiled_plain(x, q, scale, *, out_dtype=None):
    """Untile, then the int4 plain version (any `bn0`)."""
    return quant_matmul_plain(x, untile(q, scale.shape[-1]), scale, bits=4,
                              out_dtype=out_dtype)


def row_tile(R: int) -> int:
    """Rows per block of the wgmma kernel (its wgmma N): the least of 8,
    16, .., 256 that holds R; 256 (and R / 256 row tiles) above."""
    rt = 8
    while rt < min(R, SM90_MAX_RT):
        rt *= 2
    return rt


def split_cluster(R: int, K: int, N: int, kb: int, max_clusters, rt: int = SM90_MAX_RT) -> int:
    """Cluster size (1..4) of a wgmma kernel whose stages hold `kb` logical
    k (`SM90_KB`): the blocks of a cluster share one 128-column tile of `rt`
    rows and split its K stages. `max_clusters(c)` is how many clusters of c
    blocks the card holds at once (cudaOccupancyMaxActiveClusters). The
    largest c whose clusters all fit in one wave, keeping >= 4 stages per
    block; 1 when even single blocks take more than one wave (on the H100 a
    second wave of clusters ran slower than one wave of whole tiles;
    PERF.md §6)."""
    tiles = math.ceil(N / SM90_BM) * math.ceil(R / rt)
    stages = math.ceil(K / kb)
    best = 1
    for c in range(2, SM90_MAX_SPLIT + 1):
        if stages < 4 * c:
            break
        if tiles <= max_clusters(c):
            best = c
    return best


def sm90_tiling(R: int, K: int, N: int, kind: str, max_clusters) -> tuple:
    """`(row tile, cluster size)` of wgmma kernel `kind` (`SM90_KB`), the
    one place that picks both for the int8 and the int4 kernels;
    `max_clusters(rt, c)` as in `split_cluster`, for blocks of `rt` rows.
    The row tile is `row_tile(R)`, with two exceptions. The planes
    instantiations (f32 x: "int8_f32", "int4_f32") stop at
    `SM90_F32_MAX_RT`; above it R runs several row tiles, the later ones
    reading the weight from L2. w4a8 above 128 rows takes 128-row tiles
    where their clusters fit one wave and occupy more blocks (at N = 4096
    and R = 256: 64 tiles in clusters of 2 on 128 SMs, against 32 in
    clusters of 3); csrc/quant_matmul_int4_sm90.cu, file note. Only w4a8
    takes that rule because only w4a8 was timed with it; the other kinds
    keep the tiling their times were taken with (ROADMAP B′1)."""
    kb = SM90_KB[kind]
    rt = min(row_tile(R), SM90_F32_MAX_RT.get(kind, SM90_MAX_RT))
    c = split_cluster(R, K, N, kb, functools.partial(max_clusters, rt), rt)
    if kind == "w4a8" and rt > 128:
        c2 = split_cluster(R, K, N, kb, functools.partial(max_clusters, 128), 128)
        cols = math.ceil(N / SM90_BM)
        tiles2 = cols * math.ceil(R / 128)
        if tiles2 <= max_clusters(128, c2) and tiles2 * c2 > cols * math.ceil(R / rt) * c:
            return 128, c2
    return rt, c


def quant_matmul_int8_sm90_model(x, q, scale, *, sx=None, splits: int = 1, out_dtype=None):
    """CPU model of the wgmma kernel's decomposition (`csrc/
    quant_matmul_int8_sm90.cu`), on no path: K cut in stages of 64 (bf16 x)
    or 128 (int8 x8) k, dealt to `splits` cluster ranks in contiguous runs
    of ceil(stages / splits); each rank sums its stages in order (f32, or
    exactly in integers for x8); the ranks' partials are added in rank
    order; then the epilogue: `acc * scale`, or `float(acc) * sx * scale` in
    that order. `sx` [R, 1] (or [R]) marks x as x8."""
    a8 = sx is not None
    R, K = x.shape
    N = q.shape[1]
    kb = SM90_KB["w8a8" if a8 else "int8"]
    per = math.ceil(math.ceil(K / kb) / splits) * kb
    total = None
    for b in range(splits):
        acc = torch.zeros((R, N), dtype=torch.int64 if a8 else torch.float32)
        for k0 in range(b * per, min(K, (b + 1) * per), kb):
            xs, qs = x[:, k0:k0 + kb], q[k0:k0 + kb]
            acc += xs.long() @ qs.long() if a8 else xs.float() @ qs.float()
        total = acc if total is None else total + acc
    if a8:
        y = total.float() * sx.reshape(-1, 1) * scale.float().reshape(1, -1)
    else:
        y = total * scale.float().reshape(1, -1)
    return y.to(out_dtype or (torch.float32 if a8 else x.dtype))


def quant_matmul_int4_sm90_model(x, q, scale, *, splits: int = 1, out_dtype=None):
    """CPU model of the int4 wgmma kernel's decomposition (`csrc/
    quant_matmul_int4_sm90.cu`), on no path: the K/2 packed rows cut in
    stages of 64, dealt to `splits` cluster ranks in contiguous runs of
    ceil(stages / splits); each rank sums its stages in order, each stage's
    16-row k steps in order, each step the low-nibble product (x columns
    k..) and then the high-nibble one (x columns K/2 + k..), in f32; the
    ranks' partials are added in rank order; then `acc * scale`. `q` is
    packed `[K/2, N]` or the panel layout `[nt, K/2, bn0]` (untiled first:
    the panels move bytes, not sums)."""
    N = scale.shape[-1]
    if q.dim() == 3:
        q = untile(q, N)
    R, K = x.shape
    Kq = K // 2
    w = unpack_int4(q).float()
    lo, hi = w[:Kq], w[Kq:]
    xf = x.float()
    kp = SM90_KB["int4"] // 2
    per = math.ceil(math.ceil(Kq / kp) / splits) * kp
    total = None
    for b in range(splits):
        acc = torch.zeros((R, N), dtype=torch.float32)
        for k0 in range(b * per, min(Kq, (b + 1) * per), 16):
            k1 = min(Kq, k0 + 16)
            acc += xf[:, k0:k1] @ lo[k0:k1]
            acc += xf[:, Kq + k0:Kq + k1] @ hi[k0:k1]
        total = acc if total is None else total + acc
    return (total * scale.float().reshape(1, -1)).to(out_dtype or x.dtype)


def quant_matmul_f32x3_model(x, q, scale, *, bits: int, splits: int = 1, out_dtype=None):
    """CPU model of the f32-x route's decomposition (`split_bf16x3`, then the
    planes instantiation of `csrc/quant_matmul_int8_sm90.cu` at bits 8 or
    `csrc/quant_matmul_int4_sm90.cu` at bits 4), on no path: x split into
    three bf16 planes (`split_bf16x3_plain`); the K rows of q (int8) or K/2
    packed rows (int4) cut in stages of 64, dealt to `splits` cluster ranks
    in contiguous runs of ceil(stages / splits); each rank sums its stages
    in order, each stage's 16-row k steps in order, each step (int4: the low
    nibbles' product, then the high nibbles') the products of planes 0, 1
    and 2 in order, in f32; the ranks' partials are added in rank order;
    then `acc * scale`. `q` as for the int8 and int4 models (int4 panels
    are untiled first)."""
    R, K = x.shape
    N = scale.shape[-1]
    planes = split_bf16x3_plain(x.float()).float()
    if bits == 8:
        Kq, halves = K, [(0, q.float())]    # (x column of weight row 0, weight rows)
    else:
        Kq = K // 2
        w = unpack_int4(untile(q, N) if q.dim() == 3 else q).float()
        halves = [(0, w[:Kq]), (Kq, w[Kq:])]
    kp = SM90_KB["int8_f32"] if bits == 8 else SM90_KB["int4_f32"] // 2
    per = math.ceil(math.ceil(Kq / kp) / splits) * kp
    total = None
    for b in range(splits):
        acc = torch.zeros((R, N), dtype=torch.float32)
        for k0 in range(b * per, min(Kq, (b + 1) * per), 16):
            k1 = min(Kq, k0 + 16)
            for off, wh in halves:
                for p in range(3):
                    acc += planes[p, :, off + k0:off + k1] @ wh[k0:k1]
        total = acc if total is None else total + acc
    return (total * scale.float().reshape(1, -1)).to(out_dtype or x.dtype)


def nibbles_s8(q: torch.Tensor):
    """The w4a8 kernel's nibble -> s8 step on packed bytes: `(b << 4) & 0xF0`
    and `b & 0xF0` as signed bytes, i.e. 16 x the low and 16 x the high
    nibble, each sign-extended (0x8 is -8, so -128)."""
    b = q.to(torch.int32)
    lo = ((b << 4) & 0xF0).to(torch.uint8).view(torch.int8)
    hi = (b & 0xF0).to(torch.uint8).view(torch.int8)
    return lo, hi


def quant_matmul_w4a8_sm90_model(x, q, scale, *, splits: int = 1, out_dtype=None):
    """CPU model of the w4a8 kernel's decomposition (the x8 instantiation of
    `csrc/quant_matmul_int4_sm90.cu`), on no path: x quantized per row
    (`quantize_activations_plain`); the K/2 packed rows cut in stages of 64,
    dealt to `splits` cluster ranks in contiguous runs of ceil(stages /
    splits); each rank sums, in int32, its stages' 32-row k steps, each the
    product of the x8 columns k.. with 16 x the low nibbles (`nibbles_s8`)
    and of the columns K/2 + k.. with 16 x the high ones; each rank's sum is
    shifted right by 4; the ranks' partials are added in rank order; then
    `float(acc) * sx * scale` in that order. Raises where a rank's int32
    sum would overflow."""
    N = scale.shape[-1]
    R, K = x.shape
    Kq = K // 2
    x8, sx = quantize_activations_plain(x)
    lo, hi = (w.long() for w in nibbles_s8(q))
    x8 = x8.long()
    kp = SM90_KB["w4a8"] // 2
    per = math.ceil(math.ceil(Kq / kp) / splits) * kp
    total = torch.zeros((R, N), dtype=torch.int64)
    for b in range(splits):
        acc = torch.zeros((R, N), dtype=torch.int64)
        for k0 in range(b * per, min(Kq, (b + 1) * per), 32):
            k1 = min(Kq, k0 + 32)
            acc += x8[:, k0:k1] @ lo[k0:k1]
            acc += x8[:, Kq + k0:Kq + k1] @ hi[k0:k1]
            if acc.abs().max() >= 2 ** 31:
                raise OverflowError("w4a8: the int32 sum of 16 x the products overflows")
        assert bool((acc % 16 == 0).all())
        total += acc >> 4
    y = total.float() * sx.reshape(-1, 1) * scale.float().reshape(1, -1)
    return y.to(out_dtype or x.dtype)


def _check(x, q, scale, bits, out_dtype, *, tiled=False):
    name = "quant_matmul_tiled" if tiled else "quant_matmul"
    if bits not in (8, 4):
        raise ValueError(f"{name}: bits must be 8 or 4, got {bits}")
    if x.dim() != 2 or q.dim() != (3 if tiled else 2):
        raise ValueError(f"{name}: x {tuple(x.shape)} / q {tuple(q.shape)}: x must "
                         f"be 2-D and q {3 if tiled else 2}-D")
    R, K = x.shape
    Kq = q.shape[-2]
    N = scale.shape[-1]
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x {x.dtype} / out {out_dtype}: "
                        "float32 or bfloat16 only")
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8, got {q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name}: scale must be float32, got {scale.dtype}")
    if Kq * (1 if bits == 8 else 2) != K:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit x "
                         f"{tuple(x.shape)} at {bits} bits")
    if tiled:
        nt, _, bn0 = q.shape
        if bn0 != _BN:
            raise ValueError(f"{name}: the kernel takes {_BN}-column panels, got {bn0}")
        if not (nt - 1) * bn0 < N <= nt * bn0:
            raise ValueError(f"{name}: scale {tuple(scale.shape)} for {nt} panels")
    elif q.shape[1] != N:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for N={q.shape[1]}")
    if scale.numel() != N:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} must hold N={N} values")
    for nm, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name}: {nm} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    for nm, t in (("x", x), ("q", q)):
        if t.data_ptr() % 16:   # the kernels load 16 bytes at a time
            raise ValueError(f"{name}: {nm} is not 16-byte aligned")


@functools.lru_cache(maxsize=64)
def _max_clusters(kind: str, rt: int, c: int, device: int) -> int:
    with torch.cuda.device(device):
        lib = build.load()
        fn = (lib.sequoia_qmm4_sm90_max_clusters if kind in ("int4", "w4a8", "int4_f32")
              else lib.sequoia_qmm8_sm90_max_clusters)
        return fn(_XTYPE[kind], rt, c)


@functools.lru_cache(maxsize=1024)
def _sm90_tiling(R: int, K: int, N: int, kind: str, device: int) -> tuple:
    """`sm90_tiling` of wgmma kernel `kind` (a key of `SM90_KB`) on the card
    `device`."""
    return sm90_tiling(R, K, N, kind, functools.partial(_max_clusters, kind, device=device))


def _launch_int8_sm90(x, q, scale, out_dtype, sx=None, *, pdl=False):
    """The int8 wgmma kernel: bf16 x, int8 x8 with its row scales `sx`, or
    the bf16 planes `[3, R, K]` of f32 x (`split_bf16x3`); `pdl` (x8,
    planes): a programmatic dependent launch after the kernel that wrote x
    (the quantizer or the split, right before it in the stream)."""
    R, K = x.shape[-2:]
    N = q.shape[1]
    kind = "w8a8" if sx is not None else "int8_f32" if x.dim() == 3 else "int8"
    rt, splits = _sm90_tiling(R, K, N, kind, x.device.index)
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    rc = build.load().sequoia_qmm8_sm90(
        x.data_ptr(), q.data_ptr(), None if sx is None else sx.data_ptr(), scale.data_ptr(),
        out.data_ptr(), R, K, N, _XTYPE[kind], rt, splits, _DTYPE_CODE[out_dtype],
        int(_XTYPE[kind] > 0 and pdl), torch.cuda.current_stream(x.device).cuda_stream)
    counter = {"w8a8": "quant_matmul_w8a8_wgmma", "int8_f32": "quant_matmul_int8",
               "int8": "quant_matmul_int8_wgmma"}[kind]
    build.check(rc, counter)
    build.launches[counter] += 1
    return out


def _launch_int4_sm90(x, q, scale, out_dtype, *, tiled=False, sx=None, pdl=False):
    """The int4 wgmma kernel: bf16 x, or the bf16 planes `[3, R, K]` of f32
    x, on packed `[K/2, N]` or panel-tiled q; or row-major q with int8 x8
    and its row scales `sx` (w4a8); `pdl` as in `_launch_int8_sm90`."""
    R, K = x.shape[-2:]
    N = scale.shape[-1]
    kind = "w4a8" if sx is not None else "int4_f32" if x.dim() == 3 else "int4"
    rt, splits = _sm90_tiling(R, K, N, kind, x.device.index)
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    rc = build.load().sequoia_qmm4_sm90(
        x.data_ptr(), q.data_ptr(), None if sx is None else sx.data_ptr(), scale.data_ptr(),
        out.data_ptr(), R, K, N, int(tiled), _XTYPE[kind], rt, splits, _DTYPE_CODE[out_dtype],
        int(_XTYPE[kind] > 0 and pdl), torch.cuda.current_stream(x.device).cuda_stream)
    name = "quant_matmul_tiled" if tiled else "quant_matmul_int4"
    counter = {"w4a8": "quant_matmul_w4a8", "int4_f32": name, "int4": name + "_wgmma"}[kind]
    build.check(rc, counter)
    build.launches[counter] += 1
    return out


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """The bf16 planes `[3, R, K]` of f32 x `[R, K]`: see
    `split_bf16x3_plain`. One kernel on the card (`csrc/split_bf16x3.cu`)."""
    if x.device.type == "cpu":
        return split_bf16x3_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("split_bf16x3", x)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"split_bf16x3: x {tuple(x.shape)} {x.dtype} must be a contiguous "
                         "2-D float32 tensor")
    R, K = x.shape
    planes = torch.empty((3, R, K), dtype=torch.bfloat16, device=x.device)
    rc = build.load().sequoia_split_bf16x3(x.data_ptr(), planes.data_ptr(), R, K,
                                           torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "split_bf16x3")
    build.launches["split_bf16x3"] += 1
    return planes


def quantize_activations(x: torch.Tensor, amax: torch.Tensor = None):
    """`(x8 [R, K] int8, sx [R, 1] f32)`: see `quantize_activations_plain`
    (`amax`: row maxima to scale by instead of x's own). One kernel on the
    card (`csrc/quant_matmul_a8.cu`)."""
    if x.device.type == "cpu":
        return quantize_activations_plain(x, amax)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("quantize_activations", x, amax)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"quantize_activations: x {tuple(x.shape)} {x.dtype} must be "
                         "a contiguous 2-D float32 or bfloat16 tensor")
    R, K = x.shape
    if amax is not None and (amax.dtype != torch.float32 or amax.numel() != R
                             or amax.device != x.device or not amax.is_contiguous()):
        raise ValueError(f"quantize_activations: amax {tuple(amax.shape)} {amax.dtype} must "
                         f"be {R} contiguous float32 values on {x.device}")
    x8 = torch.empty((R, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    rc = build.load().sequoia_quantize_activations(
        x.data_ptr(), x8.data_ptr(), sx.data_ptr(), None if amax is None else amax.data_ptr(),
        R, K, _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "quantize_activations")
    build.launches["quantize_activations"] += 1
    return x8, sx


def _quant_matmul_w4a8(x, q, scale, out_dtype, amax=None):
    """Quantize x per row, then the x8 instantiation of the int4 kernel."""
    _check(x, q, scale, 4, out_dtype)
    x8, sx = quantize_activations(x, amax)
    return _launch_int4_sm90(x8, q, scale, out_dtype, sx=sx, pdl=True)


def _quant_matmul_f32(x, q, scale, out_dtype, *, bits, tiled=False):
    """f32 x: split into three bf16 planes, then the planes instantiation
    of the int8 or int4 wgmma kernel, a programmatic dependent launch after
    the split."""
    planes = split_bf16x3(x)
    if bits == 8:
        return _launch_int8_sm90(planes, q, scale, out_dtype, pdl=True)
    return _launch_int4_sm90(planes, q, scale, out_dtype, tiled=tiled, pdl=True)


def quant_matmul(x, q, scale, *, bits: int, out_dtype=None, unpack: str = "auto",
                 amax=None):
    """`out [R, N]` = `x @ dequant(q) * scale` (see module doc). `unpack`
    (int4 only): "auto", "shift" and "float" are the one weight-only kernel;
    "w4a8" quantizes x per row (by the row maxima `amax` when given, see
    `quantize_activations`) and runs on the int8 tensor cores."""
    if unpack not in UNPACK:
        raise ValueError(f"quant_matmul: unpack must be one of {UNPACK}, got {unpack!r}")
    if unpack == "w4a8" and bits != 4:
        raise ValueError("quant_matmul: unpack='w4a8' is an int4 variant")
    if amax is not None and unpack != "w4a8":
        raise ValueError("quant_matmul: amax is for unpack='w4a8' only")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale, bits=bits, out_dtype=out_dtype,
                                  unpack=unpack, amax=amax)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("quant_matmul", x, scale, amax)
    out_dtype = out_dtype or x.dtype
    if unpack == "w4a8":
        return _quant_matmul_w4a8(x, q, scale, out_dtype, amax)
    _check(x, q, scale, bits, out_dtype)
    if x.dtype == torch.float32:
        return _quant_matmul_f32(x, q, scale, out_dtype, bits=bits)
    if bits == 8:
        return _launch_int8_sm90(x, q, scale, out_dtype)
    return _launch_int4_sm90(x, q, scale, out_dtype)


def quant_matmul_w8a8(x, q, scale, *, out_dtype=None, amax=None):
    """int8 weights x int8 activations: `float(x8 @ q) * sx * scale`, x
    quantized per row (`quantize_activations`, by the row maxima `amax`
    when given). Any row count, R = 1 too."""
    if x.device.type == "cpu":
        return quant_matmul_w8a8_plain(x, q, scale, out_dtype=out_dtype, amax=amax)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("quant_matmul_w8a8", x, scale, amax)
    out_dtype = out_dtype or x.dtype
    _check(x, q, scale, 8, out_dtype)
    x8, sx = quantize_activations(x, amax)
    return _launch_int8_sm90(x8, q, scale, out_dtype, sx=sx, pdl=True)


def quant_matmul_tiled(x, q, scale, *, out_dtype=None):
    """`x [R, K] @ dequant(q)` over the panel-tiled int4 layout
    `q [nt, K/2, bn0]`, `scale [1, N]` with N <= nt * bn0 (see module doc)."""
    if x.device.type == "cpu":
        return quant_matmul_tiled_plain(x, q, scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("quant_matmul_tiled", x, scale)
    out_dtype = out_dtype or x.dtype
    _check(x, q, scale, 4, out_dtype, tiled=True)
    if x.dtype == torch.float32:
        return _quant_matmul_f32(x, q, scale, out_dtype, bits=4, tiled=True)
    return _launch_int4_sm90(x, q, scale, out_dtype, tiled=True)
