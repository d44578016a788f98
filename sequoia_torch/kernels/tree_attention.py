"""Tree attention over main cache ∪ tree scratch: CUDA kernel and plain
version.

Port of `sequoia_tpu/kernels/tree_attention.py::tree_attention`. Queries
`[Q, H, D]` attend the main cache `[M, Hkv, D]` under a bool mask `[Q, M]`
and the tree scratch `[S, Hkv, D]` under a bool mask `[Q, S]` (S may be 0)
in ONE softmax; query head h reads KV head h // (H // Hkv). Scores and the
softmax run in f32; probabilities are cast to V's dtype for the value
product, accumulated in f32; the output has q's dtype. Masked scores are
the finite -1e30, so a fully masked region contributes zero, not NaN.

With `ks` / `vs` (f32 `[M, Hkv]`) the main cache is quantized, as the JAX
model reads it (`sequoia_tpu/core/model.py:263-338, 361-377`): int8 rows
`[M, Hkv, D]`, or packed int4 rows, head-paired `[M, Hkv/2, D]` or dsplit
`[M, Hkv, D/2]` (`kvcache/cache.py::KVCache4`), told apart by shape. The
integer rows are cast exactly to q's dtype; a main score is
`dot * scale * ks[m, h // g]` before the mask; main and scratch share the one
softmax; a main probability is multiplied by `vs[m, h // g]` and then cast
to q's dtype for the value product. The scratch is always float. A row
never written has scale 0 and is masked by every caller.

On a CUDA tensor `tree_attention` launches the kernel of
`csrc/tree_attention.cu` (or raises); on a CPU tensor it runs
`tree_attention_plain`. Both dtypes share one decomposition: each 16-query
tile reads its keys only up to the last one its mask rows attend, in runs
of 16-key tiles spread over `split_count(...)` blocks of `WARPS` warps
(f32: `F32_WARPS`), whose partials a second kernel merges. bf16 runs its
products on the bf16 tensor cores; f32 on the TF32 tensor cores as three
products of split operands (3xTF32: x = hi + lo, both TF32), which keeps
f32's accuracy. `tree_attention_split_plain` models the bf16 kernel and
`tree_attention_f32_model` the f32 one, arithmetic included (both on no
path; the tests hold them against the JAX kernel).

`tree_attention_batched` is the same attention over a slot axis (the
batched engine's; in JAX the Pallas call gains a grid axis under
`jax.vmap`): every operand gains a leading `[B]` axis, each slot its own
problem with its own prefix skip, in one launch. Its route is a fixed
shape rule (`sm90_route`):
- Q > SM90_MIN_Q (16) queries a slot (verify, wide grow levels, prefill
  chunks) whose work items fill the card, at least SM90_FILL (3/4) of one
  an SM: the Hopper kernel of `csrc/tree_attention_batched_sm90.cu`
  (counters `tree_attention_batched_sm90...`). A work item is (slot, KV
  head, SM90_ROWS = 64 query rows): the rows are the Q x g (query, query
  head) pairs of one KV head, query-major, so every row of the tile shares
  each staged K/V tile, which is read from device memory once and (int8 /
  int4) expanded once. One block walks a work item's keys. bf16 runs
  S = Q K^T and P V on `wgmma`; f32 keeps 3xTF32 on `mma.sync` over K/V
  split into TF32 hi and lo planes once in shared memory.
  `tree_attention_batched_sm90_model` models it, arithmetic included (on
  no path).
- Every other call (the AR step, the draft root, narrow grow levels, and
  calls of few slots or heads: B <= 2 at 32 heads, distill's 8-head
  training forward): the kernel above with a grid axis of slot x head
  (counters `tree_attention_batched...`). A 16-query tile of Q <= 16
  already reads each K/V tile once; with few work items its key splits
  fill the SMs that the Hopper kernel's one block an item would leave
  idle. On an H100 (scripts/probe_tree_attention_batched.py, 32 heads)
  the slot grid won most points at B = 1 and 2 (64 items; up to 3x at B =
  1), the Hopper kernel most at B = 4 (128 items) and every one at B = 8.
No route falls back to another: a build or launch failure raises.
`tree_attention_batched_plain` runs the plain version slot by slot.

Under autograd (grad mode on and a float operand that requires grad), both
entry points run through `TreeAttentionFunction`: its forward is the kernel
on the card and the plain version on the CPU, its backward is written out
in torch ops (`attention_grads`: the probabilities recomputed from q and the
keys, as a flash-attention backward does). JAX differentiates its einsum
attention with XLA and has no backward Pallas kernel; nor does the port. A
quantized main cache under autograd raises.
"""

from __future__ import annotations

import functools

import torch

from . import build
from ..kvcache.cache import unpack_kv_rows4

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Main-cache formats: the kernel's code and the wrapper's launch counter.
_FORMAT_CODE = {"float": 0, "int8": 1, "int4_head": 2, "int4_dsplit": 3}
# (The f32 route's counters add "_f32": `counter`.)
_COUNTER = {"float": "tree_attention", "int8": "tree_attention_kv8",
            "int4_head": "tree_attention_kv4_head",
            "int4_dsplit": "tree_attention_kv4_dsplit"}
# The kernels' decomposition: a block is one 16-query tile of one head with
# WARPS warps (F32_WARPS for f32); a warp walks a run of 16-key tiles (the
# f32 kernel in two steps of F32_STEP keys each).
WARPS = 4
F32_WARPS = 8
TILE_Q = 16
TILE_K = 16
F32_STEP = 8
BLOCKS_PER_SM = 2
# The slot-axis Hopper kernel: a work item is SM90_ROWS query rows of one
# KV head of one slot, one block, and walks staged K/V tiles of SM90_KEYS
# keys (bf16: one wgmma N; f32: two mma.sync n-tiles).
SM90_MIN_Q = 16
SM90_ROWS = 64
SM90_KEYS = {torch.bfloat16: 64, torch.float32: 16}
SM90_FILL = 0.75


def counter(fmt: str, dtype: torch.dtype, batched: bool = False, sm90: bool = False) -> str:
    """The launch counter of the kernel for a main cache in format `fmt`
    and queries of `dtype` (the slot-axis launch: `batched`; the Hopper
    kernel's: `sm90`, see `sm90_route`)."""
    name = _COUNTER[fmt]
    if batched:
        name = name.replace("tree_attention",
                            "tree_attention_batched" + ("_sm90" if sm90 else ""))
    return name + ("_f32" if dtype == torch.float32 else "")


def sm90_route(B: int, Q: int, H: int, Hkv: int, sms: int) -> bool:
    """Whether a slot-axis call of B slots, Q queries a slot and H query /
    Hkv KV heads takes the Hopper kernel on a card of `sms` SMs: Q >
    SM90_MIN_Q and its work items, B x Hkv x ceil(Q x g / SM90_ROWS), at
    least SM90_FILL x sms. Read from the shapes alone: no slot's prefix is
    read back to the host."""
    items = B * Hkv * -(-Q * (H // Hkv) // SM90_ROWS)
    return Q > SM90_MIN_Q and items >= SM90_FILL * sms


def split_count(Q: int, H: int, M: int, S: int, sms: int,
                dtype: torch.dtype = torch.bfloat16, batch: int = 1) -> int:
    """Blocks that share one (16-query tile, head) in the kernel, no more
    than leave each warp one 16-key tile of the whole main cache and
    scratch: bf16 (WARPS warps a block), enough for about BLOCKS_PER_SM
    blocks on each of `sms` SMs; f32 (F32_WARPS warps, one block fills an
    SM's shared memory), as many as one wave of one block per SM holds (a
    second wave or the merge costs more than shorter runs save). With
    `batch` slots every slot's (tile, head) pairs count."""
    pairs = batch * -(-Q // TILE_Q) * H
    tiles = -(-M // TILE_K) + -(-S // TILE_K)
    if dtype == torch.float32:
        return max(1, min(sms // pairs, -(-tiles // F32_WARPS)))
    return max(1, min(-(-BLOCKS_PER_SM * sms // pairs), -(-tiles // WARPS)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_extents(main_mask: torch.Tensor, scr_mask: torch.Tensor,
                 rows: int = TILE_Q) -> torch.Tensor:
    """`[ceil(Q / rows), 2]` int64: for each tile of `rows` query rows (the
    kernel's 16; the Hopper kernel's SM90_ROWS), the keys of the main
    region and of the scratch that the kernel reads, as it finds them
    in the mask: one past the last key any row of the tile attends, or the
    whole region when some row of the tile attends no key at all. Masks
    with a slot axis (`[B, Q, M]`, `[B, Q, S]`) give `[B, ceil(Q / rows), 2]`:
    each slot its own prefix skip."""
    if main_mask.dim() == 3:
        return torch.stack([tile_extents(m, s, rows) for m, s in zip(main_mask, scr_mask)])
    Q, M = main_mask.shape
    S = scr_mask.shape[1]
    pad = -Q % rows

    def last(mask, n):            # per tile: 1 + the last live key, 0 if none
        if n == 0:
            per_row = mask.new_zeros(Q, dtype=torch.int64)
        else:
            idx = torch.arange(1, n + 1, device=mask.device)
            per_row = (mask.long() * idx).amax(dim=1)
        return torch.nn.functional.pad(per_row, (0, pad)).view(-1, rows).amax(dim=1)

    alive = main_mask.any(dim=1) | scr_mask.any(dim=1)
    dead = ~torch.nn.functional.pad(alive, (0, pad), value=True).view(-1, rows).all(dim=1)
    ext = torch.stack([last(main_mask, M), last(scr_mask, S)], dim=1)
    whole = torch.tensor([M, S], device=ext.device)
    return torch.where(dead[:, None], whole, ext)


def cache_format(k: torch.Tensor, Hkv: int, D: int) -> str:
    """`float`, `int8`, `int4_head` or `int4_dsplit`, from the dtype and
    shape of one layer's main-cache rows `k`."""
    if k.dtype != torch.int8:
        return "float"
    if k.shape[1:] == (Hkv, D):
        return "int8"
    if Hkv % 2 == 0 and k.shape[1:] == (Hkv // 2, D):
        return "int4_head"
    if D % 2 == 0 and k.shape[1:] == (Hkv, D // 2):
        return "int4_dsplit"
    raise ValueError(f"tree_attention: int8 cache rows {tuple(k.shape)} fit no "
                     f"format for Hkv={Hkv} D={D}")


def tree_attention_plain(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                         ks=None, vs=None):
    """Einsum/softmax over `cat(main, scratch)`, step by step, in f32 (in
    f64 for f64 q: a reference for the f32 kernels' error)."""
    Q, H, D = q.shape
    Hkv = sk.shape[1]
    g = H // Hkv
    M = k.shape[0]
    ft = _compute_dtype(q)
    qg = q.reshape(Q, Hkv, g, D).to(ft)
    k, v, fmt = _float_rows(q, k, v, Hkv, D)
    scores = torch.einsum("qhgd,mhd->hgqm", qg, k) * scale
    if fmt != "float":
        scores = scores * ks.T[:, None, None, :]
    scores = scores.masked_fill(~main_mask[None, None], NEG)
    scores_scr = torch.einsum("qhgd,shd->hgqs", qg, sk.to(ft)) * scale
    scores_scr = scores_scr.masked_fill(~scr_mask[None, None], NEG)
    full = torch.softmax(torch.cat([scores, scores_scr], dim=-1), dim=-1)
    probs, probs_scr = full[..., :M], full[..., M:]
    if fmt != "float":
        probs = probs * vs.T[:, None, None, :]
    out = (torch.einsum("hgqm,mhd->qhgd", probs.to(q.dtype).to(ft), v)
           + torch.einsum("hgqs,shd->qhgd", probs_scr.to(q.dtype).to(ft), sv.to(ft)))
    return out.reshape(Q, H, D).to(q.dtype)


def _compute_dtype(q):
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _float_rows(q, k, v, Hkv, D):
    """The main rows in the compute dtype (integers cast exactly to q's
    dtype), and the format's name."""
    fmt = cache_format(k, Hkv, D)
    if fmt.startswith("int4"):
        k, v = (unpack_kv_rows4(t, packing=fmt[5:]) for t in (k, v))
    if fmt != "float":
        k, v = k.to(q.dtype), v.to(q.dtype)
    ft = _compute_dtype(q)
    return k.to(ft), v.to(ft), fmt


def _merge(parts):
    """One (m, l, acc) from partials over disjoint keys."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    w = [torch.exp(p[0] - m) for p in parts]
    lsum = sum(wi * p[1] for wi, p in zip(w, parts))
    acc = sum(wi[..., None] * p[2] for wi, p in zip(w, parts))
    return m, lsum, acc


def _softmax_step(state, qt, kr, vr, live, kscale, vscale, scale, dot, pv):
    """One online-softmax step of the kernels over keys `kr`, `vr`
    `[n, h, D]`: scores `dot(qt, kr)` (times `kscale`: a quantized main
    tile), the masked ones (`live` False) at -1e30, the running (m, l, acc)
    rescaled, the probabilities (times `vscale`) folded in by `pv`."""
    m, lsum, acc = state
    s = dot(qt, kr) * scale
    if kscale is not None:
        s = s * kscale
    s = s.masked_fill(~live, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    lsum = lsum * alpha + p.sum(dim=-1)
    if vscale is not None:
        p = p * vscale
    return m_new, lsum, pv(acc, alpha, p, vr)


def _decomposed(q, k, v, main_mask, sk, sv, scr_mask, scale, ks, vs, splits, warps, step,
                dot, pv):
    """The kernels' decomposition in plain PyTorch: for each 16-query tile,
    its `tile_extents`; the extent's 16-key tiles (main, then scratch) cut
    into `splits * warps` contiguous runs; per run the online softmax in
    steps of `step` keys (none past the region's end) into (m, l, acc); the
    runs of a block merged, then the blocks. `dot(qt [H, r, D], kr [n, H, D])`
    gives the scores `[H, r, n]` in f32; `pv(acc, alpha, p, vr)` folds the
    probabilities `p` (main, quantized: times `vs`) into acc. Masked scores
    are -1e30."""
    Q, H, D = q.shape
    Hkv = sk.shape[1]
    kvh = torch.arange(H) // (H // Hkv)
    kf, vf, fmt = _float_rows(q, k, v, Hkv, D)
    scales = (ks, vs) if fmt != "float" else (None, None)
    regions = [(kf, vf, main_mask, *scales), (sk.float(), sv.float(), scr_mask, None, None)]
    ext = tile_extents(main_mask, scr_mask).tolist()
    slots = splits * warps
    out = torch.empty_like(q)
    for ti, q0 in enumerate(range(0, Q, TILE_Q)):
        rows = slice(q0, min(q0 + TILE_Q, Q))
        qt = q[rows].float().permute(1, 0, 2)                  # [H, r, D]
        r = qt.shape[1]
        ntm = -(-ext[ti][0] // TILE_K)
        nt = ntm + -(-ext[ti][1] // TILE_K)
        blocks = []
        for z in range(splits):
            runs = []
            for j in range(z * warps, (z + 1) * warps):
                m = torch.full((H, r), NEG)
                lsum, acc = torch.zeros(H, r), torch.zeros(H, r, D)
                for t in range(nt * j // slots, nt * (j + 1) // slots):
                    kr, vr, mask, kscale, vscale = regions[t >= ntm]
                    tile = (t if t < ntm else t - ntm) * TILE_K
                    for base in range(tile, min(tile + TILE_K, kr.shape[0]), step):
                        keys = slice(base, base + step)      # past the end: no key
                        m, lsum, acc = _softmax_step(
                            (m, lsum, acc), qt, kr[keys][:, kvh], vr[keys][:, kvh],
                            mask[rows, keys][None],
                            None if kscale is None else kscale[keys][:, kvh].T[:, None, :],
                            None if vscale is None else vscale[keys][:, kvh].T[:, None, :],
                            scale, dot, pv)
                runs.append((m, lsum, acc))
            blocks.append(_merge(runs))
        _, lsum, acc = _merge(blocks)
        out[rows] = (acc / lsum.clamp_min(1e-30)[..., None]).permute(1, 0, 2).to(q.dtype)
    return out


def tree_attention_split_plain(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                               ks=None, vs=None, splits: int = 1):
    """The bf16 kernel's decomposition (`_decomposed`, 16-key steps) in
    plain PyTorch, on no path: scores in f32, probabilities rounded to q's
    dtype for the value product."""
    return _decomposed(q, k, v, main_mask, sk, sv, scr_mask, scale, ks, vs, splits, WARPS,
                       TILE_K, _bf16_scores, _rounded_pv(q.dtype))


def split_tf32(x: torch.Tensor):
    """f32 x -> (hi, lo), f32 tensors of TF32 values (the low 13 bits zero):
    hi = x rounded to TF32 (to nearest, ties away from zero), lo = x - hi
    (exact in f32) rounded the same way, so |x - hi - lo| <= 2^-22 |x|. The
    f32 kernel's `split_tf32`, bit for bit (finite x)."""
    def rna(t):
        u = t.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _mma_rz(c, a, b):
    """c + a @ b as one tensor-core step that sums in f32 by truncation: the
    products (TF32 x TF32, exact in f64) summed in f64, then rounded toward
    zero to f32."""
    x = c.double() + a.double() @ b.double()
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tree_attention_f32_model(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                             ks=None, vs=None, splits: int = 1):
    """The f32 kernel (3xTF32 on mma.sync m16n8k8) in plain PyTorch, on no
    path: `_decomposed` over F32_WARPS warps a block, in 8-key steps; every
    f32 operand split by `split_tf32`; a product a.b is a_hi.b_hi +
    a_hi.b_lo + a_lo.b_hi, each a truncating tensor-core step (`_mma_rz`)
    over 8 of its sum's terms.
    S sums q.k into six accumulators (the three products, even and odd
    8-dim steps) added in f32 as the kernel adds them; P V of each step goes
    into a zeroed accumulator that one FMA folds into acc."""
    return _decomposed(q, k, v, main_mask, sk, sv, scr_mask, scale, ks, vs, splits, F32_WARPS,
                       F32_STEP, _tf32x3_scores, _tf32x3_pv)


def _tf32x3_scores(qt, kr):
    """[H, r, D] x [n, H, D] -> [H, r, n] as the f32 kernels sum q.k: six
    truncating accumulators (q_hi.k_hi, q_hi.k_lo, q_lo.k_hi; even and odd
    8-dim steps), added in f32 at the end."""
    zero = torch.zeros(())
    qh, ql = split_tf32(qt)
    kh, kl = split_tf32(kr.permute(1, 2, 0).contiguous())
    acc = {(p, z): zero for p in ("hh", "hl", "lh") for z in (0, 1)}
    for kk in range(qt.shape[-1] // 8):
        d, z = slice(8 * kk, 8 * kk + 8), kk % 2
        acc["hh", z] = _mma_rz(acc["hh", z], qh[..., d], kh[:, d])
        acc["hl", z] = _mma_rz(acc["hl", z], qh[..., d], kl[:, d])
        acc["lh", z] = _mma_rz(acc["lh", z], ql[..., d], kh[:, d])
    return (acc["hh", 0] + acc["hh", 1]) + (
        (acc["hl", 0] + acc["hl", 1]) + (acc["lh", 0] + acc["lh", 1]))


def _tf32x3_pv(acc, alpha, p, vr):
    """acc * alpha + P V ([H, r, n] x [n, H, D] -> [H, r, D]) as the f32
    kernels fold a step in: one zeroed accumulator takes p_hi.v_hi,
    p_hi.v_lo, p_lo.v_hi of each 8-key k step in turn (truncating), then
    one FMA folds it into acc."""
    ph, pl = split_tf32(p)
    vh, vl = split_tf32(vr.permute(1, 0, 2).contiguous())
    x = torch.zeros(())
    for c in range(0, p.shape[-1], 8):
        k = slice(c, c + 8)
        x = _mma_rz(x, ph[..., k], vh[:, k])
        x = _mma_rz(x, ph[..., k], vl[:, k])
        x = _mma_rz(x, pl[..., k], vh[:, k])
    return (acc.double() * alpha.double()[..., None] + x.double()).float()


def _bf16_scores(qt, kr):
    return torch.einsum("hrd,nhd->hrn", qt, kr)


def _rounded_pv(dtype):
    """The bf16 kernels' fold of a step: probabilities rounded to `dtype`,
    the value product and acc * alpha in f32."""
    def pv(acc, alpha, p, vr):
        return acc * alpha[..., None] + torch.einsum("hrn,nhd->hrd", p.to(dtype).float(), vr)
    return pv


def tree_attention_batched_sm90_model(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                                      ks=None, vs=None):
    """The Hopper slot-axis kernel's decomposition in plain PyTorch, on no
    path (operands as `tree_attention_batched`). For each slot and KV head,
    the Q x g rows (query, query head; query-major) in work items of
    SM90_ROWS rows; each item's `tile_extents` over its rows; the extent's
    tiles of SM90_KEYS[dtype] keys (main, then scratch) in order, one
    online-softmax step a tile into (m, l, acc). bf16: scores in f32,
    probabilities rounded to q's dtype for the value product; f32: the
    3xTF32 arithmetic of `tree_attention_f32_model` (`_tf32x3_scores`,
    `_tf32x3_pv`), a tile one 16-key step with a float cache; with an int8 /
    int4 cache each tile's two 8-key halves walked as two runs of their own
    (the kernel's two consumer warpgroups), merged at the end."""
    B, Q, H, D = q.shape
    Hkv, M, S = sk.shape[2], k.shape[1], sk.shape[1]
    g, rows = H // Hkv, Q * (H // Hkv)
    f32 = q.dtype == torch.float32
    kt = SM90_KEYS[torch.float32 if f32 else torch.bfloat16]
    dot, pv = (_tf32x3_scores, _tf32x3_pv) if f32 else (_bf16_scores, _rounded_pv(q.dtype))
    quant = cache_format(k[0], Hkv, D) != "float"
    # (first key, keys) of a step of each run over the tiles
    halves_of = ((0, 8), (8, 8)) if f32 and quant else ((0, kt),)
    out = torch.empty(B, Hkv, rows, D, dtype=q.dtype)
    for b in range(B):
        kf, vf, _ = _float_rows(q[b], k[b], v[b], Hkv, D)
        regions = [(kf, vf, ks[b] if quant else None, vs[b] if quant else None),
                   (sk[b].float(), sv[b].float(), None, None)]
        live = [main_mask[b].repeat_interleave(g, 0), scr_mask[b].repeat_interleave(g, 0)]
        ext = tile_extents(*live, rows=SM90_ROWS).tolist()
        for kh in range(Hkv):
            qk = q[b, :, kh * g:(kh + 1) * g].reshape(rows, D).float()
            for it, r0 in enumerate(range(0, rows, SM90_ROWS)):
                rr = slice(r0, min(r0 + SM90_ROWS, rows))
                qt, r = qk[rr][None], qk[rr].shape[0]
                ntm = -(-ext[it][0] // kt)
                nt = ntm + -(-ext[it][1] // kt)
                halves = []
                for h0, step in halves_of:
                    state = (torch.full((1, r), NEG), torch.zeros(1, r), torch.zeros(1, r, D))
                    for t in range(nt):
                        kr, vr, ksc, vsc = regions[t >= ntm]
                        base = (t if t < ntm else t - ntm) * kt + h0
                        if base >= kr.shape[0]:
                            continue                          # (a no-op step)
                        keys = slice(base, base + step)       # past the end: no key
                        sc = lambda x: None if x is None else x[keys, kh][None, None, :]  # noqa: E731,E501
                        state = _softmax_step(state, qt, kr[keys, kh:kh + 1],
                                              vr[keys, kh:kh + 1],
                                              live[t >= ntm][rr, keys][None], sc(ksc),
                                              sc(vsc), scale, dot, pv)
                    halves.append(state)
                _, lsum, acc = _merge(halves)
                out[b, kh, rr] = (acc / lsum.clamp_min(1e-30)[..., None])[0].to(q.dtype)
    # [B, Hkv, Q * g, D] (rows query-major) -> [B, Q, H, D]
    return out.view(B, Hkv, Q, g, D).permute(0, 2, 1, 3, 4).reshape(B, Q, H, D)


def _check(q, k, v, main_mask, sk, sv, scr_mask, ks, vs) -> str:
    Q, H, D = q.shape
    M = k.shape[0]
    S, Hkv = sk.shape[0], sk.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"tree_attention: unsupported dtype {q.dtype}")
    if D not in HEAD_DIMS or H % Hkv:
        raise ValueError(f"tree_attention: q {tuple(q.shape)} vs scratch "
                         f"{tuple(sk.shape)} (head dim must be one of {HEAD_DIMS})")
    fmt = cache_format(k, Hkv, D)
    floats = [("sk", sk), ("sv", sv)]
    tensors = [("q", q), ("k", k), ("v", v), ("main_mask", main_mask),
               ("sk", sk), ("sv", sv), ("scr_mask", scr_mask)]
    if fmt == "float":
        if ks is not None or vs is not None:
            raise ValueError("tree_attention: scales given with a float cache")
        if k.shape != (M, Hkv, D):
            raise ValueError("tree_attention: k/v/sk/sv shapes disagree")
        floats += [("k", k), ("v", v)]
    else:
        if ks is None or vs is None:
            raise ValueError("tree_attention: an integer cache needs ks and vs")
        for name, t in (("ks", ks), ("vs", vs)):
            if t.dtype != torch.float32 or t.shape != (M, Hkv):
                raise ValueError(f"tree_attention: {name} must be float32 "
                                 f"[{M}, {Hkv}], got {t.dtype} {tuple(t.shape)}")
        tensors += [("ks", ks), ("vs", vs)]
    for name, t in floats:
        if t.dtype != q.dtype:
            raise TypeError(f"tree_attention: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("main_mask", main_mask), ("scr_mask", scr_mask)):
        if t.dtype != torch.bool:
            raise TypeError(f"tree_attention: {name} must be bool, got {t.dtype}")
    if v.shape != k.shape or v.dtype != k.dtype or sk.shape != (S, Hkv, D) \
            or sv.shape != sk.shape:
        raise ValueError("tree_attention: k/v/sk/sv shapes disagree")
    if main_mask.shape != (Q, M) or scr_mask.shape != (Q, S):
        raise ValueError(f"tree_attention: masks {tuple(main_mask.shape)}, "
                         f"{tuple(scr_mask.shape)} for Q={Q} M={M} S={S}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"tree_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"tree_attention: {name} must be contiguous")
    # The kernel loads 16 bytes at a time (8 where a dsplit row has only 8).
    for name, t in (("q", q), ("k", k), ("v", v), ("sk", sk), ("sv", sv)):
        row_bytes = t.shape[-1] * t.element_size()
        if t.numel() and t.data_ptr() % min(16, row_bytes):
            raise ValueError(f"tree_attention: {name} is not 16-byte aligned")
    return fmt


def attention_grads(q, k, v, main_mask, sk, sv, scr_mask, out, dout, *, scale: float):
    """(dq, dk, dv, dsk, dsv) of the float-cache attention over B slots
    (every operand with the slot axis, as `tree_attention_batched`), given
    its output `out` and the output's gradient `dout`. In the compute dtype
    (f32, f64 for f64 q), cast back to each input's dtype:
    S = q k^T scale over main ∪ scratch with the masked entries at -1e30,
    P = softmax(S), dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO O)),
    zero where masked, dq = dS k scale, dk = dS^T q scale; the g = H / Hkv
    query heads of a KV head sum into it. The probabilities are not rounded
    to q's dtype as the forward's value product rounds them. The products
    follow torch's matmul settings: f32 with TF32 off, torch's default, as
    JAX's CPU reference computes them."""
    B, Q, H, D = q.shape
    M, Hkv = k.shape[1], sk.shape[2]
    g = H // Hkv
    ft = _compute_dtype(q)
    keys = torch.cat([k, sk], dim=1).to(ft)                  # [B, M + S, Hkv, D]
    vals = torch.cat([v, sv], dim=1).to(ft)
    masked = ~torch.cat([main_mask, scr_mask], dim=-1)[:, None, None]   # [B, 1, 1, Q, M + S]
    qg = q.reshape(B, Q, Hkv, g, D).to(ft)
    do = dout.reshape(B, Q, Hkv, g, D).to(ft)
    o = out.reshape(B, Q, Hkv, g, D).to(ft)
    s = torch.einsum("bqhgd,bnhd->bhgqn", qg, keys) * scale
    p = torch.softmax(s.masked_fill(masked, NEG), dim=-1)
    dv = torch.einsum("bhgqn,bqhgd->bnhd", p, do)
    dp = torch.einsum("bqhgd,bnhd->bhgqn", do, vals)
    delta = (do * o).sum(dim=-1).permute(0, 2, 3, 1)[..., None]   # [B, Hkv, g, Q, 1]
    ds = (p * (dp - delta)).masked_fill(masked, 0.0)
    dq = torch.einsum("bhgqn,bnhd->bqhgd", ds, keys) * scale
    dk = torch.einsum("bhgqn,bqhgd->bnhd", ds, qg) * scale
    return (dq.reshape(B, Q, H, D).to(q.dtype), dk[:, :M].to(k.dtype), dv[:, :M].to(v.dtype),
            dk[:, M:].to(sk.dtype), dv[:, M:].to(sv.dtype))


class TreeAttentionFunction(torch.autograd.Function):
    """Float-cache tree attention under autograd, single (`batched`
    False: `[Q, H, D]` operands) or over a slot axis. Forward: the kernel
    on a CUDA tensor (its launch counted as any other), the plain version
    on a CPU tensor; backward: `attention_grads`. No gradient reaches the
    masks."""

    @staticmethod
    def forward(ctx, q, k, v, main_mask, sk, sv, scr_mask, scale, batched):
        if batched:
            out = _tree_attention_batched(q, k, v, main_mask, sk, sv, scr_mask, scale=scale)
        else:
            out = _tree_attention(q, k, v, main_mask, sk, sv, scr_mask, scale=scale)
        ctx.save_for_backward(q, k, v, main_mask, sk, sv, scr_mask, out)
        ctx.scale, ctx.batched = scale, batched
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        if not ctx.batched:
            saved = [t[None] for t in saved]
            dout = dout[None]
        q, k, v, main_mask, sk, sv, scr_mask, out = saved
        grads = attention_grads(q, k, v, main_mask, sk, sv, scr_mask, out, dout.contiguous(),
                                scale=ctx.scale)
        if not ctx.batched:
            grads = [t[0] for t in grads]
        dq, dk, dv, dsk, dsv = grads
        return dq, dk, dv, None, dsk, dsv, None, None, None


def _differentiable(name, q, k, v, sk, sv, ks, vs) -> bool:
    """Whether a call goes through `TreeAttentionFunction`; a quantized
    main cache under autograd raises."""
    if not torch.is_grad_enabled() or not any(t.requires_grad for t in (q, k, v, sk, sv)):
        return False
    if ks is not None or vs is not None:
        raise RuntimeError(f"{name}: no gradient through an int8 / int4 KV cache; use a "
                           "float cache to train, or call under torch.no_grad()")
    return True


def tree_attention(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                   ks=None, vs=None):
    """attn `[Q, H, D]` = softmax over main ∪ scratch (see module doc)."""
    if _differentiable("tree_attention", q, k, v, sk, sv, ks, vs):
        return TreeAttentionFunction.apply(q, k, v, main_mask, sk, sv, scr_mask, scale, False)
    return _tree_attention(q, k, v, main_mask, sk, sv, scr_mask, scale=scale, ks=ks, vs=vs)


def _tree_attention(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float, ks=None, vs=None):
    if q.device.type == "cpu":
        return tree_attention_plain(q, k, v, main_mask, sk, sv, scr_mask,
                                    scale=scale, ks=ks, vs=vs)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fmt = _check(q, k, v, main_mask, sk, sv, scr_mask, ks, vs)
    Q, H, D = q.shape
    M = k.shape[0]
    S, Hkv = sk.shape[0], sk.shape[1]
    return _launch(q, k, v, main_mask, sk, sv, scr_mask, ks, vs, fmt, scale,
                   1, Q, H, Hkv, D, M, S, counter(fmt, q.dtype))


def _launch(q, k, v, main_mask, sk, sv, scr_mask, ks, vs, fmt, scale, B, Q, H, Hkv, D, M, S,
            name):
    """One launch over B slots (B = 1: the single call), counted as `name`."""
    out = torch.empty_like(q)
    splits = split_count(Q, H, M, S, _sm_count(q.device.index or 0), q.dtype, batch=B)
    part = None
    if splits > 1:   # the blocks' partials: acc, then (m, l)
        part = torch.empty(splits * B * Q * H * (D + 2), dtype=torch.float32, device=q.device)
    lib = build.load()
    rc = lib.sequoia_tree_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        main_mask.data_ptr(), sk.data_ptr(), sv.data_ptr(), scr_mask.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), B, Q, H, Hkv, D, M, S,
        splits, float(scale), _DTYPE_CODE[q.dtype], _FORMAT_CODE[fmt],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, name)
    build.launches[name] += 1
    return out


def tree_attention_batched_plain(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                                 ks=None, vs=None):
    """`tree_attention_plain` of each slot: q `[B, Q, H, D]`, main rows
    `[B, M, ...]` (scales `[B, M, Hkv]`), masks `[B, Q, M]` and `[B, Q, S]`,
    scratch `[B, S, Hkv, D]` -> `[B, Q, H, D]`. Slot by slot, so each slot's
    numbers are the single call's."""
    return torch.stack([
        tree_attention_plain(q[b], k[b], v[b], main_mask[b], sk[b], sv[b], scr_mask[b],
                             scale=scale, ks=None if ks is None else ks[b],
                             vs=None if vs is None else vs[b])
        for b in range(q.shape[0])])


def tree_attention_batched(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                           ks=None, vs=None):
    """attn `[B, Q, H, D]` of B independent slots (see module doc) in one
    launch of the kernel on the card; `tree_attention_batched_plain` on the
    CPU."""
    if _differentiable("tree_attention_batched", q, k, v, sk, sv, ks, vs):
        return TreeAttentionFunction.apply(q, k, v, main_mask, sk, sv, scr_mask, scale, True)
    return _tree_attention_batched(q, k, v, main_mask, sk, sv, scr_mask, scale=scale,
                                   ks=ks, vs=vs)


def _tree_attention_batched(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                            ks=None, vs=None):
    if q.device.type == "cpu":
        return tree_attention_batched_plain(q, k, v, main_mask, sk, sv, scr_mask,
                                            scale=scale, ks=ks, vs=vs)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B = q.shape[0]
    tensors = [q, k, v, main_mask, sk, sv, scr_mask] + [t for t in (ks, vs) if t is not None]
    if q.dim() != 4 or any(t.shape[0] != B for t in tensors):
        raise ValueError("tree_attention_batched: every operand needs the slot axis "
                         f"[B={B}, ...]")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("tree_attention_batched: operands must be contiguous")
    # Slot 0's views carry every per-slot check (shapes, dtypes, alignment).
    fmt = _check(q[0], k[0], v[0], main_mask[0], sk[0], sv[0], scr_mask[0],
                 None if ks is None else ks[0], None if vs is None else vs[0])
    _, Q, H, D = q.shape
    M = k.shape[1]
    S, Hkv = sk.shape[1], sk.shape[2]
    if sm90_route(B, Q, H, Hkv, _sm_count(q.device.index or 0)):
        return _launch_sm90(q, k, v, main_mask, sk, sv, scr_mask, ks, vs, fmt, scale,
                            B, Q, H, Hkv, D, M, S, counter(fmt, q.dtype, True, sm90=True))
    return _launch(q, k, v, main_mask, sk, sv, scr_mask, ks, vs, fmt, scale,
                   B, Q, H, Hkv, D, M, S, counter(fmt, q.dtype, batched=True))


def _launch_sm90(q, k, v, main_mask, sk, sv, scr_mask, ks, vs, fmt, scale, B, Q, H, Hkv, D,
                 M, S, name):
    """One launch of the Hopper slot-axis kernel, counted as `name`."""
    out = torch.empty_like(q)
    lib = build.load()
    rc = lib.sequoia_tree_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        main_mask.data_ptr(), sk.data_ptr(), sv.data_ptr(), scr_mask.data_ptr(),
        out.data_ptr(), B, Q, H, Hkv, D, M, S, float(scale), _DTYPE_CODE[q.dtype],
        _FORMAT_CODE[fmt], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, name)
    build.launches[name] += 1
    return out
