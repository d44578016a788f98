"""The packed-int4 wgmma kernel's design (csrc/quant_matmul_int4_sm90.cu), on
the CPU.

- `quant_matmul_int4_sm90_model`, the CPU model of the kernel's
  decomposition (K stages dealt to cluster ranks, each stage's k steps as a
  low-nibble and a high-nibble product, the ranks added in rank order),
  against JAX's int4 and panel-tiled Pallas kernels (interpret mode).
- A numpy model of the nibble -> bf16 conversion (`nibbles_bf16`: the
  nibble in the mantissa of bf16 128.0, one fma.rn.bf16x2 of 1.0 and
  -136.0), exact for every byte value and both nibbles.
- An index model of the register-A fragments (ldmatrix.x4.trans over the
  swizzled q tile, then the shifts by 4, 8 and 12 bits): every (k, column)
  of both halves of a stage lands exactly once, at the PTX position, and
  the loads are free of bank conflicts.
- The tensor-map boxes of a call (x's low and high boxes, the row-major and
  the panel map of q) and the epilogue's stores: each weight byte is read
  once, each x column meets its own weight row, nothing past N is written.
- The cluster-size chooser at the int4 stage count.

The kernel itself is held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.kernels.quant_matmul import (  # noqa: E402
    quant_matmul as jax_quant_matmul,
    quant_matmul_tiled as jax_quant_matmul_tiled,
)
from sequoia_tpu.quant import qtensor as jq  # noqa: E402
from sequoia_torch.kernels import quant_matmul as tqmm  # noqa: E402
from sequoia_torch.quant import qtensor as tq  # noqa: E402

KP = 64      # packed q rows per stage (csrc/quant_matmul_int4_sm90.cu kKp)
BM = 128     # output columns per block


# (a) the decomposition model against JAX ------------------------------------------

def _inputs(R, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, K)).astype(np.float32)
    q = rng.integers(-128, 128, size=(K // 2, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.02 + 0.001).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("K,N", [(640, 256), (96, 200)])   # 5 stages; ragged K and N
@pytest.mark.parametrize("R", [1, 8, 17, 64, 300])
def test_int4_sm90_model_matches_jax_kernel(R, K, N, tiled):
    """f32 x: the model at 1-4 cluster ranks against `quant_matmul(bits=4,
    interpret=True)` or `quant_matmul_tiled(interpret=True)`, within 1e-5
    of the largest |output| (f32 sums in other orders). K = 640 is five
    64-row stages (four ranks: 2 + 2 + 1 + 0); K = 96 one partial stage."""
    x, q, scale = _inputs(R, K, N, seed=R + K + N)
    if tiled:
        jt = jq.tile_int4(jq.QuantizedTensor(jnp.asarray(q), jnp.asarray(scale)))
        want = np.asarray(jax_quant_matmul_tiled(jnp.asarray(x), jt.q, jt.scale,
                                                 interpret=True))
        qq = tq.tile_int4(tq.QuantizedTensor(torch.from_numpy(q), torch.from_numpy(scale))).q
        assert qq.shape == (math.ceil(N / BM), K // 2, BM)
    else:
        want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                           bits=4, interpret=True))
        qq = torch.from_numpy(q)
    for splits in (1, 2, 3, 4):
        got = tqmm.quant_matmul_int4_sm90_model(torch.from_numpy(x), qq,
                                                torch.from_numpy(scale), splits=splits)
        assert got.dtype == torch.float32 and got.shape == (R, N)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# (b) the nibble -> bf16 conversion ---------------------------------------------------

def _bf16_value(bits):
    """The float value of bf16 bit patterns (uint16 array)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _nibbles_bf16(w):
    """csrc/quant_matmul_int4_sm90.cu::nibbles_bf16 on uint32 words: the
    lop3 `(w & 0x000F000F) ^ 0x43084308`, then fma.rn.bf16x2(b, 1.0, -136.0)
    per half. Returns the two halves' values (low, high) and checks that
    each fma result is exact in bf16 (so round-to-nearest leaves it)."""
    b = (w & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    halves = []
    for shift in (0, 16):
        v = _bf16_value(((b >> np.uint32(shift)) & np.uint32(0xFFFF)).astype(np.uint16))
        r = v.astype(np.float64) * 1.0 - 136.0        # the exact fma result
        exact = torch.from_numpy(r.astype(np.float32)).to(torch.bfloat16).double().numpy()
        np.testing.assert_array_equal(exact, r)
        halves.append(r)
    return halves


def _signed(nibble):
    return ((nibble.astype(np.int64) ^ 8) - 8)


def test_nibble_conversion_is_exact_for_every_byte():
    """Every pair of bytes (b0 at k, b1 at k + 1 of one column, bytes 0 and
    2 of P) through P, P >> 4 (high nibbles), and the column c + 1 bytes at
    1 and 3 through P >> 8, P >> 12: each half equals the sign-extended
    nibble, exactly, for all 256 x 256 byte values."""
    b0, b1 = np.meshgrid(np.arange(256, dtype=np.uint32), np.arange(256, dtype=np.uint32))
    b0, b1 = b0.ravel(), b1.ravel()
    lo_want = (_signed(b0 & 15), _signed(b1 & 15))
    hi_want = (_signed(b0 >> 4), _signed(b1 >> 4))
    # column c: bytes 0 and 2 of P; column c + 1: bytes 1 and 3 (other bytes noise)
    noise = np.uint32(0xA5)
    p_c = b0 | (noise << 8) | (b1 << 16) | (noise << 24)
    p_c1 = noise | (b0 << 8) | (noise << 16) | (b1 << 24)
    for P, shift_lo, shift_hi in ((p_c, 0, 4), (p_c1, 8, 12)):
        for got, want in ((_nibbles_bf16(P >> np.uint32(shift_lo)), lo_want),
                          (_nibbles_bf16(P >> np.uint32(shift_hi)), hi_want)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


# (c) the fragment index model ----------------------------------------------------------

def _swz(row, byte):
    """csrc/qmm_sm90.cuh::swz, the 128-byte TMA swizzle."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _column(wg, w, m):
    """The weight column of M-row m (0..15) of warp w in warpgroup wg."""
    return 64 * wg + 16 * w + 2 * (m % 8) + m // 8


def _ldmatrix_x4_trans(smem, lane_addr):
    """`ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16` on byte labels:
    lanes 8m .. 8m + 7 give the 16-byte rows of matrix m; lane (g, t)
    receives, in register m, the b16 elements M[2t][g] (low half) and
    M[2t + 1][g] of matrix m, each a pair of byte labels."""
    regs = {}
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out = []
        for m in range(4):
            rows = [lane_addr[8 * m + i] for i in range(8)]
            out.append([smem[rows[2 * t] + 2 * g], smem[rows[2 * t] + 2 * g + 1],
                        smem[rows[2 * t + 1] + 2 * g], smem[rows[2 * t + 1] + 2 * g + 1]])
        regs[lane] = out
    return regs


def _nibbles(word_bytes):
    """A word's 8 nibble labels, bits 0-3 first: byte label (row, column)
    has the low nibble (0, row, column) and the high one (1, row, column)."""
    out = []
    for b in word_bytes:
        out += [(0,) + b, (1,) + b]
    return out


def _warp_fragments(smem, wg, w, j0):
    """The kernel's `ldm_off` and one ldmatrix.x4.trans at packed row 16 j0
    for warp w of warpgroup wg, then `XBf16::fragments` of its two k steps
    (j0, j0 + 1). Returns {lane: [(lo, hi) of step j0, of step j0 + 1]}, a
    register a pair of labels (bits 0-3, bits 16-19), and the lane
    addresses (8 per matrix)."""
    addrs = []
    for lane in range(32):
        g = lane // 4
        col = 64 * wg + 16 * w + 2 * g
        ldm_off = _swz(lane % 8, col - 2 * g) + (lane // 8) * 8 * 128
        a = ldm_off + 16 * j0 * 128
        # the row that matrix lane // 8 wants from this lane, at the swizzle
        assert a == _swz(16 * j0 + 8 * (lane // 8) + lane % 8, 64 * wg + 16 * w)
        addrs.append(a)
    regs = _ldmatrix_x4_trans(smem, addrs)
    frags = {}
    for lane, r in regs.items():
        steps = []
        for j in range(2):   # P[j0 + j][e] = register 2 j + e
            lo, hi = [None] * 4, [None] * 4
            for e in range(2):
                P = _nibbles(r[2 * j + e])
                shifted = lambda s: P[s // 4:] + [None] * (s // 4)   # noqa: E731  P >> s
                take = lambda v: (v[0], v[4])                         # noqa: E731  bits 0-3, 16-19
                lo[2 * e], hi[2 * e] = take(shifted(0)), take(shifted(4))
                lo[2 * e + 1], hi[2 * e + 1] = take(shifted(8)), take(shifted(12))
            steps.append((lo, hi))
        frags[lane] = steps
    return frags, addrs


def test_int4_fragments_cover_both_halves_at_the_ptx_layout():
    """A stage's q tile (64 packed rows by 128 columns) as TMA writes it.
    Every lane's fragments hold, register by register, the A elements of
    the PTX layout (bf16 m64nNk16: a0 = M-row g, k 2t and 2t + 1; a1 =
    M-row g + 8; a2, a3 the same at k + 8), the low fragment the low nibbles
    of the step's rows and the high fragment their high nibbles; every
    (half, row, column) of the stage lands exactly once; each 8-lane phase
    of an ldmatrix reads 8 distinct 16-byte bank groups (no conflict)."""
    smem = [None] * (KP * 128)
    for k in range(KP):
        for n in range(128):
            smem[_swz(k, n)] = (k, n)
    seen = {}
    for wg in range(2):
        for w in range(4):
            for j0 in range(0, KP // 16, 2):
                frags, addrs = _warp_fragments(smem, wg, w, j0)
                for m in range(4):
                    assert len({(a // 16) % 8 for a in addrs[8 * m:8 * m + 8]}) == 8
                for lane, steps in frags.items():
                    g, t = lane // 4, lane % 4
                    for j, (lo, hi) in enumerate(steps):
                        ks = j0 + j
                        for half, regs in ((0, lo), (1, hi)):
                            for i, reg in enumerate(regs):
                                m = g + 8 * (i % 2)
                                for e, label in enumerate(reg):
                                    k = 16 * ks + 2 * t + e + 8 * (i // 2)
                                    assert label == (half, k, _column(wg, w, m))
                                    seen[label] = seen.get(label, 0) + 1
    assert len(seen) == 2 * KP * 128 and set(seen.values()) == {1}


# (d) the boxes of a call and the epilogue's stores ------------------------------------

def _call_reads(K, N, splits, tiled):
    """The TMA boxes of one call, as the kernel issues them (producer loop,
    `stages_per_split` as the host computes it), over all column tiles and
    cluster ranks: returns {(q element): count} and the pairs (x column,
    (q row, nibble)) that meet in the products. q elements are (panel, row,
    column) for the panel layout, (row, column) row-major, each only inside
    the tensor (TMA fills the rest of a box with zeros)."""
    Kq = K // 2
    nk = math.ceil(Kq / KP)
    per = math.ceil(nk / splits)
    q_reads, pairs = {}, {}
    for y in range(math.ceil(N / BM)):
        n0 = y * BM
        for rank in range(splits):
            s_begin = rank * per
            for s in range(max(0, min(nk, s_begin + per) - s_begin)):
                kp = (s_begin + s) * KP
                for j in range(KP):                      # box row j of the q tile
                    row = kp + j
                    for c in range(BM):
                        if tiled:                         # box [1, 64, 128] at (0, kp, y)
                            key = (y, row, c) if row < Kq else None
                        else:                             # box [64, 128] at (n0, kp)
                            key = (row, n0 + c) if row < Kq and n0 + c < N else None
                        if key is not None:
                            q_reads[key] = q_reads.get(key, 0) + 1
                    if y == 0:
                        # x boxes at columns kp (low) and K/2 + kp (high), zero past K
                        for half, c0 in ((0, kp), (1, Kq + kp)):
                            xcol = c0 + j
                            if xcol < K and row < Kq:    # rows past K/2: zero weights
                                pairs.setdefault(xcol, []).append((row, half))
    return q_reads, pairs


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("K,N,splits", [(96, 200, 1), (640, 256, 3), (200, 136, 2),
                                        (512, 384, 4)])
def test_int4_boxes_read_each_weight_byte_once(K, N, splits, tiled):
    """Each stored weight byte is read exactly once per call (the panel map
    reads the stored zeros past N of the last panel too), and every x
    column k meets exactly its own weight: row k's low nibble for k < K/2,
    row k - K/2's high nibble above; the low box's reach past K/2 meets only
    rows past K/2, which arrive as zeros."""
    q_reads, pairs = _call_reads(K, N, splits, tiled)
    Kq = K // 2
    if tiled:
        want = {(y, r, c) for y in range(math.ceil(N / BM)) for r in range(Kq)
                for c in range(BM)}
    else:
        want = {(r, n) for r in range(Kq) for n in range(N)}
    assert set(q_reads) == want and set(q_reads.values()) == {1}
    assert sorted(pairs) == list(range(K))
    for k, met in pairs.items():
        assert met == [(k, 0)] if k < Kq else met == [(k - Kq, 1)]


@pytest.mark.parametrize("R,N,splits", [(5, 200, 1), (300, 136, 3), (256, 4096, 2),
                                        (17, 384, 4)])
def test_int4_epilogue_writes_each_output_once(R, N, splits):
    """The epilogue (csrc/qmm_sm90.cuh::cluster_epilogue): rank b of a
    cluster stores rows r = b, b + csize, .. of its row tile, 4 columns a
    step, and skips a step that starts past N (a step that reaches past N
    stores only its columns below N). Every (row, column) of [R, N] is
    written once, nothing past N or R; and each consumer thread stores the
    same 4 columns in every step, the ones whose scales `epilogue_scale`
    loads before the main loop."""
    RT = tqmm.row_tile(R)
    written = {}
    for z in range(math.ceil(R / RT)):
        r0 = z * RT
        rows = min(RT, R - r0)
        for y in range(math.ceil(N / BM)):
            n0 = y * BM
            for rank in range(splits):
                my_rows = (rows - rank + splits - 1) // splits if rows > rank else 0
                for i in range(my_rows * (BM // 4)):
                    r, c = rank + (i // (BM // 4)) * splits, (i % (BM // 4)) * 4
                    thread = 128 + i % 256            # the loop strides by 256 threads
                    assert c == ((thread - 128) % (BM // 4)) * 4   # epilogue_scale's columns
                    if n0 + c >= N:
                        continue
                    for e in range(4):
                        if n0 + c + e < N:
                            key = (r0 + r, n0 + c + e)
                            written[key] = written.get(key, 0) + 1
    assert set(written) == {(r, n) for r in range(R) for n in range(N)}
    assert set(written.values()) == {1}


# (e) the chooser at the int4 stage count ----------------------------------------------

def _h100(c):
    """Clusters of c one-block-per-SM blocks an H100 holds at once."""
    return {1: 132, 2: 66, 3: 39, 4: 30}[c]


@pytest.mark.parametrize("R,K,N,want", [
    (64, 4096, 4096, 3),      # 32 tiles, 32 stages: 39 clusters of 3 fit, 30 of 4 do not
    (1, 4096, 11008, 1),      # 86 tiles: only single blocks fit one wave
    (128, 11008, 4096, 3),    # 86 stages
    (256, 4096, 32000, 1),    # 250 tiles
    (1, 4096, 2048, 4),       # 16 tiles
    (300, 4096, 4096, 2),     # 64 tiles (two row tiles)
    (5, 96, 200, 1),          # one stage
    (5, 1024, 256, 2),        # 8 stages: at most 2 ranks of 4
    (5, 512, 256, 1),         # 4 stages (bf16 int8 would take 8 and split in 2)
])
def test_split_cluster_at_int4_stages(R, K, N, want):
    """The int4 stage holds 128 logical k (64 packed rows), twice the bf16
    int8 stage, so the same K has half the stages to split."""
    assert tqmm.SM90_KB["int4"] == 2 * KP
    assert tqmm.split_cluster(R, K, N, tqmm.SM90_KB["int4"], _h100) == want
