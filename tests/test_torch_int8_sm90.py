"""The int8-weight wgmma kernel's design and the top-p kernels at Llama-3's
vocabulary, on the CPU.

- The top-p plain versions against JAX's Pallas kernels (interpret mode) at
  V = 128256, the vocabulary that the cluster route of csrc/top_p.cu serves.
- `quant_matmul_int8_sm90_model`, the CPU model of the decomposition of
  csrc/quant_matmul_int8_sm90.cu (K stages dealt to cluster ranks, the rank
  order of the reduction, the epilogue's order), against JAX's int8 Pallas
  kernel and against `qtensor._matmul_w8a8`.
- An index model of the kernel's register-A fragments (the swizzled 16-bit
  loads of q and the prmt byte permutes) and of its accumulator store: every
  (k, column) of a stage and every (row, column) of the output tile lands
  exactly once, at the position of the PTX layouts.
- The cluster-size chooser and the row tile.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.kernels.quant_matmul import quant_matmul as jax_quant_matmul  # noqa: E402
from sequoia_tpu.kernels.top_p import (  # noqa: E402
    top_p_threshold_from_logits as jax_from_logits,
    top_p_threshold_fused as jax_fused,
)
from sequoia_tpu.quant import qtensor as jq  # noqa: E402
from sequoia_torch.kernels import quant_matmul as tqmm  # noqa: E402
from sequoia_torch.kernels import top_p as tp  # noqa: E402

LLAMA3_VOCAB = 128256


# (a) top-p at V = 128256 ---------------------------------------------------------

@pytest.mark.parametrize("top_p", [0.5, 0.9])
def test_top_p_plain_matches_pallas_at_llama3_vocab(top_p):
    """R = 2 rows of V = 128256 (the kernel's cluster route: 4 blocks a row).
    Fused: the plain version's threshold equals the JAX kernel's (atol 0);
    from logits: the nuclei agree but for an ill-conditioned boundary token
    (`boundary_disagreements`)."""
    T = 0.6
    logits = (np.random.default_rng(11).normal(size=(2, LLAMA3_VOCAB)) * 3).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits) / T, axis=-1))
    want = np.asarray(jax_fused(jnp.asarray(probs), top_p, interpret=True))
    got = tp.top_p_threshold_fused(torch.from_numpy(probs), top_p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    want = np.asarray(jax_from_logits(jnp.asarray(logits), top_p, T, interpret=True))
    got = tp.top_p_threshold_from_logits(torch.from_numpy(logits), top_p, T)
    tp.boundary_disagreements(torch.from_numpy(probs), got, torch.tensor(want), top_p)


@pytest.mark.parametrize("V,route,blocks", [
    (32000, "register", 1), (32768, "register", 1), (32769, "cluster", 2),
    (LLAMA3_VOCAB, "cluster", 4), (262144, "cluster", 8), (300000, "cluster", 8)])
def test_top_p_route_follows_the_vocabulary(V, route, blocks):
    assert (V > tp.REGISTER_VOCAB) == (route == "cluster")
    if route == "cluster":
        assert tp.cluster_size(V) == blocks
        # 64 register values per thread of 512 hold the row up to 8 blocks.
        assert min(V, 8 * tp.REGISTER_VOCAB) <= blocks * 512 * 64


# (b) the decomposition model against JAX ---------------------------------------

def _inputs(R, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, K)).astype(np.float32)
    q = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.02 + 0.001).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("R", [1, 8, 17, 64, 300])
def test_sm90_model_matches_jax_int8_kernel(R):
    """f32 x: the model at 1, 2 and 3 cluster ranks against
    `quant_matmul(bits=8, interpret=True)` within 1e-5 of the largest
    |output| (f32 sums in other orders). K = 200 is three 64-k stages and
    a ragged fourth."""
    x, q, scale = _inputs(R, 200, 136, seed=R)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                       bits=8, interpret=True))
    for splits in (1, 2, 3):
        got = tqmm.quant_matmul_int8_sm90_model(torch.from_numpy(x), torch.from_numpy(q),
                                                torch.from_numpy(scale), splits=splits)
        assert got.dtype == torch.float32 and got.shape == (R, 136)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("R", [1, 8, 17, 64, 300])
def test_sm90_model_w8a8_is_bit_equal_to_jax(R):
    """x8 x q exact in integers, then float(acc) * sx * scale in that order:
    the model equals JAX's `_matmul_w8a8` bit for bit at any split."""
    x, q, scale = _inputs(R, 300, 72, seed=100 + R)
    jw = jq.QuantizedTensor(jnp.asarray(q), jnp.asarray(scale))
    want = np.asarray(jq._matmul_w8a8(jnp.asarray(x), jw, jnp.float32))
    x8, sx = tqmm.quantize_activations_plain(torch.from_numpy(x))
    for splits in (1, 2, 3):
        got = tqmm.quant_matmul_int8_sm90_model(x8, torch.from_numpy(q),
                                                torch.from_numpy(scale), sx=sx, splits=splits)
        np.testing.assert_array_equal(got.numpy(), want)


# (c) the fragment and tile index model ----------------------------------------------

ZERO = ("zero",)


def _swz(row, byte):
    """csrc/quant_matmul_int8_sm90.cu::swz, the 128-byte TMA swizzle."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _byte_perm(x, y, sel):
    """`__byte_perm` on lists of 4 byte labels (selector nibbles 0..7)."""
    src = list(x) + list(y)
    return [src[(sel >> (4 * i)) & 7] for i in range(4)]


def _load_a(smem, a8, col, t, ks):
    """The kernel's `load_a` for one k step, on byte labels: returns the
    four fragment registers, each a list of its byte (s8) or bf16 labels,
    low first, and the shared-memory byte offsets of its 16-bit loads (the
    lane's `AOffsets` plus whole multiples of 8 rows)."""
    addrs = []
    kn = 4 if a8 else 2
    offs = [_swz(kn * t + d, col) for d in range(kn)]   # AOffsets

    def h(d, rows):
        """Row kn t + d + rows, at off[d] + 128 rows (rows % 8 == 0)."""
        off = offs[d] + 128 * rows
        assert off == _swz(kn * t + d + rows, col)
        addrs.append(off)
        return [smem[off], smem[off + 1], ZERO, ZERO]

    if not a8:
        k = 16 * ks
        p0 = _byte_perm(h(0, k), h(1, k), 0x5140)
        p8 = _byte_perm(h(0, k + 8), h(1, k + 8), 0x5140)
        # int8x4_to_bf16: lo = bytes 0, 1; hi = bytes 2, 3
        return [p0[:2], p0[2:], p8[:2], p8[2:]], addrs
    k = 32 * ks
    l01 = _byte_perm(h(0, k), h(1, k), 0x5140)
    l23 = _byte_perm(h(2, k), h(3, k), 0x5140)
    u01 = _byte_perm(h(0, k + 16), h(1, k + 16), 0x5140)
    u23 = _byte_perm(h(2, k + 16), h(3, k + 16), 0x5140)
    return [_byte_perm(l01, l23, 0x5410), _byte_perm(l01, l23, 0x7632),
            _byte_perm(u01, u23, 0x5410), _byte_perm(u01, u23, 0x7632)], addrs


def _column(wg, w, m):
    """The weight column of M-row m (0..15) of warp w in warpgroup wg:
    row g is column 2g of the warp's 16, row g + 8 column 2g + 1."""
    return 64 * wg + 16 * w + 2 * (m % 8) + m // 8


@pytest.mark.parametrize("a8", [False, True])
def test_sm90_a_fragments_cover_the_stage_at_the_ptx_layout(a8):
    """A stage's q tile (64 k of bf16 x or 128 k of x8, by 128 columns) as
    TMA writes it; every lane's fragments hold, register by register, the
    A elements the PTX layout puts there (bf16 m64nNk16: a0 = row g, k 2t and
    2t+1; a1 = row g+8; a2, a3 the same at k + 8. s8 m64nNk32: a0 = row g,
    k 4t..4t+3; a1 = row g+8; a2, a3 at k + 16), and every (k, column)
    lands exactly once. bf16's loads are free of bank conflicts; s8's at
    most 2-way."""
    kb = 128 if a8 else 64
    smem = [None] * (kb * 128)
    for k in range(kb):
        for n in range(128):
            smem[_swz(k, n)] = (k, n)
    seen = {}
    worst = 1
    for wg in range(2):   # consumer warpgroups: warps 4..11 of the block
        for w in range(4):
            per_load = {}
            for lane in range(32):
                g, t = lane // 4, lane % 4
                col = 64 * wg + 16 * w + 2 * g
                for ks in range(4):
                    regs, addrs = _load_a(smem, a8, col, t, ks)
                    for j, off in enumerate(addrs):
                        per_load.setdefault((ks, j), []).append(off)
                    for i, reg in enumerate(regs):
                        m = g + 8 * (i % 2)
                        for e, label in enumerate(reg):
                            k = (32 * ks + 4 * t + e + 16 * (i // 2) if a8
                                 else 16 * ks + 2 * t + e + 8 * (i // 2))
                            assert label == (k, _column(wg, w, m))
                            seen[label] = seen.get(label, 0) + 1
            for offs in per_load.values():   # one 16-bit load of the 32 lanes
                words = {}
                for off in offs:
                    words.setdefault((off // 4) % 32, set()).add(off // 4)
                worst = max(worst, max(len(v) for v in words.values()))
    assert len(seen) == kb * 128 and set(seen.values()) == {1}
    assert worst == (2 if a8 else 1)


@pytest.mark.parametrize("RT", [8, 16, 64, 256])
def test_sm90_accumulator_store_covers_the_tile(RT):
    """The epilogue's stores: D register 4i + 2h + e of chunk j (the wgmma
    D layout: row g + 8h, column 8i + 2t + e of the chunk's N) goes to
    tile[r = chunk * N + 8i + 2t + e][column of M-row g + 8h], the column
    convention of the A fragments; every (r, column) of [RT, 128] once."""
    chunk = min(RT, 64)
    seen = {}
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                col = 64 * wg + 16 * w + 2 * g
                for j in range(RT // chunk):
                    for i in range(chunk // 8):
                        for e in range(2):
                            r = j * chunk + 8 * i + 2 * t + e
                            for h, dst in ((0, col), (1, col + 1)):
                                assert dst == _column(wg, w, g + 8 * h)
                                seen[(r, dst)] = seen.get((r, dst), 0) + 1
    assert len(seen) == RT * 128 and set(seen.values()) == {1}


# (d) the chooser -----------------------------------------------------------------

def _h100(c):
    """Clusters of c one-block-per-SM blocks an H100 held at once (the
    kernel's occupancy query on the card: 132, 66, 39, 30)."""
    return {1: 132, 2: 66, 3: 39, 4: 30}[c]


@pytest.mark.parametrize("R,K,N,a8,want", [
    (64, 4096, 4096, False, 3),      # 32 tiles: 39 clusters of 3 fit, 30 of 4 do not
    (64, 4096, 11008, False, 1),     # 86 tiles: only single blocks fit one wave
    (128, 11008, 4096, True, 3),
    (256, 4096, 32000, False, 1),    # 250 tiles: more than one wave anyway
    (1, 4096, 2048, True, 4),        # 16 tiles
    (300, 4096, 4096, False, 2),     # 64 tiles (two row tiles)
    (5, 96, 200, False, 1),          # 2 stages: too few to split
    (5, 512, 256, False, 2),         # 8 stages: at most 2 ranks of 4
])
def test_split_cluster_chooser(R, K, N, a8, want):
    kb = tqmm.SM90_KB["w8a8" if a8 else "int8"]
    assert tqmm.split_cluster(R, K, N, kb, _h100) == want


def test_split_cluster_skips_sizes_the_card_cannot_hold():
    held = {1: 132, 2: 66, 3: 0, 4: -1}
    assert tqmm.split_cluster(64, 4096, 4096, tqmm.SM90_KB["int8"], held.get) == 2
    # More resident clusters (small blocks): 86 tiles fit one wave of 3.
    roomy = {1: 264, 2: 132, 3: 88, 4: 66}
    assert tqmm.split_cluster(1, 4096, 11008, tqmm.SM90_KB["int8"], roomy.get) == 3


@pytest.mark.parametrize("R,want", [(1, 8), (8, 8), (9, 16), (64, 64), (65, 128),
                                    (256, 256), (300, 256)])
def test_row_tile(R, want):
    assert tqmm.row_tile(R) == want
    assert math.ceil(R / 256) == math.ceil(R / max(want, 256))
