"""The w4a8 kernel (the x8 instantiation of csrc/quant_matmul_int4_sm90.cu)
and the activation quantizer that feeds it (csrc/quant_matmul_a8.cu), on
the CPU.

- `quant_matmul_w4a8_sm90_model`, the CPU model of the kernel's
  decomposition (K stages of 64 packed rows dealt to cluster ranks, each
  stage's two 32-row k steps against the low and the high x8 box, 16 x the
  nibbles summed in int32 and shifted back per rank, the ranks added in
  rank order, then float(acc) * sx * scale), equal bit for bit to JAX's
  `quant_matmul(..., bits=4, unpack="w4a8", interpret=True)`.
- The nibble -> s8 step (the masks (w << 4) & 0xF0F0F0F0 and w &
  0xF0F0F0F0) over every byte value.
- An index model of the s8 register-A fragments (ldmatrix.x4.trans at the
  rows `XS8::ldm_row` picks, then two prmt per register pair): every (half,
  k, column) of a stage lands in exactly one byte, at the PTX position, and
  the loads are free of bank conflicts; the producer's copy of an x8 box
  lays bytes out as TMA's 64-byte swizzle does.
- The ring depth and the cluster-size chooser at w4a8's stage.
- A layout model of the quantizer's launch (one block per row, 16-byte
  vectors held in registers): every element is read once and every x8 byte
  written once; and the plain quantizer equal bit for bit to JAX's.

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
from sequoia_torch.kernels import quant_matmul as tqmm  # noqa: E402

KP = 64        # packed q rows per stage (csrc/quant_matmul_int4_sm90.cu kKp)
STEP = 32      # packed q rows per s8 k step (XS8::kStepRows)
BM = 128       # output columns per block


def _inputs(R, K, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, K)) * 2).astype(np.float32)
    q = rng.integers(-128, 128, size=(K // 2, N)).astype(np.int8)   # every nibble, -8 too
    scale = (rng.random((1, N)) * 0.02 + 0.001).astype(np.float32)
    return x, q, scale


# (a) the decomposition model against JAX ------------------------------------------

def _fused_sx_differs(x):
    """Rows where XLA's compile of JAX's w4a8 wrapper, which turns the
    division `max(amax, 1e-8) / 127.0` into a multiplication by the f32
    reciprocal of 127, gives another sx than the true division that the
    JAX source writes (and the port and JAX's unfused ops compute): one
    rounding apart, on about one row in twenty."""
    am = np.maximum(np.abs(x.astype(np.float32)).max(axis=-1), np.float32(1e-8))
    return am / np.float32(127.0) != am * np.float32(1.0 / 127.0)


@pytest.mark.parametrize("K,N", [(640, 256), (96, 200), (1000, 136)])   # 5 stages; ragged
@pytest.mark.parametrize("R", [1, 5, 64, 256])
def test_w4a8_sm90_model_equals_jax_kernel(R, K, N):
    """f32 x (f32 out) and bf16 x (bf16 out): the model at 1-4 cluster ranks
    equals the plain version bit for bit, and `quant_matmul(bits=4,
    unpack="w4a8", interpret=True)` bit for bit on every row whose sx the
    fused JAX wrapper computes as the source writes it (K <= 16512 keeps
    JAX's f32 partial sums exact); the other rows (`_fused_sx_differs`) of
    the JAX kernel equal, bit for bit, the same product with sx and x8 from
    the reciprocal of 127. K = 640 is
    five 64-row stages (four ranks: 2 + 2 + 1 + 0), K = 96 one partial
    stage, K = 1000 eight stages, the last partial."""
    x, q, scale = _inputs(R, K, N, seed=R + K + N)
    for x_dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jx = jnp.asarray(x).astype(jdt)
        want = np.asarray(jax_quant_matmul(jx, jnp.asarray(q), jnp.asarray(scale), bits=4,
                                           interpret=True, unpack="w4a8").astype(jnp.float32))
        tx = torch.from_numpy(x).to(x_dtype)
        plain = tqmm.quant_matmul(tx, torch.from_numpy(q), torch.from_numpy(scale), bits=4,
                                  unpack="w4a8")
        for splits in (1, 2, 3, 4):
            got = tqmm.quant_matmul_w4a8_sm90_model(tx, torch.from_numpy(q),
                                                    torch.from_numpy(scale), splits=splits)
            assert got.dtype == x_dtype and got.shape == (R, N)
            assert torch.equal(got, plain)
        got = got.float().numpy()
        other = _fused_sx_differs(np.asarray(jx.astype(jnp.float32)))
        np.testing.assert_array_equal(got[~other], want[~other])
        # The other rows follow the reciprocal: sx and x8 from it, bit for bit.
        xf = tx.float()
        sxa = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) * torch.tensor(1.0 / 127.0)
        x8a = torch.round(xf / sxa).clamp(-127, 127).long()
        acc = x8a @ tqmm.unpack_int4(torch.from_numpy(q)).long()
        alt = (acc.float() * sxa * torch.from_numpy(scale)).to(x_dtype).float().numpy()
        np.testing.assert_array_equal(alt[other], want[other])


def test_w4a8_sm90_model_equals_jax_kernel_bit_for_bit():
    """Rows whose sx is the same under both divisions (checked), 64 rows,
    K = 1000, N = 136: the model equals the JAX kernel on every element,
    at every cluster split."""
    x, q, scale = _inputs(64, 1000, 136, seed=9)
    x[:, 0] = 63.5 * np.where(np.arange(64) % 2, 1, -1)    # amax 63.5: sx = 0.5
    x[:, 1:] = np.clip(x[:, 1:], -63, 63)
    assert not _fused_sx_differs(x).any()
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                       bits=4, interpret=True, unpack="w4a8"))
    for splits in (1, 2, 3, 4):
        got = tqmm.quant_matmul_w4a8_sm90_model(torch.from_numpy(x), torch.from_numpy(q),
                                                torch.from_numpy(scale), splits=splits)
        np.testing.assert_array_equal(got.numpy(), want)


def test_w4a8_model_int32_bound():
    """|16 acc| <= 16 * 127 * 8 * K stays below 2^31 up to K = 132104; at
    the widest 7B projection the worst row (x8 = 127 against every nibble
    -8) sums exactly."""
    assert 16 * 127 * 8 * 132104 < 2 ** 31 <= 16 * 127 * 8 * 132105
    x = np.full((1, 11008), 5.0, np.float32)            # x8 = 127 everywhere
    q = np.full((5504, 8), -120, np.int8)                 # 0x88: both nibbles -8
    got = tqmm.quant_matmul_w4a8_sm90_model(torch.from_numpy(x), torch.from_numpy(q),
                                            torch.ones(1, 8), splits=1)
    sx = np.float32(5.0) / np.float32(127.0)
    np.testing.assert_array_equal(got.numpy(), np.float32(-127 * 8 * 11008) * sx * 1.0)


# (b) the nibble -> s8 step --------------------------------------------------------

def test_nibble_to_s8_is_exact_for_every_byte():
    """Words of four bytes, every byte value in every position: the masks
    give, per byte, 16 x the sign-extended low and high nibble as a signed
    byte (0x8 -> -128), and `nibbles_s8` (the model's step) agrees."""
    b = np.arange(256, dtype=np.uint32)
    words = b | (np.roll(b, 1) << 8) | (np.roll(b, 2) << 16) | (np.roll(b, 3) << 24)
    lo = (words << np.uint32(4)) & np.uint32(0xF0F0F0F0)
    hi = words & np.uint32(0xF0F0F0F0)
    signed = lambda u: ((u.astype(np.int64) ^ 8) - 8)   # noqa: E731
    for pos, src in enumerate((b, np.roll(b, 1), np.roll(b, 2), np.roll(b, 3))):
        lo_b = ((lo >> np.uint32(8 * pos)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
        hi_b = ((hi >> np.uint32(8 * pos)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(lo_b, 16 * signed(src & 15))
        np.testing.assert_array_equal(hi_b, 16 * signed(src >> 4))
    tlo, thi = tqmm.nibbles_s8(torch.from_numpy(b.astype(np.uint8).view(np.int8)))
    np.testing.assert_array_equal(tlo.numpy(), 16 * signed(b & 15))
    np.testing.assert_array_equal(thi.numpy(), 16 * signed(b >> 4))


# (c) the fragment index model and the x8 box layout -------------------------------

def _swz(row, byte):
    """csrc/qmm_sm90.cuh::swz, the 128-byte TMA swizzle."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def _swz64(row, byte):
    """csrc/qmm_sm90.cuh::swz64, the 64-byte TMA swizzle."""
    return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15)


def _ldm_row(lane):
    """XS8::ldm_row: the q row (of 32) that lane `lane` addresses."""
    m, tt, s = lane // 8, (lane % 8) // 2, lane % 2
    return 16 * (m // 2) + 4 * tt + 2 * ((tt >> 1) ^ (m & 1)) + s


def _byte_perm(x, y, sel):
    """__byte_perm on byte labels: bytes 0-3 of x, then 4-7 of y."""
    src = list(x) + list(y)
    return [src[(sel >> (4 * i)) & 7] for i in range(4)]


def _column(wg, w, m):
    """The weight column of M-row m (0..15) of warp w in warpgroup wg."""
    return 64 * wg + 16 * w + 2 * (m % 8) + m // 8


def test_s8_fragments_cover_both_halves_at_the_ptx_layout():
    """A stage's q tile (64 packed rows by 128 columns) as TMA writes it.
    Each warp's ldmatrix.x4.trans per k step at the rows of `ldm_row`, then
    XS8::fragments' prmt: every lane's registers hold, byte by byte, the
    PTX s8 A layout (m64nNk32: a0 = M-row g, k 4t .. 4t + 3; a1 = M-row g +
    8; a2, a3 at k + 16), the low fragment from the step's low nibbles and
    the high fragment from their high nibbles; every (half, row, column) of
    the stage lands exactly once; each 8-lane phase of an ldmatrix reads 8
    distinct 16-byte bank groups."""
    smem = [None] * (KP * 128)
    for k in range(KP):
        for n in range(128):
            smem[_swz(k, n)] = (k, n)
    seen = {}
    for wg in range(2):
        for w in range(4):
            colbase = 64 * wg + 16 * w
            for j in range(KP // STEP):
                addrs = [_swz(_ldm_row(lane), colbase) + j * STEP * 128 for lane in range(32)]
                for m in range(4):
                    assert len({(a // 16) % 8 for a in addrs[8 * m:8 * m + 8]}) == 8
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    regs = []   # ldmatrix .trans: rows 2t, 2t + 1 of matrix m, column pair g
                    for m in range(4):
                        a, b = addrs[8 * m + 2 * t], addrs[8 * m + 2 * t + 1]
                        regs.append([smem[a + 2 * g], smem[a + 2 * g + 1],
                                     smem[b + 2 * g], smem[b + 2 * g + 1]])
                    s0, s1 = (0x6420, 0x7531) if t < 2 else (0x2064, 0x3175)
                    words = [_byte_perm(regs[0], regs[1], s0), _byte_perm(regs[0], regs[1], s1),
                             _byte_perm(regs[2], regs[3], s0), _byte_perm(regs[2], regs[3], s1)]
                    for half in (0, 1):      # (w << 4) & mask: low nibbles; w & mask: high
                        for i, word in enumerate(words):
                            m_row = g + 8 * (i % 2)
                            for e, (row, col) in enumerate(word):
                                k = 4 * t + e + 16 * (i // 2)
                                assert row == STEP * j + k
                                assert col == _column(wg, w, m_row)
                                key = (half, row, col)
                                seen[key] = seen.get(key, 0) + 1
    assert len(seen) == 2 * KP * 128 and set(seen.values()) == {1}


@pytest.mark.parametrize("RT", [8, 64, 256])
def test_x8_box_copy_matches_tma_swizzle(RT):
    """The producer warp's copy of an x8 box (`swz64`, used where TMA cannot
    address x8) puts byte (row, k) where CU_TENSOR_MAP_SWIZZLE_64B does:
    the 16-byte chunk bits 4-5 of the offset XOR bits 7-8 (CuTe's
    Swizzle<2,4,3>), a bijection of the box."""
    offs = set()
    for r in range(RT):
        for b in range(64):
            o = 64 * r + b
            assert _swz64(r, b) == o ^ ((o >> 3) & 0x30)
            offs.add(_swz64(r, b))
    assert offs == set(range(64 * RT))


# (d) ring depth and the chooser at w4a8's stage -----------------------------------

def test_w4a8_ring_depth():
    """The 216 KB budget rule (file note): 64 packed rows (8 KB) and two x8
    boxes of RT rows of 64 bytes a stage, up to 16 stages, at least 3; the
    output tile [RT, 132] words fits in the stages."""
    depth = {}
    for rt in (8, 16, 32, 64, 128, 256):
        stage = KP * 128 + 2 * rt * 64
        depth[rt] = min(216 * 1024 // stage, 16)
        assert depth[rt] >= 3 and rt * 132 * 4 <= depth[rt] * stage
        assert stage % 1024 == 0 and (rt * 64) % 512 == 0   # box and tile alignment
    assert depth == {8: 16, 16: 16, 32: 16, 64: 13, 128: 9, 256: 5}


def _h100(c):
    """Clusters of c one-block-per-SM blocks an H100 holds at once."""
    return {1: 132, 2: 66, 3: 39, 4: 30}[c]


@pytest.mark.parametrize("R,K,N,want", [
    (64, 4096, 4096, 3),      # 32 tiles, 32 stages
    (256, 4096, 4096, 3),     # the same: one row tile
    (1, 4096, 11008, 1),      # 86 tiles: only single blocks fit one wave
    (128, 11008, 4096, 3),    # 86 stages
    (256, 4096, 32000, 1),    # 250 tiles
    (300, 4096, 4096, 2),     # 64 tiles (two row tiles)
    (5, 96, 200, 1),          # one stage
    (5, 1024, 256, 2),        # 8 stages: at most 2 ranks of 4
])
def test_split_cluster_at_w4a8_stages(R, K, N, want):
    """w4a8's stage holds 128 logical k (64 packed rows), as int4's."""
    assert tqmm.SM90_KB["w4a8"] == 2 * KP == tqmm.SM90_KB["int4"]
    assert tqmm.split_cluster(R, K, N, tqmm.SM90_KB["w4a8"], _h100) == want


@pytest.mark.parametrize("R,K,N,want", [
    (256, 4096, 4096, (128, 2)),     # 64 tiles x 2 on 128 SMs beat 32 x 3 on 96
    (256, 11008, 4096, (128, 2)),
    (200, 4096, 4096, (128, 2)),
    (256, 4096, 11008, (256, 1)),    # 172 tiles of 128 rows: more than one wave
    (256, 4096, 32000, (256, 1)),
    (300, 4096, 4096, (256, 2)),     # 96 tiles of 128 (one block each) against 64 x 2
    (128, 4096, 4096, (128, 3)),     # row_tile(128): the 128-row tile anyway
    (64, 4096, 11008, (64, 1)),
])
def test_sm90_tiling_at_w4a8(R, K, N, want):
    """w4a8 takes 128-row tiles above 128 rows where their clusters fit one
    wave and occupy more SMs than the 256-row tiles' (the card's cluster
    occupancy is the same for both: one block an SM)."""
    mc = lambda rt, c: _h100(c)  # noqa: E731
    assert tqmm.sm90_tiling(R, K, N, "w4a8", mc) == want
    # the other kernels keep row_tile(R)
    assert tqmm.sm90_tiling(R, K, N, "int4", mc)[0] == tqmm.row_tile(R)


# (e) the quantizer ----------------------------------------------------------------

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("K", [100, 4096, 11008, 70000])
def test_quantizer_layout_reads_each_element_once(K, itemsize, aligned):
    """One block per row (`quantizer_block`): thread t holds vectors t + i
    nt, i < 4, when the row fits (one pass), else it loops twice over t, t +
    nt, ..; either way each element of the row is read once per pass and
    each x8 byte written once; whole warps, at most 512 threads (two blocks
    an SM, so 256 rows run in one wave on 132 SMs), one vector a thread
    below that."""
    e, nt = tqmm.quantizer_block(K, itemsize, aligned)
    assert e == (16 // itemsize if aligned and K % (16 // itemsize) == 0 else 1)
    assert nt % 32 == 0 and 32 <= nt <= tqmm.QUANT_MAX_THREADS
    nvec = K // e
    fits = nvec <= tqmm.QUANT_MAX_VECS * nt
    assert fits == (nvec <= tqmm.QUANT_MAX_VECS * tqmm.QUANT_MAX_THREADS)
    if nt < tqmm.QUANT_MAX_THREADS:
        assert nvec <= nt < nvec + 32
    reads = np.zeros(K, np.int64)
    for t in range(nt):
        js = ([t + i * nt for i in range(tqmm.QUANT_MAX_VECS)] if fits
              else list(range(t, nvec, nt)))
        for jv in js:
            if jv < nvec:
                reads[jv * e:(jv + 1) * e] += 1
    assert (reads == 1).all()


def _jax_quantize_activations(x):
    """JAX's activation quantizer (`kernels/quant_matmul.py:361-364`)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    return np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)), np.asarray(sx)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_quantizer_equals_jax_at_the_edges(dtype):
    """x8 and sx equal JAX's bit for bit on rows that reach each edge: an
    all-zero row, rows below the 1e-8 floor of sx, exact .5 ties, values
    at +-amax (+-127, the clip), and rows of one value."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((8, 256)) * 4).astype(np.float32)
    x[0] = 0.0
    x[1] = rng.standard_normal(256) * 1e-10                       # sx = 1e-8 / 127
    x[2, :5] = [127.0, -127.0, 0.5, 1.5, -2.5]                    # sx = 1: ties
    x[2, 5:] = np.clip(x[2, 5:], -120, 120)
    x[3] = np.clip(x[3], -13, 13)
    x[3, :3] = [-13.890625, 0.7109375, 1.3671875]                 # sx = 7/64: ties
    x[4] = 3.0                                                    # one value: all 127
    x[5, 7] = 1e4                                                 # one outlier, the rest 0
    x[6] = -np.abs(x[6])                                          # -amax: -127
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want8, wants = _jax_quantize_activations(jx)
    got8, gots = tqmm.quantize_activations(tx)
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(gots.numpy(), wants)
    assert got8[0].abs().max() == 0 and (got8[4] == 127).all()
    assert got8[2, :2].tolist() == [127, -127] and got8[6].min() == -127
    assert got8.abs().max() <= 127
