"""The f32-x route of the quant matmuls: f32 x split exactly into three bf16
planes (`split_bf16x3`), then the planes instantiation of the int8 / int4
wgmma kernels (csrc/split_bf16x3.cu, csrc/quant_matmul_int8_sm90.cu,
csrc/quant_matmul_int4_sm90.cu).

On the CPU:
- `split_bf16x3_plain` gives back every f32 of |x| >= 2^-110 bit for bit
  (10^5 random values from 2^-100 to FLT_MAX, and adversarial ones), each
  plane a bf16 value, none above |x|; below 2^-110 (f32 subnormals
  included) the last plane is truncated, an error under 2^-133.
- `quant_matmul_f32x3_model`, the CPU model of the decomposition (planes,
  stages, cluster ranks in rank order, then `acc * scale`), against JAX's
  int8, int4 (shift, float) and panel-tiled Pallas kernels in interpret
  mode, within 1e-5 of the largest |output|.
- The row tiles that `sm90_tiling` picks for the planes instantiations.

The `cuda`-marked tests hold the split kernel to its plain version bit for
bit, the route to the plain version (1e-4 of the largest |output|) and to
an f64 product at the 7B shapes, and two launches to equal bits; they skip
here. JAX is imported only by the tests that compare with it.
"""

import numpy as np
import pytest
import torch

from sequoia_torch.kernels import build
from sequoia_torch.kernels import quant_matmul as qmm
from sequoia_torch.quant.qtensor import QuantizedTensor, tile_int4

TINY = 2.0 ** -133          # bf16's least subnormal
EXACT_FROM = 2.0 ** -110    # at and above, the split is exact


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _planes_np(x: np.ndarray):
    """The split in numpy float32 arithmetic, independent of the port: the
    three planes as f32 values (b2 truncated to its high 16 bits)."""
    u = x.view(np.uint32)
    sign = u & np.uint32(0x80000000)
    mask = np.uint32(0xFFFF0000)
    b0 = (u & mask).view(np.float32)
    r = ((x - b0).view(np.uint32) | sign).view(np.float32)
    b1 = (r.view(np.uint32) & mask).view(np.float32)
    r2 = ((r - b1).view(np.uint32) | sign).view(np.float32)
    return b0, b1, (r2.view(np.uint32) & mask).view(np.float32)


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(10)
    if kind == "random":   # |x| from 2^-100 to FLT_MAX: exponents 27..254, any mantissa
        e = rng.integers(27, 255, size=100_000, dtype=np.uint32)
        m = rng.integers(0, 1 << 23, size=100_000, dtype=np.uint32)
        s = rng.integers(0, 2, size=100_000, dtype=np.uint32)
        return _f32((s << 31) | (e << 23) | m)
    if kind == "adversarial":
        hi = rng.integers(27 << 7, 254 << 7, size=512, dtype=np.uint32) << 16
        bits = np.concatenate([
            [0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF],   # +-0, +-FLT_MAX
            hi | 0xFFFF, (hi | 0xFFFF) | 0x80000000,           # low 16 bits all ones
            hi | 0x7FFF, hi | 0x8000, hi | 0x0001,              # one bit of the low half
            (np.arange(27, 255, dtype=np.uint32) << 23),        # powers of two 2^-100..2^127
            (np.arange(27, 255, dtype=np.uint32) << 23) | 0x7FFFFF,   # all mantissa ones
        ]).astype(np.uint32)
        return _f32(bits)
    # kind == "tiny": below 2^-110, f32 subnormals included
    e = rng.integers(1, 17, size=20_000, dtype=np.uint32)          # normals 2^-126..2^-111
    m = rng.integers(0, 1 << 23, size=20_000, dtype=np.uint32)
    sub = rng.integers(1, 1 << 23, size=20_000, dtype=np.uint32)    # subnormals
    bits = np.concatenate([(e << 23) | m, sub, sub | 0x80000000, [0x00000001, 0x00800000]])
    return _f32(bits.astype(np.uint32))


# (a) the split ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_split_plain_reconstructs_x_bit_for_bit(kind):
    """|x| >= 2^-100 (and +-0): the planes, summed in f32 in plane order,
    give x's bits back; each plane equals the numpy split's f32 value (a
    bf16 value: low 16 bits zero), is finite and no larger than |x|."""
    x = _values(kind)
    planes = qmm.split_bf16x3_plain(torch.from_numpy(x).reshape(-1, 20))
    assert planes.dtype == torch.bfloat16 and planes.shape[0] == 3
    p = [planes[i].float().reshape(-1).numpy() for i in range(3)]
    for got, want in zip(p, _planes_np(x)):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.isfinite(got).all() and (np.abs(got) <= np.abs(x)).all()
        assert not (got.view(np.uint32) & 0xFFFF).any()
    back = (p[0] + p[1]) + p[2]
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))


def test_split_plain_error_below_two_to_minus_110():
    """Below 2^-110 (f32 subnormals included) b2 keeps only its bits at or
    above 2^-133: the planes sum to x truncated toward zero on that grid,
    an error under 2^-133 of x's sign; x on the grid comes back exactly."""
    x = _values("tiny")
    assert (np.abs(x) < EXACT_FROM).all()
    planes = qmm.split_bf16x3_plain(torch.from_numpy(x)[None])
    p = [planes[i, 0].float().numpy().astype(np.float64) for i in range(3)]
    err = x.astype(np.float64) - ((p[0] + p[1]) + p[2])
    assert (np.abs(err) < TINY).all() and (np.sign(err) * np.sign(x) >= 0).all()
    on_grid = np.fmod(np.abs(x.astype(np.float64)), TINY) == 0
    assert on_grid.any() and (err[on_grid] == 0).all()
    assert np.abs(err).max() > TINY / 2   # the bound is reached, not loose


def test_split_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32))
    assert torch.equal(qmm.split_bf16x3(x).view(torch.int16),
                       qmm.split_bf16x3_plain(x).view(torch.int16))


# (b) the decomposition model against JAX -------------------------------------------

def _inputs(R, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, K)).astype(np.float32)
    q = rng.integers(-128, 128, size=(K if bits == 8 else K // 2, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.02 + 0.001).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("kernel", ["int8", "int4_shift", "int4_float", "tiled"])
@pytest.mark.parametrize("R,K,N,splits", [
    (5, 96, 200, 1),        # ragged: K below one stage, N past a column tile
    (64, 640, 256, 3),      # 10 stages over 3 ranks
    (17, 4096, 4096, 4),    # a 7B projection, R in the 17..32 tile
])
def test_f32x3_model_matches_jax_kernel(kernel, R, K, N, splits):
    """The model against JAX's Pallas kernel (interpret mode) on f32 x:
    within 1e-5 of the largest |output| (exact products, f32 sums in
    another order)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from sequoia_tpu.kernels.quant_matmul import quant_matmul as jax_qmm
    from sequoia_tpu.kernels.quant_matmul import quant_matmul_tiled as jax_tiled
    from sequoia_tpu.quant import qtensor as jq

    bits = 8 if kernel == "int8" else 4
    x, q, scale = _inputs(R, K, N, bits, seed=R + K + N + bits)
    if kernel == "tiled":
        jt = jq.tile_int4(jq.QuantizedTensor(jnp.asarray(q), jnp.asarray(scale)))
        want = np.asarray(jax_tiled(jnp.asarray(x), jt.q, jt.scale, interpret=True))
        qt = tile_int4(QuantizedTensor(torch.from_numpy(q), torch.from_numpy(scale))).q
        np.testing.assert_array_equal(qt.numpy(), np.asarray(jt.q))
    else:
        unpack = "auto" if bits == 8 else kernel[5:]
        want = np.asarray(jax_qmm(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                  bits=bits, interpret=True, unpack=unpack))
        qt = torch.from_numpy(q)
    got = qmm.quant_matmul_f32x3_model(torch.from_numpy(x), qt, torch.from_numpy(scale),
                                       bits=bits, splits=splits)
    assert got.dtype == torch.float32 and got.shape == (R, N)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * peak)


# (c) the tiling ------------------------------------------------------------------

@pytest.mark.parametrize("R,kind,want", [
    (1, "int8_f32", 8), (64, "int8_f32", 64), (128, "int8_f32", 128), (256, "int8_f32", 128),
    (300, "int8_f32", 128), (64, "int4_f32", 64), (128, "int4_f32", 64),
    (256, "int4_f32", 64), (256, "int8", 256), (256, "int4", 256),
])
def test_planes_row_tile_stops_at_its_cap(R, kind, want):
    """The planes instantiations' row tile is `row_tile(R)` up to
    SM90_F32_MAX_RT; the bf16 kinds keep theirs."""
    rt, c = qmm.sm90_tiling(R, 4096, 4096, kind, lambda rt, c: 132 // c)
    assert rt == want and 1 <= c <= qmm.SM90_MAX_SPLIT


# (d) on the card -----------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,odd", [
    ("random", 1000, False), ("adversarial", 1, False),
    ("tiny", 1, False), ("random", 1, True),   # R*K % 4 != 0: the single-element path
])
def test_split_kernel_matches_plain_bit_for_bit(kind, rows, odd):
    _need_cuda()
    x = _values(kind)
    x = torch.from_numpy(x[:-1] if odd else x).reshape(rows, -1).cuda()
    before = build.launches["split_bf16x3"]
    got = qmm.split_bf16x3(x)
    assert build.launches["split_bf16x3"] == before + 1
    want = qmm.split_bf16x3_plain(x)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _route(kernel, x, q, scale):
    if kernel == "tiled":
        t = tile_int4(QuantizedTensor(q, scale))
        return (lambda: qmm.quant_matmul_tiled(x, t.q, t.scale),
                lambda: qmm.quant_matmul_tiled_plain(x, t.q, t.scale), "quant_matmul_tiled")
    bits = 8 if kernel == "int8" else 4
    return (lambda: qmm.quant_matmul(x, q, scale, bits=bits),
            lambda: qmm.quant_matmul_plain(x, q, scale, bits=bits), f"quant_matmul_{kernel}")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["int8", "int4", "tiled"])
@pytest.mark.parametrize("R,K,N", [(3, 96, 200), (64, 128, 256), (17, 4096, 4096),
                                   (5, 96, 200), (300, 4096, 4096), (256, 11008, 4096)])
def test_f32_route_launches_the_planes_kernel(kernel, R, K, N):
    """f32 x: one split and one planes kernel a call, within 1e-4 of the
    largest |plain| of the plain version, and two launches on one input
    give equal bits."""
    _need_cuda()
    bits = 8 if kernel == "int8" else 4
    x, q, scale = (torch.from_numpy(a).cuda() for a in _inputs(R, K, N, bits, R + K + N))
    call, plain, counter = _route(kernel, x, q, scale)
    before = dict(build.launches)
    got, again = call(), call()
    assert build.launches[counter] == before[counter] + 2
    assert build.launches["split_bf16x3"] == before["split_bf16x3"] + 2
    assert build.launches[counter + "_wgmma"] == before[counter + "_wgmma"]
    assert torch.equal(got, again)
    want = plain()
    peak = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * peak)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["int8", "int4", "tiled"])
@pytest.mark.parametrize("K,N", [(4096, 11008), (11008, 4096)])
def test_f32_route_error_against_f64(kernel, K, N):
    """R = 64 at the 7B MLP shapes: within 1e-4 of the largest |output| of
    an f64 product (the tensor cores' f32 summation is the only error)."""
    _need_cuda()
    bits = 8 if kernel == "int8" else 4
    x, q, scale = (torch.from_numpy(a).cuda() for a in _inputs(64, K, N, bits, K + N))
    call, _, _ = _route(kernel, x, q, scale)
    w = q if bits == 8 else qmm.unpack_int4(q)
    want = (x.double() @ w.double()) * scale.double()
    err = (call().double() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()
