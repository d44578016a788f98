"""The f32 route of tree attention: 3xTF32 on the TF32 tensor cores
(csrc/tree_attention.cu, tree_attention_f32_kernel).

On the CPU:
- A numpy error model of the scheme, independent of the port: each f32
  operand split into TF32 hi and lo, a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi,
  every tensor-core step (8 products) summed in f64 and truncated toward zero
  to f32, as Hopper's tensor cores sum f32. On 4096 dot products of N(0, 1)
  vectors of 128 dims, its worst error over sum |a b| is held under the
  analytic bound `DOT_BOUND`, and below 1xTF32's; the bound then predicts
  the attention's error.
- `split_tf32` of the port against the numpy split, bit for bit, on 10^5
  values from a seed and adversarial ones; hi and lo are TF32 values and
  reconstruct x to 2^-22 |x|.
- `tree_attention_f32_model`, the plain model of the kernel (its
  decomposition and arithmetic), against JAX's kernel in interpret mode for
  every cache format, splits 1, 2, 3 and 7, on the corner cases of
  tests/test_torch_kernels.py (quantized rows dequantized for JAX), and
  against an f64 version within the bound the error model predicts.

The card runs the kernel against its plain version in tests/test_torch_cuda.py
(`cuda`-marked) and in chip_smoke.py phase 3, where its error against the
f64 version is printed beside SDPA f32's.
"""

import numpy as np
import pytest
import torch

from sequoia_torch.kernels.tree_attention import (split_count, split_tf32,
                                                  tree_attention_f32_model, tree_attention_plain)
from test_torch_kernels import _bias, _quantized, _split_case

U = 2.0 ** -24          # f32's unit roundoff


def _tf32_np(x: np.ndarray, rna: bool = True) -> np.ndarray:
    """x (f32) to TF32: to nearest, ties away (rna), or by truncation."""
    u = x.astype(np.float32).view(np.uint32)
    if rna:
        u = u + np.uint32(0x1000)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split_np(x: np.ndarray, rna: bool = True):
    hi = _tf32_np(x, rna)
    return hi, _tf32_np((x - hi).astype(np.float32), rna)


def _rz_np(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _dots_np(a: np.ndarray, b: np.ndarray, scheme: str) -> np.ndarray:
    """Row-wise dot products of f32 a, b [N, D] by `scheme`:
    "3xtf32": the kernel's S (hi.hi, hi.lo, lo.hi in six truncating
    accumulators, even and odd 8-dim steps, added in f32);
    "3xtf32_trunc": the same with a truncating split;
    "3xtf32_one_acc": the three products in one truncating accumulator;
    "1xtf32": hi.hi alone; "f32": f32 FMAs in order (the CUDA cores)."""
    N, D = a.shape
    if scheme == "f32":
        acc = np.zeros(N, np.float32)
        for d in range(D):
            acc = (acc.astype(np.float64) + a[:, d].astype(np.float64) * b[:, d]).astype(np.float32)
        return acc
    ah, al = _split_np(a, scheme != "3xtf32_trunc")
    bh, bl = _split_np(b, scheme != "3xtf32_trunc")
    prods = {"hh": (ah, bh), "hl": (ah, bl), "lh": (al, bh)}
    if scheme == "1xtf32":
        prods = {"hh": prods["hh"]}
    acc = {}
    for kk in range(D // 8):
        d = slice(8 * kk, 8 * kk + 8)
        for name, (x, y) in prods.items():
            key = "one" if scheme == "3xtf32_one_acc" else (name, kk % 2)
            step = (x[:, d].astype(np.float64) * y[:, d]).sum(axis=1)
            acc[key] = _rz_np(acc.get(key, np.zeros(N, np.float32)) + step)
    if scheme != "3xtf32":
        return sum(acc.values(), np.zeros(N, np.float32))
    pair = {n: acc[n, 0] + acc[n, 1] for n in prods}
    return pair["hh"] + (pair["hl"] + pair["lh"])


# |dot - exact| / sum |a b| for the kernel's scheme at D <= 128: each
# product a.b keeps all but (the split of a, of b: 2^-22 each; the dropped
# a_lo.b_lo: 2^-22) 3 * 2^-22; each of the at most 8 truncating steps of a
# chain loses under 2 u of its sum, and the f32 additions of the six
# chains 5 u.
DOT_BOUND = 3 * 2.0 ** -22 + 8 * 2 * U + 5 * U


def _dot_errors(scheme: str, D: int = 128, N: int = 4096, seed: int = 11) -> float:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, D)).astype(np.float32)
    b = rng.standard_normal((N, D)).astype(np.float32)
    exact = (a.astype(np.float64) * b).sum(axis=1)
    mag = (np.abs(a.astype(np.float64)) * np.abs(b)).sum(axis=1)
    return float((np.abs(_dots_np(a, b, scheme) - exact) / mag).max())


def test_error_model_of_the_scheme():
    """At D = 128 the kernel's 3xTF32 dots stay under DOT_BOUND (a few f32
    roundoffs of sum |a b|), within 3x of f32 FMAs on the CUDA cores and far
    below 1xTF32; the truncating split and one shared accumulator are no
    better."""
    err = {s: _dot_errors(s) for s in ("3xtf32", "3xtf32_trunc", "3xtf32_one_acc", "1xtf32",
                                       "f32")}
    assert err["3xtf32"] <= DOT_BOUND
    assert err["3xtf32"] <= 3 * err["f32"]
    assert err["1xtf32"] > 100 * err["3xtf32"]
    assert err["3xtf32_trunc"] >= err["3xtf32"]
    assert err["3xtf32_one_acc"] >= err["3xtf32"]


def _values() -> np.ndarray:
    rng = np.random.default_rng(12)
    e = rng.integers(60, 195, size=100_000, dtype=np.uint32)   # |x| from 2^-67 to 2^67
    m = rng.integers(0, 1 << 23, size=100_000, dtype=np.uint32)
    s = rng.integers(0, 2, size=100_000, dtype=np.uint32)
    rand = ((s << 31) | (e << 23) | m).view(np.float32)
    # ties and near-ties of both roundings, all-ones mantissas, powers of 2
    lows = np.array([0x1000, 0x0FFF, 0x1001, 0x1FFF, 0x0800, 0x17FF, 0x7FFFFF, 0x0],
                    np.uint32)
    base = (rng.integers(100, 150, size=256, dtype=np.uint32) << 23) \
        | (rng.integers(0, 1 << 10, size=256, dtype=np.uint32) << 13)
    adv = (base[:, None] | lows[None, :]).ravel().view(np.float32)
    return np.concatenate([rand, adv, -adv, np.float32([0.0, -0.0, 1.0, 3.0])])


def test_split_tf32_matches_numpy_bit_for_bit():
    """The port's split (the kernel's bit operations) equals the numpy
    split bit for bit; hi and lo are TF32 (low 13 bits zero); x - hi is
    exact in f32; hi + lo keeps x to 2^-22 |x|."""
    x = _values()
    hi, lo = (t.numpy() for t in split_tf32(torch.from_numpy(x)))
    want_hi, want_lo = _split_np(x)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), want_lo.view(np.uint32))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal((x - hi).astype(np.float64), x64 - hi)
    assert (np.abs(x64 - hi - lo) <= 2.0 ** -22 * np.abs(x64)).all()


_JAX_CASES = {}


def _jax_reference(case, fmt, q, kd, vd, mask, sk, sv, smask, g, D):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from sequoia_tpu.kernels.tree_attention import tree_attention as jax_tree_attention

    if (case, fmt) not in _JAX_CASES:
        _JAX_CASES[case, fmt] = np.asarray(jax_tree_attention(
            jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), _bias(mask), jnp.asarray(sk),
            jnp.asarray(sv), _bias(smask), g=g, scale=D ** -0.5, block_m=32, interpret=True))
    return _JAX_CASES[case, fmt]


def _attention_bound(q, kd, vd, sk, sv, scale) -> float:
    """The output error the dot-product bound predicts: a score's error is
    at most DOT_BOUND * scale * sum |q k| (quantized: the ks scale is in kd),
    which moves each probability by that relative error (twice, through the
    sum), so the output by 2 * that * max |v|; P V adds DOT_BOUND * max |v|
    (the probabilities sum to 1); plus f32's roundoff of the softmax."""
    keys = np.concatenate([kd, sk])
    vals = np.concatenate([vd, sv])
    H, Hkv = q.shape[1], keys.shape[1]
    kv = np.repeat(np.abs(keys), H // Hkv, axis=1)
    smax = scale * np.einsum("qhd,khd->qhk", np.abs(q), kv).max()
    vmax = np.abs(vals).max()
    return (2 * DOT_BOUND * smax + DOT_BOUND) * vmax + 64 * U * vmax


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("case", ["prefix", "scratch_only", "dead_row", "random"])
def test_f32_model_matches_pallas_and_f64(case, fmt, splits):
    """The model of the f32 kernel against the JAX kernel (f32, interpret
    mode) within 1e-5: both are f32-accurate, about 1e-7 from the f64
    version here, and 1e-5 is the bf16 model's tolerance against JAX. Then
    against the f64 version within the bound the error model predicts. At
    splits 7 most runs get no key; at dead_row a tile walks everything."""
    q, k, v, mask, sk, sv, smask, g, D = _split_case(case)
    (kp, vp, ks, vs), (kd, vd) = _quantized(k, v, fmt)
    want = _jax_reference(case, fmt, q, kd, vd, mask, sk, sv, smask, g, D)
    t = torch.from_numpy
    got = tree_attention_f32_model(t(q), kp, vp, t(mask), t(sk), t(sv), t(smask),
                                   scale=D ** -0.5, ks=ks, vs=vs, splits=splits).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    d = lambda x: x.double() if x is not None and x.is_floating_point() else x  # noqa: E731
    f64 = tree_attention_plain(d(t(q)), d(kp), d(vp), t(mask), d(t(sk)), d(t(sv)), t(smask),
                               scale=D ** -0.5, ks=d(ks), vs=d(vs)).numpy()
    bound = _attention_bound(q, kd, vd, sk, sv, D ** -0.5)
    assert np.abs(got - f64).max() <= bound


@pytest.mark.parametrize("Q,H,M,S,want", [
    (64, 32, 256, 64, 1),     # 7B verify: 128 blocks, one wave
    (16, 32, 256, 16, 3),     # phase 7's w16: capped by 17 key tiles over 8 warps
    (1, 32, 256, 1, 3),       # 7B AR step
    (1, 32, 1024, 1, 4),      # a longer cache: 4 x 32 = 128 blocks
    (13, 12, 256, 64, 3),     # 68m widths: capped by 20 key tiles over 8 warps
    (1024, 32, 256, 0, 1),    # many waves of one split already
])
def test_split_count_f32_one_wave(Q, H, M, S, want):
    """The f32 kernel's split count: the most blocks per (query tile,
    head) that one wave of one block per SM holds, at least 1, at most one
    key tile per warp (8 warps a block)."""
    assert split_count(Q, H, M, S, sms=132, dtype=torch.float32) == want
