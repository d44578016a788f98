"""The port's kernel modules against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in Pallas interpret mode, as tests/test_tree_attention.py and
tests/test_top_p_bisect.py run them. The CUDA kernels themselves are held
against the plain versions by tests/test_torch_cuda.py (on the card) and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.kernels.top_p import (  # noqa: E402
    top_p_threshold_from_logits as jax_from_logits,
    top_p_threshold_fused as jax_fused,
)
from sequoia_tpu.kernels.tree_attention import tree_attention as jax_tree_attention  # noqa: E402
from sequoia_torch.kernels import top_p as tp  # noqa: E402
from sequoia_torch.kernels.tree_attention import (  # noqa: E402
    split_count, tile_extents, tree_attention, tree_attention_plain, tree_attention_split_plain)
from sequoia_torch.kvcache.cache import (  # noqa: E402
    quantize_kv_rows, quantize_kv_rows4, unpack_kv_rows4)

NEG_INF = float("-inf")


def _mk(Q, M, S, Hkv, g, D, seed=0):
    """Inputs as tests/test_tree_attention.py makes them (numpy, f32)."""
    rng = np.random.default_rng(seed)
    H = Hkv * g
    q = rng.standard_normal((Q, H, D)).astype(np.float32)
    k = rng.standard_normal((M, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((M, Hkv, D)).astype(np.float32)
    sk = rng.standard_normal((S, Hkv, D)).astype(np.float32)
    sv = rng.standard_normal((S, Hkv, D)).astype(np.float32)
    mask = rng.random((Q, M)) < 0.7
    mask[:, 0] = True
    smask = np.tril(np.ones((Q, S), bool))[:, :S]
    return q, k, v, mask, sk, sv, smask


def _bias(mask):
    return jnp.where(jnp.asarray(mask), 0.0, NEG_INF).astype(jnp.float32)


def _port(q, k, v, mask, sk, sv, smask, D):
    t = torch.from_numpy
    out = tree_attention(t(q), t(k), t(v), t(mask), t(sk), t(sv), t(smask),
                         scale=D ** -0.5)
    return out.numpy()


def _jax_einsum(q, k, v, mask, sk, sv, smask, g, scale):
    """The XLA einsum attention of the JAX forward, over main ∪ scratch."""
    Q, H, D = q.shape
    Hkv = k.shape[1]
    qg = jnp.asarray(q).reshape(Q, Hkv, g, D)
    s = jnp.einsum("qhgd,mhd->hgqm", qg, jnp.asarray(k)) * scale + _bias(mask)
    ss = jnp.einsum("qhgd,shd->hgqs", qg, jnp.asarray(sk)) * scale + _bias(smask)
    M = s.shape[-1]
    full = jax.nn.softmax(jnp.concatenate([s, ss], axis=-1), axis=-1)
    attn = jnp.einsum("hgqm,mhd->qhgd", full[..., :M], jnp.asarray(v)) + jnp.einsum(
        "hgqs,shd->qhgd", full[..., M:], jnp.asarray(sv))
    return np.asarray(attn.reshape(Q, H, D))


@pytest.mark.parametrize(
    "Q,M,S,Hkv,g,block_m",
    [
        (16, 64, 16, 4, 1, 32),     # MHA, multiple main blocks
        (8, 32, 8, 2, 4, 32),       # GQA g=4
        (13, 48, 11, 3, 1, 32),     # ragged sizes
        (24, 40, 24, 2, 2, 64),     # block_m > M
    ],
)
def test_tree_attention_matches_pallas(Q, M, S, Hkv, g, block_m):
    D = 16
    q, k, v, mask, sk, sv, smask = _mk(Q, M, S, Hkv, g, D)
    want = jax_tree_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _bias(mask), jnp.asarray(sk),
        jnp.asarray(sv), _bias(smask), g=g, scale=D ** -0.5, block_m=block_m,
        interpret=True)
    got = _port(q, k, v, mask, sk, sv, smask, D)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_tree_attention_fully_masked_main_region():
    """Rows that attend only inside the scratch give the scratch softmax,
    no NaN from the masked main region."""
    Q, M, S, Hkv, g, D = 8, 64, 8, 2, 1, 16
    q, k, v, mask, sk, sv, smask = _mk(Q, M, S, Hkv, g, D, seed=3)
    mask = np.zeros_like(mask)
    want = jax_tree_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _bias(mask), jnp.asarray(sk),
        jnp.asarray(sv), _bias(smask), g=g, scale=D ** -0.5, block_m=32,
        interpret=True)
    got = _port(q, k, v, mask, sk, sv, smask, D)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Q,M,Hkv,g", [(16, 64, 2, 2), (1, 48, 4, 1)])
def test_tree_attention_empty_scratch_matches_einsum(Q, M, Hkv, g):
    """Write mode (prefill, re-draft) passes S = 0."""
    D = 16
    q, k, v, mask, sk, sv, smask = _mk(Q, M, 0, Hkv, g, D, seed=5)
    mask = np.tril(np.ones((Q, M), bool), k=M - Q)  # causal, window at the end
    want = _jax_einsum(q, k, v, mask, sk, sv, smask, g, D ** -0.5)
    got = _port(q, k, v, mask, sk, sv, smask, D)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _split_case(case):
    """Masks of the bf16 kernel's corner cases (Q = 20: a full and a ragged
    16-query tile; M = 64, S = 16, so the JAX kernel pads no key)."""
    Q, M, S, Hkv, g, D = 20, 64, 16, 2, 2, 16
    q, k, v, mask, sk, sv, smask = _mk(Q, M, S, Hkv, g, D, seed=7)
    prefix = np.broadcast_to(np.arange(M) < 37, (Q, M)).copy()   # ends mid-tile, dead tail
    smask = np.tril(np.ones((Q, S), bool), k=-4)[:, :S]          # rows 0-3: no scratch key
    if case == "prefix":
        mask = prefix
    elif case == "scratch_only":      # the first tile's rows attend only scratch keys
        mask = prefix
        mask[:16] = False
        smask[:16, 0] = True
    elif case == "dead_row":          # row 5 attends nothing: its tile walks everything
        mask = prefix
        mask[5] = False
        smask[5] = False
    return q, k, v, mask, sk, sv, smask, g, D


def _quantized(k, v, fmt):
    """(k, v, ks, vs) of the port for `fmt`, and the f32 rows they stand for."""
    if fmt == "float":
        return (torch.from_numpy(k), torch.from_numpy(v), None, None), (k, v)
    quant = quantize_kv_rows if fmt == "int8" else (
        lambda x: quantize_kv_rows4(x, packing=fmt[5:]))
    ints = (lambda x: x) if fmt == "int8" else (lambda x: unpack_kv_rows4(x, packing=fmt[5:]))
    (kq, ks), (vq, vs) = quant(torch.from_numpy(k)), quant(torch.from_numpy(v))
    deq = [(ints(x).float() * s[..., None]).numpy() for x, s in ((kq, ks), (vq, vs))]
    return (kq, vq, ks, vs), deq


_JAX_SPLIT_CASES = {}


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("case", ["prefix", "scratch_only", "dead_row", "random"])
def test_tree_attention_split_model_matches_pallas(case, fmt, splits):
    """The model of the bf16 kernel's decomposition (prefix skip, key runs
    over `splits` blocks of 4 warps, merges) against the JAX kernel in f32
    within 1e-5 (the quantized rows dequantized for JAX), and against the
    plain version in bf16 within 2e-2. At splits 7 most runs get no key."""
    q, k, v, mask, sk, sv, smask, g, D = _split_case(case)
    (kp, vp, ks, vs), (kd, vd) = _quantized(k, v, fmt)
    key = (case, fmt)
    if key not in _JAX_SPLIT_CASES:
        _JAX_SPLIT_CASES[key] = np.asarray(jax_tree_attention(
            jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), _bias(mask), jnp.asarray(sk),
            jnp.asarray(sv), _bias(smask), g=g, scale=D ** -0.5, block_m=32, interpret=True))
    t = torch.from_numpy
    args = (t(q), kp, vp, t(mask), t(sk), t(sv), t(smask))
    got = tree_attention_split_plain(*args, scale=D ** -0.5, ks=ks, vs=vs, splits=splits)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), _JAX_SPLIT_CASES[key], rtol=1e-5, atol=1e-5)

    bf = lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x  # noqa: E731
    args = (bf(t(q)), bf(kp), bf(vp), t(mask), bf(t(sk)), bf(t(sv)), t(smask))
    got = tree_attention_split_plain(*args, scale=D ** -0.5, ks=ks, vs=vs, splits=splits)
    want = tree_attention_plain(*args, scale=D ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case,want", [
    ("prefix", [[37, 12], [37, 16]]),
    ("scratch_only", [[0, 12], [37, 16]]),
    ("dead_row", [[64, 16], [37, 16]]),
])
def test_tile_extents_follow_the_mask(case, want):
    """Per 16-query tile: one past the last attended key of each region, or
    both regions whole when a row of the tile attends nothing."""
    _, _, _, mask, _, _, smask, _, _ = _split_case(case)
    assert tile_extents(torch.from_numpy(mask), torch.from_numpy(smask)).tolist() == want


@pytest.mark.parametrize("Q,H,M,S,want", [
    (64, 32, 256, 64, 3),     # 7B verify: 4 query tiles x 32 heads x 3 = 384 blocks
    (1, 32, 256, 1, 5),       # 7B AR step: capped by 17 key tiles over 4 warps
    (128, 32, 256, 0, 2),     # 7B prefill
    (13, 12, 256, 64, 5),     # 68m grow level
    (1024, 32, 256, 0, 1),    # enough query tiles alone
])
def test_split_count_fills_an_h100(Q, H, M, S, want):
    assert split_count(Q, H, M, S, sms=132) == want


def _rows(seed, rows, vocab):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, vocab)) * 3).astype(np.float32)


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
def test_top_p_from_logits_matches_pallas(top_p):
    T = 0.6
    for seed in range(5):
        logits = _rows(seed, 16, 1000)
        want = np.asarray(jax_from_logits(jnp.asarray(logits), top_p, T, interpret=True))
        got = tp.top_p_threshold_from_logits(torch.from_numpy(logits), top_p, T).numpy()
        probs = np.array(jax.nn.softmax(jnp.asarray(logits) / T, axis=-1))
        np.testing.assert_array_equal(probs >= got[:, None], probs >= want[:, None])
        assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
def test_top_p_fused_matches_pallas(top_p):
    for seed, (rows, vocab) in enumerate([(1, 500), (7, 1000), (16, 384), (13, 130)]):
        probs = np.array(jax.nn.softmax(jnp.asarray(_rows(seed + 10, rows, vocab)), axis=-1))
        want = np.asarray(jax_fused(jnp.asarray(probs), top_p, interpret=True))
        got = tp.top_p_threshold_fused(torch.from_numpy(probs), top_p).numpy()
        np.testing.assert_array_equal(probs >= got[:, None], probs >= want[:, None])
        assert np.abs(got - want).max() <= 1e-6
        assert ((probs >= got[:, None]).sum(-1) >= 1).all()

