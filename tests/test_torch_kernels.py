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
from sequoia_torch.kernels.tree_attention import tree_attention  # noqa: E402

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

