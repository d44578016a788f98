"""The port's sampling and accept walk against the JAX package.

JAX and torch random streams never match, so both sides get the same
numpy noise (gumbel rows, `r`, the nucleus cut) and must take the same
decisions; losslessness of the port's own sampling is checked by Monte
Carlo, in the manner of tests/test_lossless.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.ops import sampling as js  # noqa: E402
from sequoia_tpu.trees import accept as ja  # noqa: E402
from sequoia_torch.ops import sampling as ts  # noqa: E402
from sequoia_torch.trees import accept as ta  # noqa: E402


def _random_tree(rng, size):
    """Random topology (tests/test_path_walk.py): each node's parent drawn
    among earlier nodes. Returns (successors [size, max_branch], max_depth)."""
    parents = [-1] + [int(rng.integers(0, i)) for i in range(1, size)]
    children = [[] for _ in range(size)]
    depth = [0] * size
    for i in range(1, size):
        children[parents[i]].append(i)
        depth[i] = depth[parents[i]] + 1
    mb = max(1, max(len(c) for c in children))
    succ = np.full((size, mb), -1, np.int32)
    for i, ch in enumerate(children):
        succ[i, : len(ch)] = ch
    return succ, max(depth)


@pytest.mark.parametrize("vocab,k", [(1000, 4), (200, 3), (300, 1)])
def test_wor_from_gumbel_same_indices(vocab, k):
    rng = np.random.default_rng(vocab)
    logits = rng.normal(size=(6, vocab)).astype(np.float32) * 2
    g = rng.gumbel(size=(6, vocab)).astype(np.float32)
    want = np.asarray(js.wor_from_gumbel(jnp.asarray(logits), jnp.asarray(g), 0.7, k))
    got = ts.wor_from_gumbel(torch.as_tensor(logits), torch.as_tensor(g), 0.7, k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [0.8, 1.0])
def test_target_probs_and_cutoff_match(top_p):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(9, 300)).astype(np.float32) * 3
    np.testing.assert_allclose(
        ts.target_probs(torch.as_tensor(logits), top_p, 0.6).numpy(),
        np.asarray(js.target_probs(jnp.asarray(logits), top_p, 0.6)), rtol=1e-5, atol=1e-7)
    cut_t = ts.nucleus_cutoff(torch.as_tensor(logits), top_p, 0.6).numpy()
    cut_j = np.asarray(js.nucleus_cutoff(jnp.asarray(logits), top_p, 0.6))
    probs = np.array(jax.nn.softmax(jnp.asarray(logits) / 0.6, axis=-1))
    np.testing.assert_array_equal(probs >= cut_t[:, None], probs >= cut_j[:, None])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strict,mask", [(True, True), (False, False)],
                         ids=["sequoia", "specinfer"])
def test_node_walk_same_decisions(seed, strict, mask):
    rng = np.random.default_rng(seed)
    size, vocab, T = 24, 40, 0.8
    succ, max_depth = _random_tree(rng, size)
    # Peaked target rows next to their draft rows make long accepted paths.
    dl = rng.normal(size=(size, vocab)).astype(np.float32) * 2
    tl = (dl + rng.normal(size=(size, vocab)) * 0.5).astype(np.float32)
    tokens = np.zeros(size, np.int32)
    for i in range(size):
        for c in succ[i][succ[i] >= 0]:
            tokens[c] = int(np.argsort(-dl[i])[list(succ[i]).index(c)])
    r = rng.random(size).astype(np.float32)
    stop = (int(tokens[1 + seed % (size - 1)]),)
    cut = np.array(js.nucleus_cutoff(jnp.asarray(tl), 0.9, T))
    j = ja.stochastic_path_walk_node(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(tokens), jnp.asarray(r), succ, T,
        jnp.asarray(cut), stop, max(max_depth, 1), strict=strict, mask_rejected_draft=mask)
    t = ta.stochastic_path_walk_node(
        torch.as_tensor(tl), torch.as_tensor(dl), torch.as_tensor(tokens).long(),
        torch.as_tensor(r), torch.as_tensor(succ).long(), T, torch.as_tensor(cut),
        torch.as_tensor(stop).long(), max(max_depth, 1), strict=strict,
        mask_rejected_draft=mask, ranks=ta.ranks_per_trip(succ, max(max_depth, 1) + 1))
    np.testing.assert_array_equal(t.path.numpy(), np.asarray(j.path))
    assert int(t.accept_count) == int(j.accept_count)
    assert int(t.final_node) == int(j.final_node)
    assert bool(t.terminal) == bool(j.terminal)
    np.testing.assert_allclose(t.p_final_row.numpy(), np.asarray(j.p_final_row),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", range(3))
def test_token_match_and_resolve_path_exact(seed):
    rng = np.random.default_rng(seed + 100)
    size, vocab = 30, 6  # a small vocab makes matches and stop tokens common
    succ, max_depth = _random_tree(rng, size)
    tokens = rng.integers(0, vocab, size=size).astype(np.int32)
    target = rng.integers(0, vocab, size=size).astype(np.int32)
    j_acc = ja.token_match_accept(jnp.asarray(target), jnp.asarray(tokens), jnp.asarray(succ))
    t_acc = ta.token_match_accept(torch.as_tensor(target).long(), torch.as_tensor(tokens).long(),
                                  torch.as_tensor(succ).long())
    np.testing.assert_array_equal(t_acc.accepted_child.numpy(), np.asarray(j_acc.accepted_child))
    for stop in [(), (int(vocab - 1),)]:
        jp = ja.resolve_path(j_acc.accepted_child, jnp.asarray(tokens), stop, max(max_depth, 1))
        tp = ta.resolve_path(t_acc.accepted_child, torch.as_tensor(tokens).long(),
                             torch.as_tensor(stop, dtype=torch.long), max(max_depth, 1))
        np.testing.assert_array_equal(tp.path.numpy(), np.asarray(jp.path))
        assert int(tp.accept_count) == int(jp.accept_count)
        assert int(tp.final_node) == int(jp.final_node)
        assert bool(tp.terminal) == bool(jp.terminal)


VOCAB = 16


@pytest.mark.parametrize(
    "strict,mask_rejected,k_children",
    [(True, True, 1), (True, True, 4), (False, False, 3)],
    ids=["sequoia-k1", "sequoia-k4", "specinfer-k3"],
)
def test_emitted_marginal_equals_target(strict, mask_rejected, k_children):
    """Depth-1 star: grow k children (WOR for sequoia, i.i.d. for
    specinfer), walk, draw the bonus from the final residual; the emitted
    token must be distributed exactly as the target p."""
    rng = np.random.default_rng(0)
    T = 0.8
    p_root = rng.dirichlet(np.ones(VOCAB) * 0.7).astype(np.float32)
    draft_logits = (rng.normal(size=VOCAB) * 1.5).astype(np.float32)
    N, size = 60000, k_children + 1
    gen = torch.Generator().manual_seed(42)
    dl_rows = torch.as_tensor(draft_logits).expand(N, VOCAB)
    grow = ts.sample_without_replacement if mask_rejected else ts.sample_with_replacement
    children = grow(gen, dl_rows, T, k_children)                       # [N, k]
    tokens = torch.cat([torch.zeros(N, 1, dtype=torch.long), children], dim=1)
    succ = np.full((size, k_children), -1, np.int32)
    succ[0] = np.arange(1, size)
    # softmax(T * log p / T) = p, and a zero cut keeps every token.
    tl = torch.zeros(size, VOCAB)
    tl[0] = T * torch.log(torch.as_tensor(p_root))
    dl = torch.zeros(size, VOCAB)
    dl[0] = torch.as_tensor(draft_logits)
    r = torch.rand(N, size, generator=gen)

    succ_t, stop_t = torch.as_tensor(succ).long(), torch.tensor([255])
    ranks = ta.ranks_per_trip(succ, 2)

    def walk(tok, rr):
        res = ta.stochastic_path_walk_node(tl, dl, tok, rr, succ_t, T, torch.zeros(size),
                                           stop_t, 1, strict=strict,
                                           mask_rejected_draft=mask_rejected, ranks=ranks)
        return res.path, res.accept_count, res.p_final_row

    path, count, p_final = torch.func.vmap(walk)(tokens, r)
    bonus = ts.sample_categorical_probs(gen, p_final)
    accepted = tokens.gather(1, path.clamp_min(0))[:, 0]
    emitted = torch.where(count > 0, accepted, bonus).numpy()
    freq = np.bincount(emitted, minlength=VOCAB) / N
    std = np.sqrt(p_root * (1 - p_root) / N)
    err = np.abs(freq - p_root)
    assert (err < 5 * std + 1e-3).all(), f"max err {err.max():.4f}"
