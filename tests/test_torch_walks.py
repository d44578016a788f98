"""The port's three other accept walks (`walk="path"`, `"unrolled"`,
`"staged"`) against the JAX package's, and against the port's node walk.

JAX and torch random streams never match, so both sides get the same numpy
noise (`r`, the nucleus cut, the verification distribution) and must take
the same decisions; the walks' losslessness is checked by Monte Carlo on
the port's own draws, in the manner of tests/test_lossless.py, with each
trial a slice of one `torch.func.vmap` batch."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.ops import sampling as js  # noqa: E402
from sequoia_tpu.trees import accept as ja  # noqa: E402
from sequoia_torch.cli.testbed import load_growmap  # noqa: E402
from sequoia_torch.core.config import get_config  # noqa: E402
from sequoia_torch.core.init import random_params  # noqa: E402
from sequoia_torch.engine.engine import WALKS, SpecEngine  # noqa: E402
from sequoia_torch.ops import sampling as ts  # noqa: E402
from sequoia_torch.trees import accept as ta  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402
from test_torch_walk import _random_tree  # noqa: E402

CFG = get_config("test-tiny")
PROMPT = np.array([11, 23, 5, 99, 42, 7])
VOCAB = 16


def _walk_inputs(seed):
    """A random tree whose tokens are the draft's top ranks (long accepted
    paths), target rows near the draft's, a stop token on one node."""
    rng = np.random.default_rng(seed)
    size, vocab = 24, 40
    succ, max_depth = _random_tree(rng, size)
    dl = rng.normal(size=(size, vocab)).astype(np.float32) * 2
    tl = (dl + rng.normal(size=(size, vocab)) * 0.5).astype(np.float32)
    tokens = np.zeros(size, np.int32)
    for i in range(size):
        for c in succ[i][succ[i] >= 0]:
            tokens[c] = int(np.argsort(-dl[i])[list(succ[i]).index(c)])
    r = rng.random(size).astype(np.float32)
    stop = (int(tokens[1 + seed % (size - 1)]),)
    return succ, max(max_depth, 1), tl, dl, tokens, r, stop


def _assert_same_walk(t, j, p_final=None):
    np.testing.assert_array_equal(t.path.numpy(), np.asarray(j.path))
    assert int(t.accept_count) == int(j.accept_count)
    assert int(t.final_node) == int(j.final_node)
    assert bool(t.terminal) == bool(j.terminal)
    if p_final is not None and not bool(j.terminal):
        # rtol 1e-5: a residual row renormalized up to max_branch times in
        # f32, summed in another order on each side.
        np.testing.assert_allclose(t.p_final_row.numpy(), p_final, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strict,mask", [(True, True), (False, False)],
                         ids=["sequoia", "specinfer"])
@pytest.mark.parametrize("walk", ["path", "unrolled"])
def test_path_walks_same_decisions(walk, seed, strict, mask):
    """`path`, `accept_count`, `final_node`, `terminal` identical to the JAX
    walk of the same name on the same noise; `p_final_row` allclose."""
    succ, md, tl, dl, tokens, r, stop = _walk_inputs(seed)
    T = 0.8
    cut = np.array(js.nucleus_cutoff(jnp.asarray(tl), 0.9, T))
    jfn = {"path": ja.stochastic_path_walk, "unrolled": ja.stochastic_path_walk_unrolled}[walk]
    j = jfn(jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(tokens), jnp.asarray(r), succ, T,
            jnp.asarray(cut), stop, md, strict=strict, mask_rejected_draft=mask)
    args = (torch.as_tensor(tl), torch.as_tensor(dl), torch.as_tensor(tokens).long(),
            torch.as_tensor(r), torch.as_tensor(succ).long(), T, torch.as_tensor(cut),
            torch.as_tensor(stop).long(), md, strict, mask)
    if walk == "path":
        t = ta.stochastic_path_walk(*args, trips=ta.edge_trips(succ, md))
    else:
        t = ta.stochastic_path_walk_unrolled(*args)
    _assert_same_walk(t, j, np.asarray(j.p_final_row))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strict,mask", [(True, True), (False, False)],
                         ids=["sequoia", "specinfer"])
def test_staged_walk_same_decisions(seed, strict, mask):
    """The staged pipeline (decisions for every parent, `resolve_path`,
    `node_residual` at the final node) on the same verification
    distribution p: `accepted_child` and the path identical to JAX's, the
    bonus distribution allclose; and the same path as the port's node walk
    (the walks' decisions agree)."""
    succ, md, tl, dl, tokens, r, stop = _walk_inputs(seed)
    T = 0.8
    p = np.array(js.target_probs(jnp.asarray(tl), 0.9, T))

    @jax.jit
    def staged(p, dl, tokens, r):
        acc = ja.stochastic_accept_decisions(p, dl, tokens, r, succ, T, strict=strict,
                                             mask_rejected_draft=mask)
        path = ja.resolve_path(acc, tokens, stop, md)
        children = jnp.asarray(succ)[path.final_node]
        valid = children >= 0
        res = ja.node_residual(p[path.final_node], js.draft_probs(dl[path.final_node], T),
                               tokens[jnp.where(valid, children, 0)], valid,
                               mask_rejected_draft=mask)
        return acc, path, res

    j_acc, jp, j_res = staged(jnp.asarray(p), jnp.asarray(dl), jnp.asarray(tokens),
                              jnp.asarray(r))

    tok_t = torch.as_tensor(tokens).long()
    t_acc = ta.stochastic_accept_decisions(
        torch.as_tensor(p), torch.as_tensor(dl), tok_t, torch.as_tensor(r),
        ta.staged_plan(succ, "cpu"), T, strict=strict, mask_rejected_draft=mask)
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    stop_t = torch.as_tensor(stop).long()
    tp = ta.resolve_path(t_acc, tok_t, stop_t, md)
    succ_t = torch.as_tensor(succ).long()
    children = ta.at_index(succ_t, tp.final_node)
    t_res = ta.node_residual(ta.at_index(torch.as_tensor(p), tp.final_node),
                             ts.draft_probs(ta.at_index(torch.as_tensor(dl), tp.final_node), T),
                             tok_t[children.clamp_min(0)], children >= 0, mask)
    _assert_same_walk(tp._replace(), jp)
    if not bool(jp.terminal):
        np.testing.assert_allclose(t_res.numpy(), np.asarray(j_res), rtol=1e-5, atol=1e-7)

    cut = ts.nucleus_cutoff(torch.as_tensor(tl), 0.9, T)
    node = ta.stochastic_path_walk_node(
        torch.as_tensor(tl), torch.as_tensor(dl), tok_t, torch.as_tensor(r), succ_t, T, cut,
        stop_t, md, strict, mask, ranks=ta.ranks_per_trip(succ, md + 1))
    np.testing.assert_array_equal(node.path.numpy(), tp.path.numpy())


def test_staged_plan_row_sets():
    """Parents sorted by child count (stable), rank-j children of the first
    n_j of them, n_j non-increasing: JAX's static prefixes."""
    succ, _ = _random_tree(np.random.default_rng(5), 30)
    plan = ta.staged_plan(succ, "cpu")
    counts = (succ >= 0).sum(axis=1)
    parents = plan.parents.numpy()
    assert sorted(parents.tolist()) == np.nonzero(counts)[0].tolist()
    assert (np.diff(counts[parents]) <= 0).all()
    n_js = [c.numel() for c in plan.rank_children]
    assert n_js == [int((counts > j).sum()) for j in range(counts.max())]
    for j, c in enumerate(plan.rank_children):
        np.testing.assert_array_equal(c.numpy(), succ[parents[:n_js[j]], j])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return (random_params(CFG, 7, dtype=torch.float32, device="cpu"),
            random_params(CFG, 8, dtype=torch.float32, device="cpu"))


def _engine(models, algo, walk, gm, **kw):
    d, t = models
    kw = {"max_length": 128, "prefill_chunk": 16, "temperature": 0.7, "top_p": 0.9, **kw}
    return SpecEngine(d, CFG, t, CFG, gm, algorithm=algo, walk=walk, device="cpu", **kw)


@pytest.mark.parametrize("algo,gm", [("sequoia", "planned"), ("specinfer", "tree:3x2")])
def test_engine_walks_emit_the_same_tokens(models, algo, gm):
    """JAX holds its four walks to identical token sequences for one seed
    (tests/test_path_walk.py); the port's must agree the same way, in the
    eager loop and in the device loop."""
    grow = uniform_tree(3, 2) if gm == "tree:3x2" else load_growmap(gm)
    outs = {}
    for walk in WALKS:
        eng = _engine(models, algo, walk, grow)
        outs[walk] = eng.generate_fast(PROMPT, max_new_tokens=24, seed=3)
        if walk != "node":
            np.testing.assert_array_equal(outs[walk], outs["node"], err_msg=walk)
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=24, seed=3), outs["node"])


def test_engine_rejects_an_unknown_walk(models):
    with pytest.raises(ValueError, match="unknown walk"):
        _engine(models, "sequoia", "sparse", uniform_tree(2, 2))


class _NoHostReads(TorchDispatchMode):
    """Raises on `aten._local_scalar_dense` (`.item()`, `bool(t)`, an index
    by a 0-d tensor): a host read, which inside a capture aborts it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a host read inside the device loop")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("algo", ["sequoia", "specinfer"])
@pytest.mark.parametrize("walk", ["path", "unrolled", "staged"])
def test_walk_iteration_and_block_read_nothing_back(models, walk, algo):
    """One iteration, and a block of two predicated iterations, read nothing
    back to the host (a 3-level tree of branch 3: every code path of the
    walks at a fraction of the planned tree's trips)."""
    eng = _engine(models, algo, walk, uniform_tree(3, 3), max_length=96)
    state = eng.prefill(PROMPT, seed=0)
    with _NoHostReads():
        eng.iterate(state)
    eng._arm(40)
    with _NoHostReads():
        eng._block(state, 2)
    assert int(eng._steps) == 2


def test_depth2_second_token_marginal_equals_target():
    """tests/test_lossless.py:88 for the port's staged walk: root with k1
    WOR children, each with k2 WOR grandchildren, target p0 at the root and
    p1 at every child. Conditioned on a child being accepted, the second
    emitted token (the accepted grandchild, else the bonus from
    `node_residual` replayed at the interior node) is distributed as p1.
    Each bin within 5 binomial sigma + 1e-3, as JAX's."""
    rng = np.random.default_rng(3)
    T, k1, k2 = 0.8, 3, 2
    size = 1 + k1 + k1 * k2
    p0 = rng.dirichlet(np.ones(VOCAB) * 0.7).astype(np.float32)
    p1 = rng.dirichlet(np.ones(VOCAB) * 0.9).astype(np.float32)
    q0 = torch.as_tensor((rng.normal(size=VOCAB) * 1.5).astype(np.float32))
    q1 = torch.as_tensor((rng.normal(size=VOCAB) * 1.5).astype(np.float32))
    succ = np.full((size, max(k1, k2)), -1, np.int64)
    succ[0, :k1] = np.arange(1, 1 + k1)
    for j in range(k1):
        succ[1 + j, :k2] = 1 + k1 + k2 * j + np.arange(k2)
    p = torch.full((size, VOCAB), 1.0 / VOCAB)
    p[0], p[1:1 + k1] = torch.as_tensor(p0), torch.as_tensor(p1)
    dl = torch.zeros(size, VOCAB)
    dl[0], dl[1:1 + k1] = q0, q1
    succ_t, plan, stop = torch.as_tensor(succ), ta.staged_plan(succ, "cpu"), torch.tensor([255])

    N = 120000
    gen = torch.Generator().manual_seed(11)
    children = ts.sample_without_replacement(gen, q0.expand(N, VOCAB), T, k1)     # [N, k1]
    grand = ts.sample_without_replacement(gen, q1.expand(N * k1, VOCAB), T, k2)  # [N*k1, k2]
    tokens = torch.cat([torch.zeros(N, 1, dtype=torch.long), children,
                        grand.reshape(N, k1 * k2)], dim=1)
    r = torch.rand(N, size, generator=gen)

    def one(tok, rr):
        acc = ta.stochastic_accept_decisions(p, dl, tok, rr, plan, T, strict=True,
                                             mask_rejected_draft=True)
        path = ta.resolve_path(acc, tok, stop, 2)
        fn = path.final_node
        kids = ta.at_index(succ_t, fn)
        res = ta.node_residual(ta.at_index(p, fn), ts.draft_probs(ta.at_index(dl, fn), T),
                               tok[kids.clamp_min(0)], kids >= 0, mask_rejected_draft=True)
        return path.accept_count, path.path, res

    counts, paths, res = torch.func.vmap(one)(tokens, r)
    bonus = ts.sample_categorical_probs(gen, res)
    second = tokens.gather(1, paths[:, 1:2].clamp_min(0))[:, 0]
    tok2 = torch.where(counts >= 2, second, bonus).numpy()
    counts = counts.numpy()
    sel = counts >= 1
    n_cond = int(sel.sum())
    assert n_cond > N // 4
    assert (counts[sel] >= 2).sum() > 1000, "deep-descent branch unexercised"
    assert (counts[sel] == 1).sum() > 1000, "interior-residual branch unexercised"
    freq = np.bincount(tok2[sel], minlength=VOCAB) / n_cond
    std = np.sqrt(p1 * (1 - p1) / n_cond)
    err = np.abs(freq - p1)
    assert (err < 5 * std + 1e-3).all(), f"max err {err.max():.4f}"


def test_sequoia_beats_specinfer_acceptance():
    """tests/test_lossless.py:181 for the port's path walk: with one budget
    (a depth-1 star of 4), without-replacement growth and draft masking
    accept at least as often as i.i.d. growth (SpecInfer), less 0.01."""
    rng = np.random.default_rng(1)
    T, k, N = 1.0, 4, 20000
    p_root = rng.dirichlet(np.ones(VOCAB)).astype(np.float32)
    draft = torch.as_tensor((rng.normal(size=VOCAB) * 2.0).astype(np.float32))
    size = k + 1
    succ = np.full((size, k), -1, np.int64)
    succ[0] = np.arange(1, size)
    tl = torch.zeros(size, VOCAB)
    tl[0] = T * torch.log(torch.as_tensor(p_root))   # softmax(tl / T) = p_root
    dl = torch.zeros(size, VOCAB)
    dl[0] = draft
    succ_t, stop, cut = torch.as_tensor(succ), torch.tensor([255]), torch.zeros(size)
    gen = torch.Generator().manual_seed(7)

    def rate(strict, mask):
        grow = ts.sample_without_replacement if mask else ts.sample_with_replacement
        children = grow(gen, draft.expand(N, VOCAB), T, k)
        tokens = torch.cat([torch.zeros(N, 1, dtype=torch.long), children], dim=1)
        r = torch.rand(N, size, generator=gen)

        def one(tok, rr):
            return ta.stochastic_path_walk(tl, dl, tok, rr, succ_t, T, cut, stop, 1, strict,
                                           mask, trips=ta.edge_trips(succ, 1)).accept_count

        return float((torch.func.vmap(one)(tokens, r) > 0).float().mean())

    seq, si = rate(True, True), rate(False, False)
    assert seq >= si - 0.01, (seq, si)
    assert seq > 0.3
