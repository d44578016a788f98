"""The last grow level runs no draft forward, and `_finalize`'s re-draft
writes the accepted path's draft K/V (`engine/engine.py`), on the CPU in
f32 at test-tiny size:

- after every iteration the main draft cache below the committed length,
  and the root logits, equal one causal draft forward over the whole
  committed sequence; a no-op iteration leaves them bit for bit;
- no walk reads a leaf's draft logits: noise in those rows leaves every
  walk's path, count, final node and bonus row bit for bit;
- `_grow` runs a draft forward on each level but the last, and the
  `draft_forwards` counter counts each draft forward of an iteration.
"""

import numpy as np
import pytest
import torch

from sequoia_torch import trace
from sequoia_torch.cli.testbed import load_growmap
from sequoia_torch.core.config import get_config
from sequoia_torch.core.init import random_params
from sequoia_torch.core.model import forward
from sequoia_torch.engine import engine as engine_mod
from sequoia_torch.engine.engine import WALKS, SpecEngine
from sequoia_torch.kvcache.cache import KVCache
from sequoia_torch.ops import masks
from sequoia_torch.trees.growmap import uniform_tree

CFG = get_config("test-tiny")
PROMPT = np.array([11, 23, 5, 99, 42, 7])
TREES = {
    "depth1": lambda: uniform_tree(1, 4),
    "depth2": lambda: uniform_tree(2, 3),
    "depth3": lambda: uniform_tree(3, 2),
    "planned": lambda: load_growmap("planned"),
}
# Draft forwards `_grow` runs: one a grow level but the last.
GROW_FORWARDS = {"depth1": 0, "depth2": 1, "depth3": 2, "planned": 4}


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
    draft = random_params(CFG, 7, dtype=torch.float32, device="cpu")
    target = random_params(CFG, 8, dtype=torch.float32, device="cpu")
    return draft, target


@pytest.fixture(scope="module")
def trees():
    return {name: make() for name, make in TREES.items()}


def _engine(models, gm, algorithm="sequoia", same_model=False, **kw):
    draft, target = models
    kw = {"max_length": 256, "prefill_chunk": 16, "temperature": 0.7, "top_p": 0.9, **kw}
    return SpecEngine(target if same_model else draft, CFG, target, CFG, gm,
                      algorithm=algorithm, device="cpu", **kw)


def _causal_draft(eng, tokens: torch.Tensor):
    """One write-mode draft forward over `tokens` from slot 0: (cache, logits)."""
    n = tokens.shape[0]
    kv = KVCache.init(CFG, eng.max_length, torch.float32, "cpu")
    logits, _ = forward(eng.draft_params, CFG, tokens, torch.arange(n), kv, 0,
                        masks.causal_mask(n, eng.max_length, 0, "cpu"))
    return kv, logits


@pytest.mark.parametrize("algorithm", ["greedy", "sequoia"])
@pytest.mark.parametrize("tree", list(TREES))
def test_draft_cache_equals_causal_forward(models, trees, tree, algorithm):
    """After every iteration the draft cache's committed rows and the root
    logits are those of one causal forward over the committed sequence."""
    eng = _engine(models, trees[tree], algorithm, same_model=True)
    state = eng.prefill(PROMPT, seed=3)
    emitted_any = False
    for _ in range(6):
        stats = eng.iterate(state)
        emitted_any |= int(stats.emitted) > 1
        gtl = int(state.gtl)
        kv, logits = _causal_draft(eng, state.tokens[:gtl])
        torch.testing.assert_close(state.draft_kv.k[:, :gtl], kv.k[:, :gtl],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(state.draft_kv.v[:, :gtl], kv.v[:, :gtl],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(state.root_draft_logits, logits[gtl - 1],
                                   rtol=1e-4, atol=1e-4)
        if bool(stats.terminal):
            break
    assert emitted_any   # an accepted node's K/V went through the re-draft


@pytest.mark.parametrize("tree", list(TREES))
def test_noop_iteration_keeps_committed_rows(models, trees, tree):
    """A predicated no-op iteration (budget spent) writes nothing below the
    committed length and keeps the root logits, bit for bit."""
    eng = _engine(models, trees[tree])
    state = eng.prefill(PROMPT, seed=5)
    eng.iterate(state)
    gtl = int(state.gtl)
    before = (state.draft_kv.k[:, :gtl].clone(), state.draft_kv.v[:, :gtl].clone(),
              state.target_kv.k[:, :gtl].clone(), state.target_kv.v[:, :gtl].clone(),
              state.tokens[:gtl].clone(), state.root_draft_logits.clone())
    eng._arm(0)
    tt, dl = eng._grow(state)
    stats = eng._finalize_counted(state, tt, dl, eng._verify(state, tt))
    assert int(stats.emitted) == 0 and int(state.gtl) == gtl
    after = (state.draft_kv.k[:, :gtl], state.draft_kv.v[:, :gtl],
             state.target_kv.k[:, :gtl], state.target_kv.v[:, :gtl],
             state.tokens[:gtl], state.root_draft_logits)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["sequoia", "specinfer"])
@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("tree", list(TREES))
def test_walk_ignores_leaf_logits(models, trees, tree, walk, algorithm):
    """Finite noise in the leaves' draft logits leaves the walk's path,
    accept count, final node and bonus row bit for bit, on draws that
    accept down to the leaves (draft = target) and on all-accepting ones."""
    eng = _engine(models, trees[tree], algorithm, same_model=True, walk=walk)
    succ = eng.growmap.successors_padded()
    leaves = torch.as_tensor(np.flatnonzero((succ >= 0).sum(axis=1) == 0))
    gen = torch.Generator().manual_seed(11)
    state = eng.prefill(PROMPT, seed=2)
    deepest = 0
    for _ in range(4):
        tt, dl = eng._grow(state)
        assert torch.equal(dl[eng._level_starts[-1]:], torch.zeros_like(
            dl[eng._level_starts[-1]:]))
        tl = eng._verify(state, tt)
        noisy = dl.clone()
        noisy[leaves] = 4.0 * torch.randn(len(leaves), eng.vocab, generator=gen)
        for r in (torch.rand(eng.tree_size, generator=gen), torch.zeros(eng.tree_size)):
            (path, res), (path2, res2) = (eng._walk(tt, dl, tl, r), eng._walk(tt, noisy, tl, r))
            for a, b in ((path.path, path2.path), (path.accept_count, path2.accept_count),
                         (path.final_node, path2.final_node), (res, res2)):
                assert torch.equal(a, b)
            deepest = max(deepest, int(path.accept_count))
        eng._finalize(state, tt, dl, tl, eng._always)
    assert deepest >= 1


@pytest.mark.parametrize("tree", list(TREES))
def test_grow_forwards(models, trees, tree, monkeypatch):
    """`_grow` runs one draft forward a grow level but the last; the
    engine's count of an iteration's draft forwards adds the re-draft."""
    eng = _engine(models, trees[tree])
    state = eng.prefill(PROMPT, seed=1)
    calls = []

    def counted(*args, **kw):
        calls.append(args[0] is eng.draft_params)
        return forward(*args, **kw)

    monkeypatch.setattr(engine_mod, "forward", counted)
    eng._grow(state)
    assert calls == [True] * GROW_FORWARDS[tree]
    assert eng._draft_forwards == GROW_FORWARDS[tree] + 1


@pytest.mark.parametrize("entry", ["generate", "generate_fast", "generate_benchmark"])
@pytest.mark.parametrize("tree", list(TREES))
def test_draft_forwards_counter(models, trees, tree, entry, monkeypatch):
    """Under `trace.enable()` the `draft_forwards` counter equals the
    iterations run (no-op ones of a block included) times the growmap's
    draft forwards, and the draft forwards the iterations launched."""
    eng = _engine(models, trees[tree])
    iterations, draft_calls = [0], [0]
    finalize, fwd = eng._finalize, engine_mod.forward

    def counted_finalize(*args, **kw):
        iterations[0] += 1
        return finalize(*args, **kw)

    def counted_forward(*args, **kw):
        draft_calls[0] += args[0] is eng.draft_params
        return fwd(*args, **kw)

    eng._finalize = counted_finalize
    monkeypatch.setattr(engine_mod, "forward", counted_forward)
    trace.reset()
    with trace.enable():
        getattr(eng, entry)(PROMPT, max_new_tokens=20, seed=4)
    prefill_calls = -(-len(PROMPT) // eng.prefill_chunk)
    assert iterations[0] > 0
    assert trace.counters()["draft_forwards"] == iterations[0] * (GROW_FORWARDS[tree] + 1)
    assert trace.counters()["draft_forwards"] == draft_calls[0] - prefill_calls
    trace.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depth1_grow_graph_launches_no_draft_layer(dtype):
    """On the card, a depth-1 tree's captured `grow` launches no counted
    kernel (no draft layer runs in it); `finalize` launches the re-draft's
    attention, one a draft layer, and the tokens equal the eager loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config("test-small")
    draft = random_params(cfg, 7, dtype=dtype, device="cuda")
    target = random_params(cfg, 8, dtype=dtype, device="cuda")
    eng = SpecEngine(draft, cfg, target, cfg, uniform_tree(1, 4), algorithm="sequoia",
                     max_length=128, temperature=0.7, top_p=0.9, prefill_chunk=16,
                     device="cuda")
    prompt = np.arange(5, 16)
    fast = eng.generate_fast(prompt, max_new_tokens=24, seed=3)
    report = eng.graph_report()
    print("grow launches", report["grow"]["launches"],
          "finalize launches", report["finalize"]["launches"])
    assert not any(report["grow"]["launches"].values())
    attention = sum(v for k, v in report["finalize"]["launches"].items()
                    if k.startswith("tree_attention"))
    assert attention == cfg.num_layers
    np.testing.assert_array_equal(fast, eng.generate(prompt, max_new_tokens=24, seed=3))
