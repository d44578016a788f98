"""The port's measure -> plan loop against the JAX package's: acceptance
measurement (`planner/acceptance.py`), the native planner DP
(`native/planner_dp.cpp` through `planner/dp.py`), and the `accept` and
`tree_search` CLIs, on the CPU at test-tiny size with JAX's f32 weights
carried across.

A greedy dynamic vector is deterministic and must equal JAX's exactly. A
static vector draws tokens, and the two packages' random streams differ,
so it is held to the exact expectation of its rank-1 entry and to JAX's
within a bound computed from the per-position variance."""

import json
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.cli import tree_search as jax_tree_search  # noqa: E402
from sequoia_tpu.core.config import get_config as jax_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.planner import acceptance as jacc  # noqa: E402
from sequoia_tpu.planner import dp as jdp  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.cli import accept, tree_search  # noqa: E402
from sequoia_torch.core.config import get_config  # noqa: E402
from sequoia_torch.core.init import export_hf_checkpoint, params_from_numpy  # noqa: E402
from sequoia_torch.core.model import forward  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.native import planner_dp_lib  # noqa: E402
from sequoia_torch.ops import masks  # noqa: E402
from sequoia_torch.ops.sampling import top_p_filter  # noqa: E402
from sequoia_torch.planner import acceptance as tacc  # noqa: E402
from sequoia_torch.planner import dp as tdp  # noqa: E402
from sequoia_torch.trees.growmap import GrowMap, uniform_tree  # noqa: E402

CFG_J, CFG = jax_config("test-tiny"), get_config("test-tiny")


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
    jd = jax_random_params(CFG_J, jax.random.PRNGKey(1), dtype=jnp.float32)
    jt = jax_random_params(CFG_J, jax.random.PRNGKey(2), dtype=jnp.float32)
    to_port = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    return jd, jt, to_port(jd), to_port(jt)


def _rand_vector(rng, k):
    raw = np.sort(rng.uniform(0.0, 1.0, size=k))[::-1]
    return np.concatenate([[0.0], raw / (raw.sum() * rng.uniform(1.0, 2.0))])


@pytest.fixture(scope="module")
def native():
    if planner_dp_lib() is None:
        pytest.skip("no g++ to build the native planner DP")


@pytest.mark.parametrize("p", ["seed0", "seed1", "zero-tail"])
def test_native_table_bit_identical_to_numpy_and_jax(native, p):
    """The zero tail drives the `0 * -inf = nan` infeasibility path."""
    p = (np.array([0.0, 0.7, 0.2, 0.0, 0.0]) if p == "zero-tail"
         else _rand_vector(np.random.default_rng(int(p[-1])), 8))
    tn = tdp.fill_table(p, max_budget=24, max_depth=7, backend="native")
    for ref in (tdp.fill_table(p, max_budget=24, max_depth=7, backend="numpy"),
                jdp.fill_table(p, max_budget=24, max_depth=7, backend="numpy")):
        np.testing.assert_array_equal(tn.T, ref.T)
        np.testing.assert_array_equal(tn.Y, ref.Y)


def test_native_plan_same_growmap_as_jax(native):
    p = _rand_vector(np.random.default_rng(7), 6)
    budgets, times = [1, 2, 4, 8, 16, 32], [1.0, 1.0, 1.02, 1.06, 1.15, 1.3]
    gm, info = tdp.plan(p, budgets, times, 0.05, max_depth=6, backend="native")
    jgm, jinfo = jdp.plan(p, budgets, times, 0.05, max_depth=6, backend="numpy")
    assert gm.successors == jgm.successors and gm.roots == jgm.roots
    np.testing.assert_array_equal(gm.depth, jgm.depth)
    assert info == jinfo
    with pytest.raises(ValueError, match="backend"):
        tdp.fill_table(p, 4, 3, backend="cuda")


def test_calibrate_vector_equals_jax():
    vec = np.array([0.0, 0.6, 0.2, 0.08, 0.03])
    for e in (2.0, 2.6):
        got, s = tacc.calibrate_vector(vec, uniform_tree(3, 2), e)
        want, s_j = jacc.calibrate_vector(vec, jax_uniform_tree(3, 2), e)
        np.testing.assert_array_equal(got, want)
        assert s == s_j
    with pytest.warns(UserWarning, match="outside the bracket"):
        tacc.calibrate_vector(vec, uniform_tree(3, 2), 50.0)


def _logits(params, seq):
    T = len(seq)
    out, _ = forward(params, CFG, torch.as_tensor(seq), torch.arange(T),
                     KVCache.init(CFG, T, torch.float32, "cpu"), 0,
                     masks.causal_mask(T, T, 0, "cpu"))
    return out


def test_static_acceptance_agrees_with_its_expectation_and_jax(models):
    """Rank 1's expectation is exact: E[min(1, p_t/q_t)], t ~ q, is
    sum_t min(p_t, q_t) at each position. Both packages' rank-1 entries lie
    within 5 sigma of it (sigma from the per-position variances); every
    rank of the port lies within 5 sigma of JAX's, sigma bounded by the
    rates' range [0, 1] (std <= 0.5 a position, two independent runs)."""
    jd, jt, td, tt = models
    rng = np.random.default_rng(1)
    seqs = [rng.integers(3, CFG.vocab_size, 128) for _ in range(8)]
    kw = dict(k=4, temperature=0.8, top_p=0.95, draft_top_p=0.99)
    got = tacc.static_acceptance(td, CFG, tt, CFG, seqs, seed=3, **kw)
    want = jacc.static_acceptance(jd, CFG_J, jt, CFG_J, seqs, seed=3, **kw)
    assert got[0] == 0.0 and got.sum() <= 1.0 + 1e-6 and (got >= 0).all()

    means, variances = [], []
    for seq in seqs:
        p = torch.softmax(top_p_filter(_logits(tt, seq), 0.95, 0.8) / 0.8, dim=-1).double()
        q = torch.softmax(top_p_filter(_logits(td, seq), 0.99, 0.8) / 0.8, dim=-1).double()
        ratio = torch.clamp_max(p / q.clamp_min(1e-30), 1.0)
        mean = (q * ratio).sum(-1)
        means.append(mean)
        variances.append((q * ratio ** 2).sum(-1) - mean ** 2)
    n = sum(len(s) for s in seqs)
    exact = float(torch.cat(means).mean())
    sigma = float(torch.cat(variances).sum().sqrt()) / n
    assert abs(got[1] - exact) < 5 * sigma, (got[1], exact, sigma)
    assert abs(want[1] - exact) < 5 * sigma, (want[1], exact, sigma)
    np.testing.assert_allclose(got, want, rtol=0, atol=5 * np.sqrt(2) * 0.5 / np.sqrt(n))


def test_identical_models_accept_rank1_always(models):
    """JAX's tests/test_acceptance.py for the port: a model against itself
    accepts its rank-1 child (statically: all mass; dynamically: > 0.95)."""
    _, _, td, _ = models
    rng = np.random.default_rng(0)
    seqs = [rng.integers(3, CFG.vocab_size, 48) for _ in range(2)]
    vec = tacc.static_acceptance(td, CFG, td, CFG, seqs, k=4, temperature=0.8, top_p=1.0,
                                 draft_top_p=1.0)
    assert vec[0] == 0.0 and vec[1] > 0.999 and vec[2:].sum() < 1e-3, vec
    vec_d = tacc.dynamic_acceptance(td, CFG, td, CFG, [rng.integers(3, CFG.vocab_size, 12)],
                                    width=4, steps_per_prompt=24, temperature=0.8, top_p=1.0,
                                    max_length=128)
    assert vec_d[1] > 0.95, vec_d


def test_accept_then_tree_search_cli(models, tmp_path):
    """The measure -> plan loop through both CLIs of the port, on the CPU:
    the pair from HF checkpoint directories (`--draft-weights DIR`), the
    greedy dynamic vector equal to JAX's `dynamic_acceptance` on the same
    weights and prompts, the static vector a distribution over ranks, and
    `tree_search` on the measured vector writing the same growmap as JAX's
    `tree_search` on the same config. The target is 0.6 x the draft + 0.4 x
    another random model, so that greedy children of several ranks are
    accepted (two independent random models accept none)."""
    jd, jt, td, _ = models
    jt = jax.tree.map(lambda a, b: 0.6 * a + 0.4 * b, jd, jt)
    tt = params_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    for name, params in (("draft", td), ("target", tt)):
        export_hf_checkpoint(params, CFG, str(tmp_path / name), weights="bin")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, CFG.vocab_size, 12) for _ in range(2)]
    (tmp_path / "prompts.json").write_text(json.dumps([p.tolist() for p in prompts]))
    common = ["--draft", "test-tiny", "--target", "test-tiny", "--draft-weights",
              str(tmp_path / "draft"), "--target-weights", str(tmp_path / "target"),
              "--dtype", "f32", "--W", "4", "--prompts", str(tmp_path / "prompts.json"),
              "--device", "cpu", "--seed", "5"]
    dyn = str(tmp_path / "dynamic.json")
    accept.main(common + ["--method", "dynamic", "--mode", "greedy", "--steps", "10",
                          "--M", "96", "--dst", dyn])
    got = np.asarray(json.load(open(dyn))["vector"])
    want = jacc.dynamic_acceptance(jd, CFG_J, jt, CFG_J, prompts, width=4, steps_per_prompt=10,
                                   max_length=96, seed=5, algorithm="greedy")
    np.testing.assert_array_equal(got, want)
    assert (got[1:] > 0).sum() >= 2, "accepted at most one rank: the comparison proves little"
    static = str(tmp_path / "static.json")
    accept.main(common + ["--method", "static", "--dst", static])
    vec = np.asarray(json.load(open(static))["vector"])
    assert vec.shape == (5,) and vec[0] == 0.0 and (vec >= 0).all() and vec.sum() <= 1 + 1e-6

    config = {"acceptance_rate_vector": dyn, "max_depth": 5, "max_budget": 16,
              "draft_time": 0.05, "valid_budget": [1, 2, 4, 8, 16],
              "target_time": [1.0, 1.0, 1.02, 1.05, 1.1]}
    maps = {}
    for name, cli in (("port", tree_search), ("jax", jax_tree_search)):
        path = tmp_path / f"{name}.cfg.json"
        path.write_text(json.dumps({**config, "dst": str(tmp_path / f"{name}.gm.json")}))
        cli.main(["--config", str(path)])
        maps[name] = json.load(open(tmp_path / f"{name}.gm.json"))
    assert maps["port"] == maps["jax"]
    np.testing.assert_array_equal(tree_search.load_acceptance_vector(dyn), got[:-1])
    gm = GrowMap.load(str(tmp_path / "port.gm.json"))
    tree_search.save_growmap(gm, str(tmp_path / "port.gm.pt"))
    assert GrowMap.load(str(tmp_path / "port.gm.pt")).successors == gm.successors


def test_default_vector_loads_as_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(tree_search.load_acceptance_vector("default"),
                                      jax_tree_search.load_acceptance_vector("default"))
