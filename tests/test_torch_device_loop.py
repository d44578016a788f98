"""The port's device loops (`generate_fast`, `stream_fast`,
`iterate_phased`, `ARBaseline.generate_fast`) on the CPU, in f32 with
test-tiny and JAX weights carried across (`params_from_numpy`): greedy
token-exact to the JAX package's on-device loops, seeded stochastic runs
equal to the eager loop, and no host read inside an iteration, a step or a
block. On the CPU the blocks run eagerly; the card replays the same
predicated phases as CUDA graphs (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine.baseline import ARBaseline as JaxAR  # noqa: E402
from sequoia_tpu.engine.engine import SpecEngine as JaxSpec  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.cli.testbed import load_growmap  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.engine.baseline import BLOCK_STEPS, ARBaseline  # noqa: E402
from sequoia_torch.engine.engine import ALGORITHMS, SpecEngine  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")
PROMPT = np.array([11, 23, 5, 99, 42, 7])
CHUNKS = (1, 5, 16, 64)


@pytest.fixture(scope="module")
def models():
    jd = jax_random_params(CFG_J, jax.random.PRNGKey(7), dtype=jnp.float32)
    jt = jax_random_params(CFG_J, jax.random.PRNGKey(8), dtype=jnp.float32)
    to_port = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    return jd, jt, to_port(jd), to_port(jt)


def _spec(models, algorithm="greedy", cfg=CFG, gm=None, **kw):
    _, _, td, tt = models
    kw = {"max_length": 128, "prefill_chunk": 16, **kw}
    return SpecEngine(td, cfg, tt, cfg, gm or uniform_tree(3, 2), algorithm=algorithm,
                      device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX's greedy `generate_fast` and `stream_fast` at every chunk size
    (one engine: one compiled loop), with their step counts."""
    jd, jt, _, _ = models
    jeng = JaxSpec(jd, CFG_J, jt, CFG_J, jax_uniform_tree(3, 2), algorithm="greedy",
                   max_length=128, prefill_chunk=16)
    full = np.asarray(jeng.generate_fast(PROMPT, max_new_tokens=24, seed=0))
    out = {"full": (full, jeng.num_decoding_steps, jeng.num_large_model_steps)}
    for chunk in CHUNKS:
        parts = [np.asarray(c) for c in jeng.stream_fast(PROMPT, max_new_tokens=24,
                                                        chunk_tokens=chunk, seed=0)]
        out[chunk] = (parts, jeng.num_large_model_steps)
    return out


def test_greedy_generate_fast_token_exact_vs_jax(models, jax_greedy):
    want, jtokens, jsteps = jax_greedy["full"]
    eng = _spec(models)
    got = eng.generate_fast(PROMPT, max_new_tokens=24, seed=0)
    np.testing.assert_array_equal(got, want)
    assert eng.num_decoding_steps == jtokens == len(got) - len(PROMPT)
    assert eng.num_large_model_steps == jsteps
    # And equal to the eager loop.
    np.testing.assert_array_equal(eng.generate(PROMPT, max_new_tokens=24, seed=0), got)
    assert eng.num_large_model_steps == jsteps


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_fast_matches_generate_fast_and_jax(models, jax_greedy, chunk):
    eng = _spec(models)
    full = eng.generate_fast(PROMPT, max_new_tokens=24, seed=0)
    n_steps = eng.num_large_model_steps
    streamed = list(eng.stream_fast(PROMPT, max_new_tokens=24, chunk_tokens=chunk, seed=0))
    np.testing.assert_array_equal(np.concatenate([PROMPT] + streamed), full)
    want, jsteps = jax_greedy[chunk]
    assert len(streamed) == len(want)
    for a, b in zip(streamed, want):
        np.testing.assert_array_equal(a, b)
    assert eng.num_large_model_steps == jsteps >= n_steps
    assert all(1 <= len(c) <= chunk + eng.max_depth for c in streamed)


def test_generate_fast_fills_the_buffer_like_jax(models):
    """A budget the buffer cannot hold: the loop stops where the next tree
    no longer fits, as JAX's does; the blocks shrink towards the end."""
    jd, jt, _, _ = models
    jeng = JaxSpec(jd, CFG_J, jt, CFG_J, jax_uniform_tree(3, 2), algorithm="greedy",
                   max_length=48, prefill_chunk=16)
    want = np.asarray(jeng.generate_fast(PROMPT, max_new_tokens=100, seed=0))
    eng = _spec(models, max_length=48)
    blocks = []
    block = eng._block
    eng._block = lambda state, k: (blocks.append(k), block(state, k))
    got = eng.generate_fast(PROMPT, max_new_tokens=100, seed=0)
    np.testing.assert_array_equal(got, want)
    assert eng.num_large_model_steps == jeng.num_large_model_steps
    assert len(blocks) > 1 and blocks[-1] == 1 and sum(blocks) >= eng.num_large_model_steps


def test_ar_generate_fast_token_exact_vs_jax(models):
    _, jt, _, tt = models
    jar = JaxAR(jt, CFG_J, max_length=96, greedy=True, prefill_chunk=16)
    ar = ARBaseline(tt, CFG, max_length=96, greedy=True, prefill_chunk=16, device="cpu")
    for prompt, n in ((np.array([4, 9, 13]), 20), (PROMPT, 40)):
        want = np.asarray(jar.generate_fast(prompt, max_new_tokens=n))
        got = ar.generate_fast(prompt, max_new_tokens=n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ar.generate(prompt, max_new_tokens=n), got)


def test_no_budget_returns_the_prompt(models):
    """No room or no budget: `generate_fast` runs no iteration and no step
    (on the card it captures nothing) and returns the prompt."""
    ar = ARBaseline(models[3], CFG, max_length=len(PROMPT), greedy=True, prefill_chunk=16,
                    device="cpu")
    np.testing.assert_array_equal(ar.generate_fast(PROMPT, max_new_tokens=0), PROMPT)
    np.testing.assert_array_equal(ar.generate(PROMPT, max_new_tokens=0), PROMPT)
    assert int(ar._n) == len(PROMPT)
    eng = _spec(models)
    np.testing.assert_array_equal(eng.generate_fast(PROMPT, max_new_tokens=0), PROMPT)
    assert eng.num_large_model_steps == 0


def _stop_at(tokens, prompt_len, i):
    """Configs (JAX, port) whose stop token is the i-th generated token."""
    stop = (int(tokens[prompt_len + i]),)
    return (dataclasses.replace(CFG_J, stop_tokens=stop),
            dataclasses.replace(CFG, stop_tokens=stop))


def _block_start(parts, k):
    """Index (among the generated tokens) of the first token that is new
    and is emitted by the first iteration of a block of `k` after the first
    block; `parts` holds each iteration's tokens."""
    seen = [t for p in parts[:k] for t in p]
    for j in range(k, len(parts)):
        for t in parts[j]:
            if j % k == 0 and t not in seen:
                return len(seen)
            seen.append(t)
    raise AssertionError("no new token starts a block")


def _counting(obj, name):
    """Count the calls of `obj.name` (an instance attribute wraps it)."""
    calls = []
    method = getattr(obj, name)
    setattr(obj, name, lambda *a, **k: (calls.append(1), method(*a, **k))[1])
    return calls


def test_stop_token_mid_block_is_predicated(models):
    """A stop token in the first iteration of a block: the iterations after
    it are no-ops on the device, so the output, the counts and the state
    equal the eager loop's and JAX's."""
    from sequoia_torch.engine.engine import BLOCK_ITERATIONS

    jd, jt, td, tt = models
    parts = list(_spec(models).stream(PROMPT, max_new_tokens=30, seed=0))
    free = np.concatenate([PROMPT] + parts)
    cfg_j, cfg = _stop_at(free, len(PROMPT), _block_start(parts, BLOCK_ITERATIONS))
    jeng = JaxSpec(jd, cfg_j, jt, cfg_j, jax_uniform_tree(3, 2), algorithm="greedy",
                   max_length=128, prefill_chunk=16)
    want = np.asarray(jeng.generate_fast(PROMPT, max_new_tokens=30, seed=0))
    eager = _spec(models, cfg=cfg)
    fast = _spec(models, cfg=cfg)
    iterations = _counting(fast, "_finalize_counted")
    got_eager = eager.generate(PROMPT, max_new_tokens=30, seed=0)
    got = fast.generate_fast(PROMPT, max_new_tokens=30, seed=0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_eager, want)
    assert len(got) < len(free) and got[-1] == cfg.stop_tokens[0]
    assert fast.num_large_model_steps == eager.num_large_model_steps \
        == jeng.num_large_model_steps
    assert int(fast._steps) == fast.num_large_model_steps < len(iterations)  # no-ops ran
    # Dead iterations moved neither gtl nor the root logits.
    gtl = len(got)
    assert int(fast._gtl) == gtl == int(eager._gtl)
    torch.testing.assert_close(fast._root_logits, eager._root_logits, rtol=0, atol=0)
    np.testing.assert_array_equal(fast._tokens[:gtl].numpy(), eager._tokens[:gtl].numpy())

    ar_free = ARBaseline(tt, CFG, max_length=96, greedy=True, prefill_chunk=16,
                         device="cpu").generate(PROMPT, max_new_tokens=30)
    steps = [[t] for t in ar_free[len(PROMPT):]]
    cfg_j, cfg = _stop_at(ar_free, len(PROMPT), _block_start(steps, BLOCK_STEPS))
    want = np.asarray(JaxAR(jt, cfg_j, max_length=96, greedy=True, prefill_chunk=16)
                      .generate_fast(PROMPT, max_new_tokens=30))
    ar = ARBaseline(tt, cfg, max_length=96, greedy=True, prefill_chunk=16, device="cpu")
    calls = _counting(ar, "_step_counted")
    got = ar.generate_fast(PROMPT, max_new_tokens=30)
    np.testing.assert_array_equal(got, want)
    first = list(ar_free[len(PROMPT):]).index(cfg.stop_tokens[0])
    assert len(got) == len(PROMPT) + first + 1 == int(ar._n) < len(PROMPT) + len(calls)
    np.testing.assert_array_equal(ar.generate(PROMPT, max_new_tokens=30), got)


@pytest.mark.parametrize("algo", ["sequoia", "specinfer", "greedys"])
def test_seeded_generate_fast_equals_generate(models, algo):
    eng = _spec(models, algo, max_length=96, temperature=0.7, top_p=0.9)
    for seed in (1, 2):
        want = eng.generate(PROMPT, max_new_tokens=20, seed=seed)
        steps = eng.num_large_model_steps
        got = eng.generate_fast(PROMPT, max_new_tokens=20, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert eng.num_large_model_steps == steps
    ar = ARBaseline(models[3], CFG, max_length=96, temperature=0.7, top_p=0.9,
                    prefill_chunk=16, device="cpu")
    np.testing.assert_array_equal(ar.generate_fast(PROMPT, 20, seed=3),
                                  ar.generate(PROMPT, 20, seed=3))


def _state_tensors(eng):
    st = [eng._tokens, eng._gtl, eng._root_logits, eng._terminal, eng._draft_kv.k,
          eng._draft_kv.v]
    return st + [getattr(eng._target_kv, f.name) for f in dataclasses.fields(eng._target_kv)]


@pytest.mark.parametrize("kv_quant", [None, "int4"])
def test_iterate_phased_leaves_the_state_of_iterate(models, kv_quant):
    a = _spec(models, "sequoia", max_length=96, temperature=0.7, kv_quant=kv_quant)
    b = _spec(models, "sequoia", max_length=96, temperature=0.7, kv_quant=kv_quant)
    sa, sb = a.prefill(PROMPT, seed=4), b.prefill(PROMPT, seed=4)
    for _ in range(3):
        want = a.iterate(sa)
        got, seconds = b.iterate_phased(sb)
        assert set(seconds) == {"draft_run", "target_run", "accept_kv"}
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    for x, y in zip(_state_tensors(b), _state_tensors(a)):
        assert torch.equal(x, y)
    assert int(b._steps) == 3 and int(b._produced) == int(sb.gtl) - len(PROMPT)


class _NoHostReads(TorchDispatchMode):
    """Raises on `aten._local_scalar_dense`, the op behind `.item()`,
    `bool(t)` and indexing with a 0-d tensor: on the card each is a read
    that waits for the device, and inside a capture it aborts the graph."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a host read inside the device loop")
        return func(*args, **(kwargs or {}))


def test_no_host_reads_mode_catches_a_tensor_index():
    x, i = torch.arange(4), torch.tensor(2)
    with pytest.raises(AssertionError, match="host read"):
        with _NoHostReads():
            x[i]


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_iteration_and_block_read_nothing_back(models, algo, kv_quant):
    """One iteration (the planned 64-node growmap) and one block of two
    predicated iterations make no host read; before this slice one
    sequoia iteration made 84."""
    eng = _spec(models, algo, gm=load_growmap("planned"), max_length=96,
                temperature=0.7, kv_quant=kv_quant)
    state = eng.prefill(PROMPT, seed=0)
    with _NoHostReads():
        eng.iterate(state)
    eng._arm(40)
    with _NoHostReads():
        eng._block(state, 2)
    assert int(eng._steps) == 2


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
@pytest.mark.parametrize("greedy", [True, False])
def test_ar_step_and_block_read_nothing_back(models, greedy, kv_quant):
    ar = ARBaseline(models[3], CFG, max_length=64, greedy=greedy, temperature=0.7,
                    prefill_chunk=16, kv_quant=kv_quant, device="cpu")
    state = ar.prefill(PROMPT, seed=0)
    with _NoHostReads():
        ar.step(state)
        ar._budget.fill_(3)
        for _ in range(4):
            ar._step_counted(state)
    assert int(ar._produced) == 3 and int(state.n) == len(PROMPT) + 4


def test_fast_loops_read_the_host_once_per_block(models, monkeypatch):
    """In a whole `generate_fast` (and the AR one) the host reads the
    counters once per block (`tolist`) and the tokens once at the end
    (`cpu`), and nothing else (no `_local_scalar_dense`)."""
    reads = {"tolist": 0, "cpu": 0}
    for name in reads:
        method = getattr(torch.Tensor, name)

        def counted(self, *a, _m=method, _n=name, **k):
            reads[_n] += 1
            return _m(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    eng = _spec(models)
    blocks = []
    block = eng._block
    eng._block = lambda state, k: (blocks.append(k), block(state, k))
    with _NoHostReads():
        eng.generate_fast(PROMPT, max_new_tokens=100, seed=0)
    assert reads == {"tolist": len(blocks), "cpu": 1} and len(blocks) >= 2
    ar = ARBaseline(models[3], CFG, max_length=96, greedy=True, prefill_chunk=16,
                    device="cpu")
    reads.update(tolist=0, cpu=0)
    with _NoHostReads():
        ar.generate_fast(PROMPT, max_new_tokens=40)
    assert reads == {"tolist": -(-40 // BLOCK_STEPS), "cpu": 1}
