"""The port's engines against the JAX engines and against each other, on
the CPU in f32 with test-tiny and JAX weights carried across
(`params_from_numpy`). The greedy recipe of tests/test_engine_greedy.py:
`uniform_tree(3, 2)`, `max_length=128`, `prefill_chunk=16`."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.cli.testbed import load_growmap as jax_load_growmap  # noqa: E402
from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine.baseline import ARBaseline as JaxAR  # noqa: E402
from sequoia_tpu.engine.engine import SpecEngine as JaxSpec  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.cli.testbed import load_growmap  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.engine.baseline import ARBaseline, prefill_chunks  # noqa: E402
from sequoia_torch.engine.engine import SpecEngine  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")


@pytest.fixture(scope="module")
def models():
    jd = jax_random_params(CFG_J, jax.random.PRNGKey(7), dtype=jnp.float32)
    jt = jax_random_params(CFG_J, jax.random.PRNGKey(8), dtype=jnp.float32)
    to_port = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    return jd, jt, to_port(jd), to_port(jt)


def _prompts(n=3):
    rng = np.random.default_rng(3)
    return [rng.integers(3, CFG.vocab_size, size=9 + i) for i in range(n)]


def test_greedy_spec_token_exact_vs_jax_and_port_ar(models):
    jd, jt, td, tt = models
    jeng = JaxSpec(jd, CFG_J, jt, CFG_J, jax_uniform_tree(3, 2), algorithm="greedy",
                   max_length=128, prefill_chunk=16)
    eng = SpecEngine(td, CFG, tt, CFG, uniform_tree(3, 2), algorithm="greedy",
                     max_length=128, prefill_chunk=16, device="cpu")
    ar = ARBaseline(tt, CFG, max_length=128, greedy=True, prefill_chunk=16, device="cpu")
    for trial, prompt in enumerate(_prompts()):
        want = jeng.generate(prompt, max_new_tokens=40, seed=trial)
        got = eng.generate(prompt, max_new_tokens=40, seed=trial)
        np.testing.assert_array_equal(got, want)
        assert eng.num_large_model_steps == jeng.num_large_model_steps
        assert eng.num_decoding_steps == jeng.num_decoding_steps
        exp = ar.generate(prompt, max_new_tokens=40)
        n = min(len(exp), len(got))
        assert n > len(prompt)
        np.testing.assert_array_equal(got[:n], exp[:n])


def test_greedy_ar_token_exact_vs_jax(models):
    _, jt, _, tt = models
    jar = JaxAR(jt, CFG_J, max_length=128, greedy=True, prefill_chunk=16)
    ar = ARBaseline(tt, CFG, max_length=128, greedy=True, prefill_chunk=16, device="cpu")
    for prompt in _prompts(2):
        np.testing.assert_array_equal(ar.generate(prompt, max_new_tokens=30),
                                      jar.generate(prompt, max_new_tokens=30))
    streamed = np.concatenate(list(ar.stream(_prompts(1)[0], max_new_tokens=12)))
    np.testing.assert_array_equal(streamed, ar.generate(_prompts(1)[0], 12)[9:])


def test_ar_tail_chunk_does_not_clamp(models):
    """A 40-token prompt with prefill_chunk=32: at max_length=48 the tail
    chunk must shrink to 16 rows, ending at max_length (the JAX baseline
    writes a whole 32-row chunk, clamps the window start to 16 and
    overwrites committed rows), so the tokens must equal those at
    max_length=64, which equal the JAX baseline's."""
    _, jt, _, tt = models
    assert prefill_chunks(40, 32, 48) == [(0, 32), (32, 16)]
    assert prefill_chunks(40, 32, 64) == [(0, 32), (32, 32)]
    prompt = np.random.default_rng(0).integers(3, CFG.vocab_size, size=40)
    out = {M: ARBaseline(tt, CFG, max_length=M, greedy=True, prefill_chunk=32,
                         device="cpu").generate(prompt, max_new_tokens=6)
           for M in (48, 64)}
    np.testing.assert_array_equal(out[48], out[64])
    jax64 = JaxAR(jt, CFG_J, max_length=64, greedy=True, prefill_chunk=32).generate(
        prompt, max_new_tokens=6)
    np.testing.assert_array_equal(out[64], jax64)


@pytest.mark.parametrize("algo", ["sequoia", "specinfer", "greedy", "greedys"])
def test_all_algorithms_generate_valid_tokens(models, algo):
    _, _, td, tt = models
    eng = SpecEngine(td, CFG, tt, CFG, uniform_tree(3, 2), algorithm=algo,
                     max_length=128, temperature=0.7, top_p=0.9, prefill_chunk=16,
                     device="cpu")
    prompt = np.array([11, 23, 5, 99, 42, 7])
    out = eng.generate(prompt, max_new_tokens=30, seed=0)
    assert len(out) > len(prompt)
    assert out.min() >= 0 and out.max() < CFG.vocab_size
    np.testing.assert_array_equal(out[:len(prompt)], prompt)
    assert eng.num_decoding_steps >= eng.num_large_model_steps >= 1
    toks, phases = eng.generate_benchmark(prompt, max_new_tokens=10, seed=1)
    assert set(phases) == {"draft_run", "target_run", "accept_kv"}
    assert len(toks) > len(prompt)


def test_stochastic_spec_is_seeded(models):
    _, _, td, tt = models
    eng = SpecEngine(td, CFG, tt, CFG, uniform_tree(2, 3), algorithm="sequoia",
                     max_length=128, prefill_chunk=16, device="cpu")
    prompt = np.arange(5, 17)
    a = eng.generate(prompt, max_new_tokens=20, seed=4)
    np.testing.assert_array_equal(a, eng.generate(prompt, max_new_tokens=20, seed=4))
    chunks = list(eng.stream(prompt, max_new_tokens=20, seed=4))
    np.testing.assert_array_equal(np.concatenate([prompt, *chunks]), a)


def test_planned_growmap_equals_jax():
    gm, jgm = load_growmap("planned"), jax_load_growmap("planned")
    assert gm.size == jgm.size == 64
    assert gm.roots == jgm.roots and gm.branches == jgm.branches
    np.testing.assert_array_equal(gm.ancestors, jgm.ancestors)
    np.testing.assert_array_equal(gm.depth, jgm.depth)
    assert int(gm.depth.max()) == 5 and gm.level_widths == [9, 15, 19, 9, 11]


def test_unported_options_raise(models):
    _, _, td, tt = models
    gm = uniform_tree(2, 2)
    for kw in ({"walk": "path"}, {"kv_quant": "int8"}, {"shard_draft": True}):
        with pytest.raises(NotImplementedError):
            SpecEngine(td, CFG, tt, CFG, gm, device="cpu", **kw)
    with pytest.raises(ValueError):
        SpecEngine(td, CFG, tt, CFG, gm, algorithm="nope", device="cpu")
    with pytest.raises(ValueError):
        SpecEngine(td, CFG, tt, CFG, gm, device="cpu").generate(np.arange(250), 4)
    assert torch.is_tensor(td.embed)
