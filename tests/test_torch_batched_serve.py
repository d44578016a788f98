"""The port's batched engines (`engine/batched.py`) on the CPU in f32 with
test-tiny and JAX's weights carried across: greedy outputs token-exact
against `sequoia_tpu.engine.batched` for every entry point (prefill and
decode in a batch, continuous batching on the host and on the device,
batched AR), serve_device's tail-reserve budget, the AR-crossover routing,
and seeded stochastic runs: each slot equals the single-request engine
with its request's seed, and serve_device's outputs do not depend on
`admit_width` or `harvest_batch`."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine.batched import (  # noqa: E402
    BatchedAREngine as JaxBatchedAR, BatchedSpecEngine as JaxBatched)
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.engine.baseline import ARBaseline  # noqa: E402
from sequoia_torch.engine.batched import BatchedAREngine, BatchedSpecEngine  # noqa: E402
from sequoia_torch.engine.engine import SpecEngine  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")
# tests/test_batched.py's prompts.
PROMPTS = [
    np.array([11, 23, 5, 99, 42, 7]),
    np.array([3, 1, 4, 1, 5, 9, 2, 6]),
    np.array([100, 50]),
    np.array([7, 7, 7, 7, 7, 7, 7]),
    np.array([42]),
    np.array([88, 13, 21, 34]),
]
GREEDY = dict(algorithm="greedy", max_length=96, prefill_chunk=16)
SEQUOIA = dict(algorithm="sequoia", max_length=96, prefill_chunk=16, temperature=0.8, top_p=0.9)


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
    jd = jax_random_params(CFG_J, jax.random.PRNGKey(7), dtype=jnp.float32)
    jt = jax_random_params(CFG_J, jax.random.PRNGKey(8), dtype=jnp.float32)
    to_port = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    return jd, jt, to_port(jd), to_port(jt)


def _port(models, gm=None, batch_size=2, **kw):
    _, _, td, tt = models
    kw = {**GREEDY, **kw}
    return BatchedSpecEngine(td, CFG, tt, CFG, gm or uniform_tree(3, 2), batch_size=batch_size,
                             device="cpu", **kw)


def _jax(models, gm=None, batch_size=2, **kw):
    jd, jt, _, _ = models
    kw = {**GREEDY, **kw}
    return JaxBatched(jd, CFG_J, jt, CFG_J, gm or jax_uniform_tree(3, 2),
                      batch_size=batch_size, **kw)


def _equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g)


@pytest.fixture(scope="module")
def jax_serving(models):
    """JAX's greedy outputs: the three continuous-batching loops over the six
    prompts at B = 2 (one engine: one compiled iteration), the fixed batch of
    three at B = 3, with their counters."""
    eng = _jax(models)
    out = {name: (getattr(eng, name)(PROMPTS, max_new_tokens=12, seed=0),
                  eng.num_decoding_steps)
           for name in ("serve", "serve_fast", "serve_device")}
    eng3 = _jax(models, batch_size=3)
    for name in ("generate_batch", "generate_batch_fast"):
        out[name] = (getattr(eng3, name)(PROMPTS[:3], max_new_tokens=20, seed=0),
                     eng3.num_decoding_steps, eng3.num_large_model_steps)
    return out


@pytest.mark.parametrize("name", ["serve", "serve_fast", "serve_device"])
def test_greedy_serving_token_exact_vs_jax(models, jax_serving, name):
    want, decoded = jax_serving[name]
    eng = _port(models)
    _equal(want, getattr(eng, name)(PROMPTS, max_new_tokens=12, seed=0))
    assert eng.num_decoding_steps == decoded
    if name == "serve_device":
        assert eng.num_prefill_steps > 0


@pytest.mark.parametrize("name", ["generate_batch", "generate_batch_fast"])
def test_greedy_generate_batch_token_exact_vs_jax(models, jax_serving, name):
    want, decoded, steps = jax_serving[name]
    eng = _port(models, batch_size=3)
    _equal(want, getattr(eng, name)(PROMPTS[:3], max_new_tokens=20, seed=0))
    assert eng.num_decoding_steps == decoded
    assert eng.num_large_model_steps == steps
    # The per-slot prefill gives the fused one's state.
    fused = [t.clone() for t in eng.prefill_batch(PROMPTS[:3], seed=0).target_kv.tensors()]
    for x, y in zip(fused, eng.prefill_batch(PROMPTS[:3], seed=0, fused=False).target_kv.tensors()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def test_batched_ar_token_exact_vs_jax(models):
    """`BatchedAREngine.generate_batch_fast` and `serve_fast` (greedy)
    against JAX's; each slot equals the single-request AR baseline."""
    _, jt, _, tt = models
    kw = dict(max_length=96, greedy=True, prefill_chunk=16)
    jeng = JaxBatchedAR(jt, CFG_J, batch_size=4, **kw)
    eng = BatchedAREngine(tt, CFG, batch_size=4, device="cpu", **kw)
    got = eng.generate_batch_fast(PROMPTS[:4], max_new_tokens=12)
    _equal(jeng.generate_batch_fast(PROMPTS[:4], max_new_tokens=12), got)
    assert eng.num_large_model_steps == jeng.num_large_model_steps
    single = ARBaseline(tt, CFG, device="cpu", **kw)
    for p, g in zip(PROMPTS[:4], got):
        np.testing.assert_array_equal(single.generate_fast(p, max_new_tokens=12), g)
    jeng2 = JaxBatchedAR(jt, CFG_J, batch_size=2, **kw)
    eng2 = BatchedAREngine(tt, CFG, batch_size=2, device="cpu", **kw)
    _equal(jeng2.serve_fast(PROMPTS, max_new_tokens=8), eng2.serve_fast(PROMPTS, max_new_tokens=8))
    assert eng2.num_decoding_steps == jeng2.num_decoding_steps


def test_serve_device_tail_reserve_budget(models):
    """serve_device reserves the tail `prefill_chunk` rows as the admission
    steps' scratch zone, so a buffer-limited request stops up to ~C tokens
    earlier than via serve_fast. Both produced lengths are predicted exactly
    by replaying the single-request iteration stream against each path's
    finish bound (tests/test_batched.py's test, on the port)."""
    _, _, td, tt = models
    gm = uniform_tree(2, 2)   # size 7, depth 2
    M, C = 64, 16
    kw = dict(algorithm="greedy", max_length=M, prefill_chunk=C)
    prompt = PROMPTS[0]
    big = 1000   # never binds: the buffer bound is what stops the request
    single = SpecEngine(td, CFG, tt, CFG, gm, device="cpu", **kw)
    emitted = [len(d) for d in single.stream(prompt, max_new_tokens=big)]
    md = int(gm.depth.max())

    def predict(bound):
        gtl, produced = len(prompt), 0
        for e in emitted:
            gtl += e
            produced += e
            if produced >= big or gtl - 1 + gm.size > bound or gtl + md + 1 > bound:
                break
        return produced

    exp_fast, exp_dev = predict(M), predict(M - C)
    assert exp_dev < exp_fast   # the tighter budget must actually bind
    sf = BatchedSpecEngine(td, CFG, tt, CFG, gm, batch_size=1, device="cpu", **kw)
    out_f = sf.serve_fast([prompt], max_new_tokens=big)[0]
    sd = BatchedSpecEngine(td, CFG, tt, CFG, gm, batch_size=1, device="cpu", **kw)
    out_d = sd.serve_device([prompt], max_new_tokens=big)[0]
    assert len(out_f) - len(prompt) == exp_fast
    assert len(out_d) - len(prompt) == exp_dev
    np.testing.assert_array_equal(out_d, out_f[:len(out_d)])


def test_fewer_prompts_than_slots(models):
    """Idle slots stay idle: serve_fast, serve_device and serve give the
    same outputs with two prompts in four slots, each the single engine's."""
    eng = _port(models, gm=uniform_tree(2, 2), batch_size=4, max_length=64)
    fast = eng.serve_fast(PROMPTS[:2], max_new_tokens=8, seed=0)
    _equal(fast, eng.serve_device(PROMPTS[:2], max_new_tokens=8, seed=0))
    _equal(fast, eng.serve(PROMPTS[:2], max_new_tokens=8, seed=0))
    _, _, td, tt = models
    single = SpecEngine(td, CFG, tt, CFG, uniform_tree(2, 2), device="cpu",
                        **{**GREEDY, "max_length": 64})
    for p, out in zip(PROMPTS[:2], fast):
        assert len(out) > len(p)
        want = single.generate(p, max_new_tokens=8)
        np.testing.assert_array_equal(out, want[:len(out)])


def test_serve_auto_routes(models, monkeypatch):
    """serve_auto switches engines on the measured costs; the spec branch
    runs serve_device when every prompt clears the tail reserve, else
    serve_fast; the w8a8 routing records its choice."""
    from sequoia_torch.quant import qtensor

    eng = _port(models, gm=uniform_tree(2, 2))
    calls = []
    for name in ("serve_device", "serve_fast"):
        orig = getattr(eng, name)
        monkeypatch.setattr(eng, name, lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))
    spec = dict(spec_iter_s=0.012, ar_step_s=0.010, expected_accepted=3.0, max_new_tokens=6)
    outs = eng.serve_auto(PROMPTS[:3], **spec)
    assert eng.serving_mode == "spec" and calls == ["serve_device"]
    assert all(len(o) > len(p) for o, p in zip(outs, PROMPTS[:3]))
    limit = eng.max_length - eng.prefill_chunk - eng.tree_size
    eng.serve_auto([np.arange(limit + 1) % 50 + 1] + PROMPTS[:2], **spec)
    assert calls[-1] == "serve_fast"
    outs = eng.serve_auto(PROMPTS[:3], spec_iter_s=0.020, ar_step_s=0.002,
                          expected_accepted=3.0, max_new_tokens=6)
    assert eng.serving_mode == "ar" and len(outs) == 3
    for p, o in zip(PROMPTS[:3], outs):
        np.testing.assert_array_equal(o[:len(p)], p)
    try:
        eng.serve_auto(PROMPTS[:2], spec_iter_s=0.0165, spec_iter_s_w8a8=0.012, ar_step_s=0.010,
                       expected_accepted=3.0, max_new_tokens=4)
        assert eng.w8a8_choice.use_w8a8 and qtensor.w8a8_setting()[0] == "on"
    finally:
        qtensor.set_w8a8("auto")


def test_stochastic_slots_equal_single_requests(models):
    """Sequoia (T 0.8, P 0.9): request i of a batched run seeded `seed`
    commits a prefix of the single-request engine's tokens with seed
    `seed + i` (the batched engine trims the last iteration's overshoot of
    the budget), under the node and the staged walk, through the fused fill
    and refills alike."""
    _, _, td, tt = models
    for walk in ("node", "staged"):
        single = SpecEngine(td, CFG, tt, CFG, uniform_tree(3, 2), device="cpu", walk=walk,
                            **SEQUOIA)
        want = [single.generate(p, max_new_tokens=9, seed=3 + i) for i, p in enumerate(PROMPTS)]
        eng = _port(models, walk=walk, **SEQUOIA)
        got = eng.serve_fast(PROMPTS, max_new_tokens=9, seed=3)
        for w, g in zip(want, got):
            assert len(g) - 9 <= len(w) and len(g) > 0
            np.testing.assert_array_equal(g, w[:len(g)])
        got = eng.generate_batch_fast(PROMPTS[:2], max_new_tokens=9, seed=3)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w[:len(g)])


def test_serve_device_schedule_does_not_change_outputs(models):
    """Stochastic serve_device outputs are equal for admit_width 1, 2, 4
    and harvest_batch 1, 2 (per-request streams, seeded `seed + request`),
    and equal to serve_fast's (no prompt is near the tail reserve)."""
    want = _port(models, batch_size=4, **SEQUOIA).serve_fast(PROMPTS, max_new_tokens=9, seed=3)
    for admit_width in (1, 2, 4):
        for harvest in (1, 2):
            eng = _port(models, batch_size=4, admit_width=admit_width, harvest_batch=harvest,
                        **SEQUOIA)
            _equal(want, eng.serve_device(PROMPTS, max_new_tokens=9, seed=3))
