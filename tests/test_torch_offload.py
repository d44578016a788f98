"""The port's host offload (`engine/offload.py`, `core/model.py::
OffloadLayers` / `_layer_weights`) on the CPU in f32, against
`sequoia_tpu.engine.offload` (test-small target, 4 layers; the test-tiny
draft at its vocabulary; JAX's weights carried across with
`params_from_numpy`).

Offload changes where the layers lie, not the arithmetic: the port's
offloaded forward equals its resident forward bit for bit (logits and KV),
float and quantized, and the engines give the same tokens. Against JAX the
float forward agrees within 1e-5 and the quantized one within JAX's own
offload tolerance (`tests/test_offload.py`). On the CPU the forward fills
the same two staging buffers in the same order as on the card; the
poisoned-buffer and skipped-copy cases show that the layers are read from
them. The card's copy stream, pinned memory and graph capture are checked
by the `cuda` cases of `tests/test_torch_cuda.py`."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core import model as jmodel  # noqa: E402
from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine import offload as joffload  # noqa: E402
from sequoia_tpu.engine.engine import SpecEngine as JaxSpec  # noqa: E402
from sequoia_tpu.kvcache.cache import KVCache as JKV  # noqa: E402
from sequoia_tpu.ops import masks as jmasks  # noqa: E402
from sequoia_tpu.quant.quantize import quantize_model as jax_quantize  # noqa: E402
from sequoia_tpu.trees.growmap import chain as jax_chain  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_tree  # noqa: E402
from sequoia_torch.core import model as tmodel  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.engine import offload  # noqa: E402
from sequoia_torch.engine.baseline import ARBaseline  # noqa: E402
from sequoia_torch.engine.batched import BatchedSpecEngine  # noqa: E402
from sequoia_torch.engine.engine import SpecEngine  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.ops import masks  # noqa: E402
from sequoia_torch.planner.profile import time_forward_widths  # noqa: E402
from sequoia_torch.quant.qtensor import QuantizedTensor, tile_int4  # noqa: E402
from sequoia_torch.trees.growmap import chain, uniform_tree  # noqa: E402

CFG_J = get_config("test-small")   # 4 layers
CFG = port_config("test-small")
DCFG_J = dataclasses.replace(get_config("test-tiny"), vocab_size=CFG_J.vocab_size)
DCFG = dataclasses.replace(port_config("test-tiny"), vocab_size=CFG.vocab_size)
M = 64
TOKENS = np.arange(1, 13) % CFG.vocab_size
PROMPT = np.asarray([4, 9, 2, 250, 31, 7])   # tests/test_offload.py's
GREEDY = dict(algorithm="greedy", max_length=128, prefill_chunk=16)
_jax_forward = jax.jit(jmodel.forward, static_argnums=(1,))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


@pytest.fixture(scope="module")
def models():
    """JAX's draft and target (tests/test_offload.py's keys 7 and 8) and
    their port copies."""
    jd = jax_random_params(DCFG_J, jax.random.PRNGKey(7), dtype=jnp.float32)
    jt = jax_random_params(CFG_J, jax.random.PRNGKey(8), dtype=jnp.float32)
    return jd, jt, _port(jd), _port(jt)


def _forward(p, tokens=TOKENS):
    kv = KVCache.init(CFG, M, torch.float32, "cpu")
    n = len(tokens)
    return tmodel.forward(p, CFG, torch.as_tensor(tokens), torch.arange(n), kv, 0,
                          masks.causal_mask(n, M, 0, "cpu"))


def _jforward(p, tokens=TOKENS):
    n = len(tokens)
    return _jax_forward(p, CFG_J, jnp.asarray(tokens, jnp.int32), jnp.arange(n, dtype=jnp.int32),
                        JKV.init(CFG_J, M, jnp.float32), 0, jmasks.causal_mask(n, M, 0))


def _assert_same_forward(got, want):
    (gl, gkv), (wl, wkv) = got, want
    assert torch.equal(gl, wl)
    assert torch.equal(gkv.k, wkv.k) and torch.equal(gkv.v, wkv.v)


@pytest.mark.parametrize("stay", [0, 1, 3])
def test_offloaded_forward_equals_resident_and_jax(models, stay):
    """Bit for bit the resident forward; within 1e-5 of JAX's offloaded
    forward; JAX's offloaded params carried across keep their split and
    give the same bits."""
    _, jt, _, tt = models
    want = _forward(tt)
    off = offload.offload_params(tt, stay_layers=stay)
    assert isinstance(off.layers, tmodel.OffloadLayers)
    assert (off.layers.resident is None) == (stay == 0)
    assert off.layers.streamed.wq.shape[0] == CFG.num_layers - stay
    got = _forward(off)
    _assert_same_forward(got, want)

    joff = joffload.offload_params(jt, stay_layers=stay)
    jl, jkv = _jforward(joff)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].k.numpy(), np.asarray(jkv.k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].v.numpy(), np.asarray(jkv.v), rtol=0, atol=1e-5)

    carried = _port(joff)
    assert isinstance(carried.layers, tmodel.OffloadLayers)
    for a, b in zip(tmodel.layer_leaves(carried.layers.streamed),
                    tmodel.layer_leaves(off.layers.streamed)):
        assert torch.equal(a, b)
    _assert_same_forward(_forward(carried), want)


@pytest.mark.parametrize("kind", ["int8", "int4", "tiled_int4"])
def test_offloaded_quantized_forward(models, kind):
    """int8 / int4 (and panel-tiled int4) streamed layers: bit for bit the
    port's resident quantized forward, and within JAX's offload tolerance
    (`tests/test_offload.py:62-72`) of JAX's offloaded quantized forward."""
    _, jt, _, _ = models
    jq = jax_quantize(jt, bits=8 if kind == "int8" else 4)
    tq = _port(jq)
    if kind == "tiled_int4":
        tq = tq._replace(layers=tmodel.LayerParams(*(
            tile_int4(w) if isinstance(w, QuantizedTensor) else w for w in tq.layers)))
    want = _forward(tq)
    off = offload.offload_params(tq, stay_layers=1)
    assert isinstance(off.layers.streamed.wq, QuantizedTensor)
    got = _forward(off)
    _assert_same_forward(got, want)
    jl, _ = _jforward(joffload.offload_params(jq, stay_layers=1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jl), rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("quant", [None, 8])
def test_round_trip_and_bytes(models, quant):
    """`resident_params(offload_params(p))` is `p`; `offloaded_bytes`
    equals JAX's for every split, and the host bytes are exactly the
    streamed >= 3-D leaves (the norm stacks stay on the device)."""
    _, jt, _, _ = models
    if quant:
        jt = jax_quantize(jt, bits=quant)
    tt = _port(jt)
    assert offload.offloaded_bytes(tt) == joffload.offloaded_bytes(jt)
    for stay in (0, 1, 2, 3):
        off = offload.offload_params(tt, stay_layers=stay)
        host, dev = offload.offloaded_bytes(off)
        assert (host, dev) == joffload.offloaded_bytes(joffload.offload_params(jt, stay))
        assert host + dev == offload.offloaded_bytes(tt)[1]
        streamed = tmodel.layer_leaves(off.layers.streamed)
        assert host == sum(a.numel() * a.element_size() for a in streamed if a.dim() >= 3)
        assert off.layers.streamed.attn_norm.shape == (CFG.num_layers - stay, CFG.hidden_size)
        back = offload.resident_params(off)
        assert isinstance(back.layers, tmodel.LayerParams)
        for a, b in zip(tmodel.layer_leaves(back.layers), tmodel.layer_leaves(tt.layers)):
            assert torch.equal(a, b)
    import sequoia_torch

    assert sequoia_torch.offload_params is offload.offload_params
    with pytest.raises(ValueError):
        offload.offload_params(tt, stay_layers=CFG.num_layers)
    with pytest.raises(ValueError):
        offload.offload_params(offload.offload_params(tt), stay_layers=0)


@pytest.mark.parametrize("bits,jdt,tdt", [(None, jnp.float32, torch.float32),
                                          (None, jnp.bfloat16, torch.bfloat16),
                                          (8, jnp.bfloat16, torch.bfloat16),
                                          (4, jnp.bfloat16, torch.bfloat16)])
def test_random_offloaded_params_equal_jax(bits, jdt, tdt):
    """The layer stacks equal JAX's element for element: the same
    `default_rng` blocks and tiling. At bf16 too: both round each f64
    normal to f32 and then to bf16, so the values are exact, not within an
    ulp. Shapes, the split and the bytes match; the forward runs."""
    j = joffload.random_offloaded_params(CFG_J, seed=3, bits=bits, dtype=jdt, stay_layers=1)
    t = offload.random_offloaded_params(CFG, seed=3, bits=bits, dtype=tdt, stay_layers=1,
                                        device="cpu")
    for part in ("resident", "streamed"):
        jl = jax.tree.leaves(getattr(j.layers, part))
        tl = tmodel.layer_leaves(getattr(t.layers, part))
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape)
            if b.dtype == torch.bfloat16:
                np.testing.assert_array_equal(a.astype(np.float32), b.float().numpy())
            else:
                np.testing.assert_array_equal(a, b.numpy())
    assert offload.offloaded_bytes(t) == joffload.offloaded_bytes(j)
    kv = KVCache.init(CFG, 32, t.embed.dtype, "cpu")
    logits, _ = tmodel.forward(t, CFG, torch.arange(5), torch.arange(5), kv, 0,
                               masks.causal_mask(5, 32, 0, "cpu"))
    assert torch.isfinite(logits).all()


def test_layers_are_read_from_the_staging_buffers(models, monkeypatch):
    """Each streamed layer is copied into buffer j % 2 in layer order, two
    ahead at the start; poisoned buffers are overwritten before any read;
    a forward whose copies are skipped reads the poison."""
    _, _, _, tt = models
    off = offload.offload_params(tt, stay_layers=1)
    want = _forward(off)
    bufs = offload.staging_buffers(off)
    assert [tuple(b.shape) for b in bufs] == [
        (2, *a.shape[1:]) for a in tmodel.layer_leaves(off.layers.streamed) if a.dim() >= 3]

    filled = []
    fill = tmodel._Staging.fill

    def logged(self, host, j):
        filled.append(j)
        fill(self, host, j)

    monkeypatch.setattr(tmodel._Staging, "fill", logged)
    weights = tmodel._layer_weights(off.layers, CFG.num_layers, torch.device("cpu"))
    assert filled == [0, 1]                      # enqueued when the forward starts
    seen = []
    for i, w in enumerate(weights):
        seen.append(list(filled))
        if i >= 1:                               # streamed layer j = i - 1
            assert torch.equal(w.wq, off.layers.streamed.wq[i - 1])
            assert w.wq.data_ptr() == bufs[0][(i - 1) % 2].data_ptr()
    assert seen == [[0, 1], [0, 1], [0, 1, 2], [0, 1, 2]]

    for b in bufs:
        b.fill_(float("nan"))
    _assert_same_forward(_forward(off), want)
    for b in bufs:
        b.fill_(float("nan"))
    monkeypatch.setattr(tmodel._Staging, "fill", lambda self, host, j: None)
    assert torch.isnan(_forward(off)[0]).all()


@pytest.fixture(scope="module")
def offloaded(models):
    return offload.offload_params(models[3], stay_layers=1)


@pytest.mark.parametrize("gm_name", ["chain4", "tree_2x2"])
def test_greedy_spec_with_offloaded_target(models, offloaded, gm_name):
    """Greedy speculative decoding with an offloaded target: token-exact
    against JAX's engine with its offloaded target and the port's AR;
    `generate_fast` and `stream_fast` equal the resident `generate_fast`."""
    jd, jt, td, tt = models
    gm, jgm = {"chain4": (chain(4), jax_chain(4)), "tree_2x2": (uniform_tree(2, 2),
                                                                jax_tree(2, 2))}[gm_name]
    ar = ARBaseline(tt, CFG, max_length=128, greedy=True, prefill_chunk=16, device="cpu")
    expect = ar.generate(PROMPT, max_new_tokens=32)
    jax_eng = JaxSpec(jd, DCFG_J, joffload.offload_params(jt, stay_layers=1), CFG_J, jgm,
                      **GREEDY)
    eng = SpecEngine(td, DCFG, offloaded, CFG, gm, device="cpu", **GREEDY)
    got = eng.generate(PROMPT, max_new_tokens=32)
    np.testing.assert_array_equal(got, jax_eng.generate(PROMPT, max_new_tokens=32))
    n = min(len(expect), len(got))
    assert n > len(PROMPT)
    np.testing.assert_array_equal(expect[:n], got[:n])
    resident = SpecEngine(td, DCFG, tt, CFG, gm, device="cpu", **GREEDY)
    fast = eng.generate_fast(PROMPT, max_new_tokens=32)
    np.testing.assert_array_equal(fast, resident.generate_fast(PROMPT, max_new_tokens=32))
    np.testing.assert_array_equal(fast, got)
    streamed = list(eng.stream_fast(PROMPT, max_new_tokens=32, chunk_tokens=5))
    np.testing.assert_array_equal(np.concatenate([PROMPT] + streamed), fast)


def test_stochastic_spec_and_ar_offloaded_equal_resident(models, offloaded):
    """Seeded Sequoia and stochastic AR: the same tokens with the target
    offloaded (stay 1) and resident."""
    _, _, td, tt = models
    kw = dict(algorithm="sequoia", max_length=96, prefill_chunk=16, temperature=0.8, top_p=0.9)
    outs = [SpecEngine(td, DCFG, t, CFG, uniform_tree(3, 2), device="cpu", **kw
                       ).generate_fast(PROMPT, max_new_tokens=24, seed=5)
            for t in (offloaded, tt)]
    np.testing.assert_array_equal(*outs)
    outs = [ARBaseline(t, CFG, max_length=96, temperature=0.8, top_p=0.9, prefill_chunk=16,
                       device="cpu").generate_fast(PROMPT, max_new_tokens=16, seed=5)
            for t in (offloaded, tt)]
    np.testing.assert_array_equal(*outs)


def test_batched_forward_and_serving_offloaded(models, offloaded):
    """`forward_batched` over an offloaded target equals the resident one
    bit for bit, and `BatchedSpecEngine.serve_fast` gives the same tokens."""
    _, _, td, tt = models
    B, Q = 2, 5
    tokens = torch.as_tensor(np.arange(B * Q).reshape(B, Q) * 7 % CFG.vocab_size)
    pos = torch.arange(Q).expand(B, Q)
    mask = masks.causal_mask(Q, M, 0, "cpu").expand(B, Q, M).contiguous()
    offsets = torch.zeros(B, dtype=torch.long)
    outs = []
    for t in (offloaded, tt):
        kv = KVCache.init(CFG, M, torch.float32, "cpu", batch=B)
        logits, kv = tmodel.forward_batched(t, CFG, tokens, pos, kv, offsets, mask)
        outs.append((logits, kv))
    _assert_same_forward(*outs)
    prompts = [PROMPT, np.arange(3, 11), np.array([100, 50])]
    served = [BatchedSpecEngine(td, DCFG, t, CFG, uniform_tree(3, 2), batch_size=2,
                                device="cpu", algorithm="greedy", max_length=96,
                                prefill_chunk=16).serve_fast(prompts, max_new_tokens=12, seed=0)
              for t in (offloaded, tt)]
    for a, b in zip(*served):
        np.testing.assert_array_equal(a, b)


def test_latency_curve_of_an_offloaded_target(offloaded):
    """`time_forward_widths` takes an offloaded target (few reps by
    default: an offloaded forward costs the host link)."""
    times = time_forward_widths(offloaded, CFG, [1, 4], max_length=M, kv_len=16,
                                dtype=torch.float32)
    assert len(times) == 2 and all(t > 0 for t in times)


def test_testbed_offloading(capsys):
    """`--offloading --staylayer N` on the testbed (random weights built
    into host memory), spec and baseline."""
    from sequoia_torch.cli.testbed import main

    for mode in ("spec", "baseline"):
        main(["--draft", "test-tiny", "--target", "test-tiny", "--mode", mode,
              "--algorithm", "greedy", "--growmap", "chain:3", "--M", "64", "--gen", "8",
              "--dtype", "f32", "--prompts", "synthetic:1,10", "--offloading",
              "--staylayer", "1", "--device", "cpu"])
        assert "per-token latency" in capsys.readouterr().out
