"""The port's weight quantization against the JAX package, on the CPU.

Quantizers, layouts, the quantized matmul's plain version (against the JAX
Pallas kernel in interpret mode), `qtensor.matmul`, the quantized forward,
greedy decoding with quantized targets, the latency-curve timer and the
testbed's `--quant`. Inputs are numpy arrays from `np.random.default_rng`,
handed to both sides. On a CPU tensor the port's wrapper runs its plain
version; the CUDA kernels are held against it by tests/test_torch_cuda.py
and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core import model as jmodel  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine.engine import SpecEngine as JaxSpec  # noqa: E402
from sequoia_tpu.kernels.quant_matmul import quant_matmul as jax_quant_matmul  # noqa: E402
from sequoia_tpu.kvcache.cache import KVCache as JKV  # noqa: E402
from sequoia_tpu.ops import masks as jmasks  # noqa: E402
from sequoia_tpu.quant import qtensor as jq  # noqa: E402
from sequoia_tpu.quant.quantize import quantize_model as jax_quantize_model  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.core import model as tmodel  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy, random_params  # noqa: E402
from sequoia_torch.engine.baseline import ARBaseline  # noqa: E402
from sequoia_torch.engine.engine import SpecEngine  # noqa: E402
from sequoia_torch.kernels import quant_matmul as tqmm  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.ops import masks as tmasks  # noqa: E402
from sequoia_torch.planner.profile import (  # noqa: E402
    measure_latency_curve, time_forward_widths)
from sequoia_torch.quant import qtensor as tq  # noqa: E402
from sequoia_torch.quant.quantize import (  # noqa: E402
    model_bytes, quantize_model, random_quantized_model)
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")
M = 64


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _weights(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05


# (a) quantizers and layouts -------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(96, 200), (3, 64, 48)])
def test_quantize_bit_identical(bits, shape):
    """Same q bytes (packed int4 included) and the same scales, exactly."""
    w = _weights(shape, seed=len(shape) + bits)
    jfn = jq.quantize_int8 if bits == 8 else jq.quantize_int4
    tfn = tq.quantize_int8 if bits == 8 else tq.quantize_int4
    jw, tw = jfn(jnp.asarray(w)), tfn(torch.from_numpy(w))
    assert tw.q.dtype == torch.int8 and tw.scale.dtype == torch.float32
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    K = shape[-2]
    np.testing.assert_array_equal(tq.dequantize(tw, K).numpy(),
                                  np.asarray(jq.dequantize(jw, K)))


def test_unpack_and_tiling_match():
    """Every byte value (so every nibble, -8 included) unpacks alike; the
    N-panel layout and its inverse are the same on both sides."""
    rng = np.random.default_rng(1)
    packed = rng.integers(-128, 128, size=(48, 200)).astype(np.int8)
    packed.reshape(-1)[:256] = np.arange(-128, 128).astype(np.int8)
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jq.unpack_int4(jnp.asarray(packed))))
    scale = rng.random((1, 200)).astype(np.float32) + 0.1
    jw = jq.QuantizedTensor(jnp.asarray(packed), jnp.asarray(scale))
    tw = tq.QuantizedTensor(torch.from_numpy(packed), torch.from_numpy(scale))
    jt, tt = jq.tile_int4(jw), tq.tile_int4(tw)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    assert tq.is_tiled(tt) and not tq.is_tiled(tw)
    np.testing.assert_array_equal(tq.untile_int4(tt).q.numpy(), packed)
    np.testing.assert_array_equal(tq.dequantize(tt, 96).numpy(),
                                  np.asarray(jq.dequantize(jt, 96)))


# (b) the plain quantized matmul against the JAX kernel (interpret mode) -----

def _qmm_inputs(R, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, K)).astype(np.float32)
    # Random bytes: every nibble value, -8 (0x8) included.
    q = rng.integers(-128, 128, size=(K if bits == 8 else K // 2, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.02 + 0.001).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("R", [1, 5, 64])
@pytest.mark.parametrize("bits,unpack", [(8, "auto"), (4, "shift"), (4, "float")])
def test_plain_matches_jax_kernel_f32(R, bits, unpack):
    """f32 x at the ragged (K, N) = (96, 200); tolerance 1e-5 relative to
    the output's largest magnitude (the sums are f32 in another order)."""
    x, q, scale = _qmm_inputs(R, 96, 200, bits, seed=R + bits)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                       bits=bits, interpret=True, unpack=unpack))
    got = tqmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(scale), bits=bits)
    assert got.dtype == torch.float32 and got.shape == (R, 200)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_matches_jax_kernel_bf16(bits):
    """bf16 x, bf16 out: 2e-2 relative to the largest magnitude (one bf16
    rounding of the output, after f32 sums in another order)."""
    x, q, scale = _qmm_inputs(16, 96, 200, bits, seed=40 + bits)
    xb = x.astype(jnp.bfloat16)
    want = np.asarray(jax_quant_matmul(jnp.asarray(xb), jnp.asarray(q), jnp.asarray(scale),
                                       bits=bits, interpret=True)).astype(np.float32)
    got = tqmm.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
                            torch.from_numpy(scale), bits=bits)
    assert got.dtype == torch.bfloat16
    tol = 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=tol)


def test_split_k_covers_k_in_whole_stages():
    for R in (1, 5, 64, 128):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000), (96, 200)):
            for bits, stage in ((8, 64), (4, 32)):
                splits, per = tqmm.split_k(R, K, N, bits)
                Kq = K if bits == 8 else K // 2
                assert per % stage == 0 and splits >= 1
                assert (splits - 1) * per < Kq <= splits * per   # no empty split
                assert splits * R * N * 4 <= max(Kq * N // 2, R * N * 4)


def test_wrapper_guards():
    """What the CUDA wrapper refuses (it raises, never falls back)."""
    x, q, s = torch.zeros(4, 96), torch.zeros(96, 200, dtype=torch.int8), torch.ones(1, 200)
    tqmm._check(x, q, s, 8, torch.float32)
    with pytest.raises(TypeError):
        tqmm._check(x.double(), q, s, 8, torch.float32)
    with pytest.raises(TypeError):
        tqmm._check(x, q.to(torch.uint8), s, 8, torch.float32)
    with pytest.raises(TypeError):
        tqmm._check(x, q, s.double(), 8, torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        tqmm._check(x, q, s, 4, torch.float32)
    with pytest.raises(ValueError, match="aligned"):
        tqmm._check(torch.zeros(4 * 96 + 1)[1:].view(4, 96), q, s, 8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tqmm._check(torch.zeros(96, 4).T, q, s, 8, torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        tqmm.quant_matmul(x.to("meta"), q.to("meta"), s.to("meta"), bits=8)


# (c) qtensor.matmul against the JAX qtensor.matmul ---------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    ("f32", None, 1e-5), ("f32", "f32", 1e-5), ("bf16", None, 2e-2),
    ("bf16", "f32", 1e-5),   # the lm_head call: bf16 hidden, f32 logits
])
def test_qtensor_matmul_matches_jax(bits, x_dtype, out_dtype, tol):
    w = _weights((64, 256), seed=bits)
    x = np.random.default_rng(5).standard_normal((7, 64)).astype(np.float32)
    jfn = jq.quantize_int8 if bits == 8 else jq.quantize_int4
    jw = jfn(jnp.asarray(w))
    tw = tq.QuantizedTensor(torch.from_numpy(np.array(jw.q)),
                            torch.from_numpy(np.array(jw.scale)))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, None: None}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, None: None}
    jx = jnp.asarray(x).astype(jdt[x_dtype])
    tx = torch.from_numpy(x).to(tdt[x_dtype])
    want = np.asarray(jq.matmul(jx, jw, preferred_element_type=jdt[out_dtype]))
    got = tq.matmul(tx, tw, out_dtype=tdt[out_dtype])
    assert got.dtype == tdt[out_dtype or x_dtype]
    want = want.astype(np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * np.abs(want).max())


def test_float_matmul_is_unchanged():
    """A float weight still goes to torch.matmul, f32 out as before."""
    x, w = torch.randn(3, 8), torch.randn(8, 5)
    torch.testing.assert_close(tq.matmul(x, w), x @ w, rtol=0, atol=0)
    xb, wb = x.bfloat16(), w.bfloat16()
    torch.testing.assert_close(tq.matmul(xb, wb, out_dtype=torch.float32),
                               xb.float() @ wb.float(), rtol=0, atol=0)


# (d) quantized forward against the JAX forward ------------------------------

@pytest.fixture(scope="module")
def quant_models():
    jd = jax_random_params(CFG_J, jax.random.PRNGKey(7), dtype=jnp.float32)
    jt = jax_random_params(CFG_J, jax.random.PRNGKey(8), dtype=jnp.float32)
    to_port = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    out = {"draft": (jd, to_port(jd))}
    for bits in (8, 4):
        jqt = jax_quantize_model(jt, bits=bits)
        out[bits] = (jqt, to_port(jqt))
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_params_carried_across(quant_models, bits):
    jqt, tqt = quant_models[bits]
    assert isinstance(tqt.layers.wq, tq.QuantizedTensor)
    assert tqt.layers.wq.q.dtype == torch.int8 and tqt.lm_head.scale.dtype == torch.float32
    np.testing.assert_array_equal(tqt.layers.w_down.q.numpy(), np.asarray(jqt.layers.w_down.q))
    np.testing.assert_array_equal(tqt.lm_head.scale.numpy(), np.asarray(jqt.lm_head.scale))
    assert model_bytes(tqt) == sum(x.size * x.dtype.itemsize
                                   for x in jax.tree.leaves(jqt))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_forward_matches_jax(quant_models, bits):
    """Prefill (write mode) then a verify (split mode) over the prefilled
    cache, int8 / int4 weights; the JAX forward runs its Pallas kernel in
    interpret mode. Logits allclose at 1e-4 (f32)."""
    jp, tp = quant_models[bits]
    n = 12
    toks, pos = np.arange(3, 3 + n) * 7 % CFG.vocab_size, np.arange(n)
    gm = uniform_tree(2, 2)
    ts = n - 1
    anc = gm.ancestors
    vt = (np.arange(gm.size) * 13 + 5) % CFG.vocab_size
    vpos = ts + gm.depth
    prev = jq._QMM_IMPL
    try:
        jq.set_quant_matmul_impl("pallas_interpret")
        jl1, jkv = jmodel.forward(jp, CFG_J, jnp.asarray(toks), jnp.asarray(pos),
                                  JKV.init(CFG_J, M, jnp.float32), 0, jmasks.causal_mask(n, M, 0))
        jmain, jscr = jmasks.split_tree_masks(anc, ts, M, False)
        jl2, _ = jmodel.forward(jp, CFG_J, jnp.asarray(vt), jnp.asarray(vpos), jkv, ts, jmain,
                                scratch=JKV.init(CFG_J, gm.size, jnp.float32),
                                scratch_offset=0, scratch_mask=jscr)
    finally:
        jq.set_quant_matmul_impl(prev)
    tkv = KVCache.init(CFG, M, torch.float32, "cpu")
    tl1, tkv = tmodel.forward(tp, CFG, torch.as_tensor(toks), torch.as_tensor(pos), tkv, 0,
                              tmasks.causal_mask(n, M, 0, "cpu"))
    tmain, tscr = tmasks.split_tree_masks(torch.as_tensor(anc), ts, M, False)
    tl2, _ = tmodel.forward(tp, CFG, torch.as_tensor(vt), torch.as_tensor(vpos), tkv, ts, tmain,
                            scratch=KVCache.init(CFG, gm.size, torch.float32, "cpu"),
                            scratch_offset=0, scratch_mask=tscr)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4, atol=1e-4)


# (e) greedy decoding with quantized targets ----------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_greedy_token_exact(quant_models, bits):
    """Greedy Sequoia with an int8 / int4 target: token-exact with the
    port's greedy AR and with the JAX engine (f32, uniform_tree(3, 2))."""
    jd, td = quant_models["draft"]
    jt, tt = quant_models[bits]
    jeng = JaxSpec(jd, CFG_J, jt, CFG_J, jax_uniform_tree(3, 2), algorithm="greedy",
                   max_length=128, prefill_chunk=16)
    eng = SpecEngine(td, CFG, tt, CFG, uniform_tree(3, 2), algorithm="greedy",
                     max_length=128, prefill_chunk=16, device="cpu")
    ar = ARBaseline(tt, CFG, max_length=128, greedy=True, prefill_chunk=16, device="cpu")
    rng = np.random.default_rng(3 + bits)
    for trial in range(2):
        prompt = rng.integers(3, CFG.vocab_size, size=9 + trial)
        want = jeng.generate(prompt, max_new_tokens=30, seed=trial)
        got = eng.generate(prompt, max_new_tokens=30, seed=trial)
        np.testing.assert_array_equal(got, want)
        exp = ar.generate(prompt, max_new_tokens=30)
        n = min(len(exp), len(got))
        assert n > len(prompt)
        np.testing.assert_array_equal(got[:n], exp[:n])


@pytest.mark.parametrize("bits", [8, 4])
def test_random_quantized_model_shapes(bits):
    cfg = port_config("test-tiny")
    p = random_quantized_model(cfg, 3, bits=bits, dtype=torch.float32, device="cpu")
    E, F = cfg.hidden_size, cfg.intermediate_size
    kq = (lambda k: k) if bits == 8 else (lambda k: k // 2)
    assert tuple(p.layers.w_gate.q.shape) == (cfg.num_layers, kq(E), F)
    assert tuple(p.layers.w_down.scale.shape) == (cfg.num_layers, 1, E)
    assert tuple(p.lm_head.q.shape) == (kq(E), cfg.vocab_size)
    assert p.embed.dtype == torch.float32 and p.layers.attn_norm.dtype == torch.float32
    assert (p.layers.wq.scale > 0).all()
    again = random_quantized_model(cfg, 3, bits=bits, dtype=torch.float32, device="cpu")
    assert torch.equal(again.layers.wq.q, p.layers.wq.q)   # seeded
    # quantize_model of a float tree gives the same layout.
    fq = quantize_model(random_params(cfg, 3, dtype=torch.float32, device="cpu"), bits=bits)
    assert fq.layers.w_gate.q.shape == p.layers.w_gate.q.shape
    assert model_bytes(p) < model_bytes(random_params(cfg, 3, dtype=torch.float32,
                                                      device="cpu"))


# (f) the latency-curve timer -------------------------------------------------

def test_time_forward_widths_on_cpu():
    p = random_params(CFG, 1, dtype=torch.float32, device="cpu")
    times = time_forward_widths(p, CFG, [1, 4], max_length=32, kv_len=8,
                                dtype=torch.float32, reps=2)
    assert len(times) == 2 and all(t > 0 for t in times)
    with pytest.raises(NotImplementedError):
        time_forward_widths(p, CFG, [1], batch=2)
    with pytest.raises(NotImplementedError):
        time_forward_widths(p, CFG, [1], kv_quant="int8")
    budgets, target_time, draft_time = measure_latency_curve(
        p, CFG, p, CFG, budgets=(1, 2), max_length=32, kv_len=8, dtype=torch.float32)
    assert budgets == [1, 2] and len(target_time) == 2 and draft_time > 0


# (g) the testbed's --quant -----------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_testbed_quant_on_cpu(capsys, quant):
    from sequoia_torch.cli.testbed import main

    main(["--draft", "test-tiny", "--target", "test-tiny", "--growmap", "tree:2x2",
          "--prompts", "synthetic:1,8", "--gen", "6", "--M", "64", "--dtype", "f32",
          "--quant", quant, "--device", "cpu"])
    assert "per-token latency" in capsys.readouterr().out
    main(["--target", "test-tiny", "--prompts", "synthetic:1,8", "--gen", "4", "--M", "64",
          "--dtype", "f32", "--quant", quant, "--mode", "baseline", "--device", "cpu"])
    assert "decoding steps (tokens): 4" in capsys.readouterr().out
