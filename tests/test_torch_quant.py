"""The port's weight quantization against the JAX package, on the CPU.

Quantizers, layouts, the quantized matmul's plain version (against the JAX
Pallas kernel in interpret mode), `qtensor.matmul`, the quantized forward,
greedy decoding with quantized targets, the latency-curve timer, the
testbed's `--quant`, and (h-k) the activation-quantized kernels (w4a8,
w8a8), the panel-tiled int4 kernel, the w8a8 route with `eroute`, and a
tiled model carried across from JAX. Inputs are numpy arrays from `np.random.default_rng`,
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
from sequoia_tpu.kernels.quant_matmul import (  # noqa: E402
    quant_matmul_tiled as jax_quant_matmul_tiled)
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
from sequoia_torch.quant import eroute  # noqa: E402
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
    # batch > 1 times the batched forward (one cache per slot).
    batched = time_forward_widths(p, CFG, [1, 4], max_length=32, kv_len=8, dtype=torch.float32,
                                  reps=1, batch=2)
    assert len(batched) == 2 and all(t > 0 for t in batched)
    with pytest.raises(ValueError):
        time_forward_widths(p, CFG, [1], batch=0)
    with pytest.raises(ValueError):
        time_forward_widths(p, CFG, [1], kv_quant="int2")
    for kv_quant in ("int8", "int4"):
        assert time_forward_widths(p, CFG, [2], max_length=32, kv_len=8, dtype=torch.float32,
                                   reps=1, kv_quant=kv_quant)[0] > 0
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


# (h) activation quantization and the int8-activation kernels' plain versions ----

@pytest.fixture
def w8a8_mode():
    """Both packages' global w8a8 switch, restored after the test."""
    yield
    tq.set_w8a8("auto", min_rows=96)
    jq.set_w8a8("auto", min_rows=96)


def _jax_quantize_activations(x):
    """The JAX package's activation quantizer: it has no function of its
    own there (`kernels/quant_matmul.py:361-364`, `quant/qtensor.py:178-181`)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    return np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)), np.asarray(sx)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_bit_identical(dtype):
    """x8 and sx equal JAX's exactly: a true division, round half to even
    (exact ties and an all-zero row included)."""
    x = np.random.default_rng(11).standard_normal((9, 96)).astype(np.float32) * 3
    x[0] = 0.0
    x[1, :6] = [127.0, 63.5, -63.5, 0.5, 1.5, -2.5]   # amax 127: sx = 1, exact ties
    x[1, 6:] = np.clip(x[1, 6:], -100, 100)
    # amax 889/64: sx = 7/64 exactly, and 6.5 sx, 12.5 sx are ties that a
    # multiplication by the f32 reciprocal of sx would round up to 7 and 13.
    x[2] = np.clip(x[2], -13, 13)
    x[2, :3] = [13.890625, 0.7109375, 1.3671875]
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want8, wants = _jax_quantize_activations(jx)
    got8, gots = tqmm.quantize_activations(tx)
    assert got8.dtype == torch.int8 and gots.dtype == torch.float32 and gots.shape == (9, 1)
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(gots.numpy(), wants)
    assert got8[1, :6].tolist() == [127, 64, -64, 0, 2, -2]
    if dtype == "f32":
        assert got8[2, :3].tolist() == [127, 6, 12]


@pytest.mark.parametrize("R", [1, 5, 64])
@pytest.mark.parametrize("K,N", [(96, 200), (256, 384)])
def test_w4a8_plain_matches_jax_kernel(R, K, N):
    """`unpack="w4a8"` against the JAX kernel in interpret mode: x8 and the
    int32 products are exact on both sides and the f32 rescale runs in the
    same order, so 1e-6 relative (in practice equal bits)."""
    x, q, scale = _qmm_inputs(R, K, N, 4, seed=R + K)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                       bits=4, interpret=True, unpack="w4a8"))
    got = tqmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(scale), bits=4, unpack="w4a8")
    assert got.dtype == torch.float32 and got.shape == (R, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # bf16 x, f32 out (the lm_head's call shape).
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q),
                                       jnp.asarray(scale), bits=4, interpret=True,
                                       unpack="w4a8", out_dtype=jnp.float32))
    got = tqmm.quant_matmul(xb, torch.from_numpy(q), torch.from_numpy(scale), bits=4,
                            unpack="w4a8", out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_unpack_argument():
    """"auto", "shift" and "float" are one kernel; "w4a8" is int4 only."""
    x, q, scale = (torch.from_numpy(a) for a in _qmm_inputs(3, 96, 200, 4, seed=2))
    base = tqmm.quant_matmul(x, q, scale, bits=4)
    for unpack in ("auto", "shift", "float"):
        assert torch.equal(tqmm.quant_matmul(x, q, scale, bits=4, unpack=unpack), base)
    assert not torch.equal(tqmm.quant_matmul(x, q, scale, bits=4, unpack="w4a8"), base)
    with pytest.raises(ValueError):
        tqmm.quant_matmul(x, q, scale, bits=4, unpack="w8a8")
    q8 = torch.zeros(96, 200, dtype=torch.int8)
    with pytest.raises(ValueError):
        tqmm.quant_matmul(x, q8, scale, bits=8, unpack="w4a8")


# (i) the panel-tiled int4 kernel's plain version ---------------------------------

@pytest.mark.parametrize("R,K,N", [(8, 64, 256), (16, 128, 200), (96, 256, 384)])
def test_tiled_plain_matches_jax_kernel(R, K, N):
    """`quant_matmul_tiled` against the JAX kernel (interpret mode) over the
    same panels, ragged N included: 1e-5 relative (f32 sums in another
    order); and equal to the row-major int4 product."""
    x, q, scale = _qmm_inputs(R, K, N, 4, seed=R + N)
    jt = jq.tile_int4(jq.QuantizedTensor(jnp.asarray(q), jnp.asarray(scale)))
    tt = tq.tile_int4(tq.QuantizedTensor(torch.from_numpy(q), torch.from_numpy(scale)))
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    want = np.asarray(jax_quant_matmul_tiled(jnp.asarray(x), jt.q, jt.scale, interpret=True))
    got = tqmm.quant_matmul_tiled(torch.from_numpy(x), tt.q, tt.scale)
    assert got.shape == (R, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    row_major = tqmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                                  torch.from_numpy(scale), bits=4)
    assert torch.equal(got, row_major)


def test_tiled_plain_takes_any_panel_width_and_kernel_guards():
    x, q, scale = (torch.from_numpy(a) for a in _qmm_inputs(4, 64, 40, 4, seed=9))
    t16 = tq.tile_int4(tq.QuantizedTensor(q, scale), bn0=16)
    assert t16.q.shape == (3, 32, 16)
    assert torch.equal(tqmm.quant_matmul_tiled(x, t16.q, t16.scale),
                       tqmm.quant_matmul(x, q, scale, bits=4))
    with pytest.raises(ValueError, match="128-column panels"):
        tqmm._check(x, t16.q, t16.scale, 4, torch.float32, tiled=True)
    t128 = tq.tile_int4(tq.QuantizedTensor(q, scale))
    tqmm._check(x, t128.q, t128.scale, 4, torch.float32, tiled=True)
    with pytest.raises(ValueError, match="panels"):
        tqmm._check(x, t128.q, torch.ones(1, 200), 4, torch.float32, tiled=True)


# (j) qtensor.matmul: tiled weights, and the w8a8 route with eroute ----------------

@pytest.mark.parametrize("x_dtype,out_dtype,tol", [("f32", None, 1e-5), ("bf16", "f32", 1e-5),
                                                   ("bf16", None, 2e-2)])
def test_qtensor_matmul_tiled_matches_jax(x_dtype, out_dtype, tol):
    w = _weights((64, 200), seed=21)
    x = np.random.default_rng(6).standard_normal((7, 64)).astype(np.float32)
    jw = jq.tile_int4(jq.quantize_int4(jnp.asarray(w)))
    tw = tq.tile_int4(tq.quantize_int4(torch.from_numpy(w)))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, None: None}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, None: None}
    prev = jq._QMM_IMPL
    try:
        jq.set_quant_matmul_impl("pallas_interpret")
        want = np.asarray(jq.matmul(jnp.asarray(x).astype(jdt[x_dtype]), jw,
                                    preferred_element_type=jdt[out_dtype])).astype(np.float32)
    finally:
        jq.set_quant_matmul_impl(prev)
    got = tq.matmul(torch.from_numpy(x).to(tdt[x_dtype]), tw, out_dtype=tdt[out_dtype])
    assert got.dtype == tdt[out_dtype or x_dtype]
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("x_dtype,out_dtype,tol", [("f32", None, 1e-6), ("bf16", "f32", 1e-6),
                                                   ("bf16", None, 1e-2)])
def test_qtensor_matmul_w8a8_matches_jax(w8a8_mode, x_dtype, out_dtype, tol):
    """`set_w8a8("on")`: int8 activations x int8 weights, exact integer
    products and the same f32 rescale: 1e-6 (a bf16 output: one rounding)."""
    w = _weights((64, 256), seed=8)
    x = np.random.default_rng(5).standard_normal((7, 64)).astype(np.float32)
    jw = jq.quantize_int8(jnp.asarray(w))
    tw = tq.QuantizedTensor(torch.from_numpy(np.array(jw.q)),
                            torch.from_numpy(np.array(jw.scale)))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, None: None}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, None: None}
    jx, tx = jnp.asarray(x).astype(jdt[x_dtype]), torch.from_numpy(x).to(tdt[x_dtype])
    weight_only = tq.matmul(tx, tw, out_dtype=tdt[out_dtype])
    jq.set_w8a8("on")
    tq.set_w8a8("on")
    want = np.asarray(jq.matmul(jx, jw, preferred_element_type=jdt[out_dtype])).astype(np.float32)
    got = tq.matmul(tx, tw, out_dtype=tdt[out_dtype])
    assert got.dtype == tdt[out_dtype or x_dtype]
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * np.abs(want).max())
    assert not torch.equal(got, weight_only)       # the activations were quantized
    # int4 weights never take the route, as in JAX.
    t4 = tq.quantize_int4(torch.from_numpy(w))
    tq.set_w8a8("off")
    off = tq.matmul(tx, t4)
    tq.set_w8a8("on")
    assert torch.equal(tq.matmul(tx, t4), off)


def test_w8a8_auto_is_off_on_the_cpu(w8a8_mode):
    """"auto" = a tensor on the card with at least `min_rows` rows; on a
    CPU tensor it is off, as in JAX on the CPU."""
    x = torch.zeros(128, 8)
    assert tq._W8A8 == "auto" and tq._W8A8_MIN_ROWS == 96
    assert not tq._use_w8a8(x)
    assert tq._use_w8a8(x.to("meta")) is False     # not a CUDA tensor either
    tq.set_w8a8("on", min_rows=4)
    assert tq._use_w8a8(x[:1]) and tq._W8A8_MIN_ROWS == 4
    tq.set_w8a8("off")
    assert not tq._use_w8a8(x)
    with pytest.raises(ValueError):
        tq.set_w8a8("maybe")


def test_eroute_mirrors_jax(w8a8_mode):
    """The routing decision and its constants equal the JAX module's."""
    from sequoia_tpu.quant import eroute as jeroute

    assert eroute.MEASURED_ACCEPT_DELTA == jeroute.MEASURED_ACCEPT_DELTA
    assert eroute.MEASURED_ACCEPT_DELTA["w8a8"] == pytest.approx(-0.277, abs=1e-9)
    for base, w8a8, delta in ((16.5e-3, 12.0e-3, None), (16.5e-3, 15.5e-3, None),
                              (16.5e-3, 15.5e-3, -0.05)):
        got = eroute.w8a8_choice(base, w8a8, 3.757, accept_delta=delta)
        assert tuple(got) == tuple(jeroute.w8a8_choice(base, w8a8, 3.757, accept_delta=delta))
    assert eroute.w8a8_choice(16.5e-3, 12.0e-3, 3.757).use_w8a8           # a big latency win
    small = eroute.w8a8_choice(16.5e-3, 15.5e-3, 3.757)
    assert not small.use_w8a8 and small.e_w8a8 == pytest.approx(3.48, abs=1e-6)
    assert eroute.e_adjusted_tokens_per_sec(3.48, 15.5e-3) < \
        eroute.e_adjusted_tokens_per_sec(3.757, 16.5e-3)
    assert eroute.w8a8_choice(16.5e-3, 15.5e-3, 3.757, accept_delta=-0.05).use_w8a8


def test_route_w8a8_flips_global_switch(w8a8_mode):
    eroute.route_w8a8(16.5e-3, 12.0e-3, 3.757)
    assert tq._W8A8 == "on"
    eroute.route_w8a8(16.5e-3, 15.5e-3, 3.757)
    assert tq._W8A8 == "off"


# (k) a tiled int4 model, and the w8a8 forward, against JAX -------------------------

def _tile_model(params, tile, with_fields):
    """`tile_int4` over the seven projections and the head, as
    `scripts/probe_int4_panels.py` builds its target."""
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    layers = with_fields(params.layers, {n: tile(getattr(params.layers, n)) for n in names})
    return with_fields(params, {"layers": layers, "lm_head": tile(params.lm_head)})


def _prefill_and_verify(forward, params, cfg, kv, scratch, masks, asarray):
    n, gm = 12, uniform_tree(2, 2)
    toks, pos = np.arange(3, 3 + n) * 7 % CFG.vocab_size, np.arange(n)
    l1, kv = forward(params, cfg, asarray(toks), asarray(pos), kv, 0, masks.causal_mask(n, M, 0))
    main, scr = masks.split_tree_masks(asarray(gm.ancestors), n - 1, M, False)
    vt = (np.arange(gm.size) * 13 + 5) % CFG.vocab_size
    l2, _ = forward(params, cfg, asarray(vt), asarray(n - 1 + gm.depth), kv, n - 1, main,
                    scratch=scratch, scratch_offset=0, scratch_mask=scr)
    return np.asarray(l1), np.asarray(l2)


def _port_logits(tp):
    class PortMasks:
        causal_mask = staticmethod(lambda n, m, off: tmasks.causal_mask(n, m, off, "cpu"))
        split_tree_masks = staticmethod(tmasks.split_tree_masks)

    with torch.no_grad():
        l1, l2 = _prefill_and_verify(
            tmodel.forward, tp, CFG, KVCache.init(CFG, M, torch.float32, "cpu"),
            KVCache.init(CFG, 7, torch.float32, "cpu"), PortMasks, torch.as_tensor)
    return l1, l2


def test_tiled_model_carried_across_and_forward_matches_jax(quant_models):
    """A JAX model tiled with `tile_int4` crosses `params_from_numpy` with
    its panels unchanged (a tiled leaf has one more axis than its scale),
    and both forwards compute the same logits (1e-4, f32; the JAX side runs
    its tiled kernel in interpret mode)."""
    j4, _ = quant_models[4]
    jtiled = _tile_model(j4, jq.tile_int4, lambda t, kw: t._replace(**kw))
    ttiled = params_from_numpy(jax.tree.map(np.asarray, jtiled), device="cpu")
    assert tq.is_tiled(ttiled.layers.wq) and tq.is_tiled(ttiled.lm_head)
    assert ttiled.layers.w_gate.q.shape == jtiled.layers.w_gate.q.shape   # [L, nt, Kq, 128]
    np.testing.assert_array_equal(ttiled.lm_head.q.numpy(), np.asarray(jtiled.lm_head.q))
    prev = jq._QMM_IMPL
    try:
        jq.set_quant_matmul_impl("pallas_interpret")
        want = _prefill_and_verify(jmodel.forward, jtiled, CFG_J, JKV.init(CFG_J, M, jnp.float32),
                                   JKV.init(CFG_J, 7, jnp.float32), jmasks, jnp.asarray)
    finally:
        jq.set_quant_matmul_impl(prev)
    for got, exp in zip(_port_logits(ttiled), want):
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)


def test_w8a8_forward_matches_jax(quant_models, w8a8_mode):
    """The int8 target with w8a8 forced on, prefill and verify: logits at
    1e-4 (f32), the weight-only forward's tolerance. The activations of both
    frameworks quantize to the same int8 values on these inputs (the logits
    agree to 2e-7); an activation on a rounding tie could land one step
    apart and move a logit by about 1e-4 of its magnitude, which this
    tolerance would show. The w8a8 logits differ from the weight-only ones
    by 5e-3, so the check also shows that the route was taken."""
    j8, t8 = quant_models[8]
    weight_only = _port_logits(t8)
    jq.set_w8a8("on")
    tq.set_w8a8("on")
    want = _prefill_and_verify(jmodel.forward, j8, CFG_J, JKV.init(CFG_J, M, jnp.float32),
                               JKV.init(CFG_J, 7, jnp.float32), jmasks, jnp.asarray)
    got = _port_logits(t8)
    for g, e, wo in zip(got, want, weight_only):
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4)
        assert np.abs(g - wo).max() > 1e-3
