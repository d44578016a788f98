"""The port's int8 / int4 KV caches against the JAX package, on the CPU in
f32 (test-tiny; weights and inputs from numpy seeds, handed to both sides).

Row quantizers, packings, `commit_rows`, the plain tree attention over each
cache format, `forward` with `KVCache8` / `KVCache4` (prefill, then a split
verify), and the engines with each `kv_quant`. On a CPU tensor the port's
attention wrapper runs its plain version; the CUDA kernel is held against it
by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core import model as jmodel  # noqa: E402
from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine.baseline import ARBaseline as JaxAR  # noqa: E402
from sequoia_tpu.engine.engine import SpecEngine as JaxSpec  # noqa: E402
from sequoia_tpu.kvcache import cache as jcache  # noqa: E402
from sequoia_tpu.ops import masks as jmasks  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.core import model as tmodel  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.engine.baseline import ARBaseline  # noqa: E402
from sequoia_torch.engine.engine import SpecEngine  # noqa: E402
from sequoia_torch.kernels.tree_attention import (  # noqa: E402
    cache_format, tree_attention, tree_attention_plain)
from sequoia_torch.kvcache import cache as tcache  # noqa: E402
from sequoia_torch.ops import masks as tmasks  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")
M = 64
# (kv_quant, int4 packing): the three quantized cache formats.
FORMATS = [("int8", None), ("int4", "head"), ("int4", "dsplit")]


def _rows(shape, seed):
    """Float rows with a spread of magnitudes per (row, head)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * rng.uniform(0.05, 4.0, size=shape[:-1] + (1,)).astype(np.float32)


def _caches(kv_quant, packing, max_length=M):
    """A fresh (JAX, port) pair of main caches."""
    if kv_quant == "int8":
        return (jcache.KVCache8.init(CFG_J, max_length),
                tcache.KVCache8.init(CFG, max_length, device="cpu"))
    return (jcache.KVCache4.init(CFG_J, max_length, packing=packing),
            tcache.KVCache4.init(CFG, max_length, packing=packing, device="cpu"))


def _assert_cache_equal(tkv, jkv):
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(getattr(tkv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), err_msg=name)


# (a) row quantizers and packings ------------------------------------------------

def test_quantize_kv_rows_bit_identical():
    """int8 rows: the same bytes and the same f32 scales, exactly (a true
    division and round-half-to-even on both sides); no clip, as in JAX."""
    x = _rows((7, 4, 16), seed=0)
    x[0, 0] = 0.0                                  # an all-zero row: scale 1e-8 / 127
    x[1, 1, :4] = [2.5, -2.5, 3.5, 127.0]          # exact ties once scaled
    # scale 7/64 exactly; 6.5 and 12.5 scales: ties that a multiplication by
    # the scale's f32 reciprocal would round up to 7 and 13.
    x[3, 2] = np.clip(x[3, 2], -13, 13)
    x[3, 2, :3] = [13.890625, 0.7109375, 1.3671875]
    jq_, js = jcache.quantize_kv_rows(jnp.asarray(x))
    tq_, ts = tcache.quantize_kv_rows(torch.from_numpy(x))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (7, 4)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq_[1, 1, :4].tolist() == [2, -2, 4, 127] and tq_[3, 2, :3].tolist() == [127, 6, 12]


@pytest.mark.parametrize("packing", ["head", "dsplit"])
def test_quantize_kv_rows4_bit_identical(packing):
    """int4 rows: clipped to +-7, two to a byte; the bytes (high nibbles
    that wrap the int8 included) and the scales equal JAX's, and unpack to
    the same values."""
    x = _rows((5, 4, 16), seed=1)
    x[2, 3] = -np.abs(x[2, 3])                     # all-negative high nibbles
    jq_, js = jcache.quantize_kv_rows4(jnp.asarray(x), packing=packing)
    tq_, ts = tcache.quantize_kv_rows4(torch.from_numpy(x), packing=packing)
    assert tq_.shape == ((5, 2, 16) if packing == "head" else (5, 4, 8))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    vals = tcache.unpack_kv_rows4(tq_, packing=packing)
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jcache.unpack_kv_rows4(jq_, packing=packing)))
    want = np.clip(np.round(x / ts.numpy()[..., None]), -7, 7)
    np.testing.assert_array_equal(vals.numpy(), want)


@pytest.mark.parametrize("packing", ["head", "dsplit"])
def test_unpack_kv_rows4_every_byte(packing):
    """Every byte value, so every nibble pair (-8 included), unpacks alike."""
    packed = np.arange(-128, 128).astype(np.int8).reshape(2, 2, 64)
    got = tcache.unpack_kv_rows4(torch.from_numpy(packed), packing=packing)
    want = np.asarray(jcache.unpack_kv_rows4(jnp.asarray(packed), packing=packing))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_init_shapes_and_packing():
    for kv_quant, packing in FORMATS:
        jkv, tkv = _caches(kv_quant, packing)
        for name in ("k", "v", "ks", "vs"):
            assert tuple(getattr(tkv, name).shape) == getattr(jkv, name).shape
        assert tkv.k.dtype == torch.int8 and tkv.ks.dtype == torch.float32
        assert tkv.max_length == M
        if kv_quant == "int4":
            assert tkv.packing == jkv.packing == packing
    assert tcache.KVCache4.init(CFG, 8, device="cpu").packing == "head"   # auto, Hkv even
    with pytest.raises(ValueError):
        tcache.KVCache4.init(CFG, 8, packing="rows", device="cpu")


@pytest.mark.parametrize("kv_quant,packing", FORMATS)
def test_commit_rows_matches_jax(kv_quant, packing):
    """Float scratch rows (repeats as padding) quantized at commit into the
    window at a device-tensor offset: the same cache, bit for bit; rows
    outside the window stay zero with scale zero."""
    L, Hkv, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim_
    sk, sv = _rows((L, 7, Hkv, D), seed=2), _rows((L, 7, Hkv, D), seed=3)
    src = np.array([0, 3, 5, 5])
    jkv, tkv = _caches(kv_quant, packing)
    jkv = jkv.commit_rows(jcache.KVCache(jnp.asarray(sk), jnp.asarray(sv)),
                          jnp.asarray(src), 9)
    out = tkv.commit_rows(tcache.KVCache(torch.from_numpy(sk), torch.from_numpy(sv)),
                          torch.from_numpy(src), torch.tensor(9))
    assert out is tkv                              # in place
    _assert_cache_equal(tkv, jkv)
    assert not tkv.ks[:, :9].any() and not tkv.k[:, 13:].any() and tkv.ks[:, 9:13].all()


# (b) the plain tree attention over each cache format -----------------------------

def _attention_case(kv_quant, packing, seed):
    """Rows quantized into one layer of a cache, float scratch rows, a
    prefix main mask over the written rows and a tree scratch mask."""
    rng = np.random.default_rng(seed)
    Q, S, Hkv, g, D, written = 5, 5, 2, 2, 16, 23
    q = rng.standard_normal((Q, Hkv * g, D)).astype(np.float32)
    k, v = _rows((written, Hkv, D), seed + 1), _rows((written, Hkv, D), seed + 2)
    sk, sv = _rows((S, Hkv, D), seed + 3), _rows((S, Hkv, D), seed + 4)
    quant = (tcache.quantize_kv_rows if kv_quant == "int8" else
             lambda x: tcache.quantize_kv_rows4(x, packing=packing))
    (kq, ks), (vq, vs) = quant(torch.from_numpy(k)), quant(torch.from_numpy(v))
    pad = lambda t: torch.cat([t, t.new_zeros((M - written,) + t.shape[1:])])  # noqa: E731
    main = torch.arange(M)[None, :] < torch.tensor([[written - 2]] * 3 + [[written]] * 2)
    scr = torch.tril(torch.ones(Q, S, dtype=torch.bool))
    t = torch.from_numpy
    return (t(q), pad(kq), pad(vq), main, t(sk), t(sv), scr), (pad(ks), pad(vs))


@pytest.mark.parametrize("kv_quant,packing", FORMATS)
def test_plain_attention_folds_the_scales_exactly(kv_quant, packing):
    """Attention over integer rows with the scales folded into scores and
    probabilities equals float attention over the dequantized rows (1e-5:
    the same f32 products in another order), and unwritten rows (scale 0,
    masked) change nothing."""
    args, (ks, vs) = _attention_case(kv_quant, packing, seed=10)
    q, kq, vq, main, sk, sv, scr = args
    fmt = cache_format(kq, 2, 16)
    assert fmt == ("int8" if kv_quant == "int8" else f"int4_{packing}")
    got = tree_attention(*args, scale=0.25, ks=ks, vs=vs)   # CPU: the plain version
    ints = (lambda x: x) if kv_quant == "int8" else (
        lambda x: tcache.unpack_kv_rows4(x, packing=packing))
    kf, vf = ints(kq).float() * ks[..., None], ints(vq).float() * vs[..., None]
    want = tree_attention_plain(q, kf, vf, main, sk, sv, scr, scale=0.25)
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="needs ks and vs"):
        from sequoia_torch.kernels.tree_attention import _check
        _check(*args, None, None)


# (c) forward with a quantized cache against the JAX forward ------------------------

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
    return jd, to_port(jd), jt, to_port(jt)


def _assert_bytes_equal_up_to_ties(name, got, want, floats, scales, levels):
    """The two frameworks' projections differ in their last f32 bits, so a
    value that sits on a rounding tie may land on either side. A cache byte
    may differ from JAX's only there: by one step, and only where the
    port's own `x / scale` is within 1e-3 of a half-integer. Returns the
    number of such bytes."""
    diff = np.argwhere(got != want)
    for idx in map(tuple, diff):
        assert abs(int(got[idx]) - int(want[idx])) == 1, (name, idx)
        frac = abs(floats[idx] / scales[idx[:-1]]) % 1.0
        assert abs(frac - 0.5) < 1e-3 and abs(floats[idx] / scales[idx[:-1]]) < levels, \
            (name, idx, frac)
    return len(diff)


@pytest.mark.parametrize("kv_quant,packing", FORMATS)
def test_forward_quantized_cache_matches_jax(models, kv_quant, packing):
    """Prefill (write mode: the new rows are quantized into the cache before
    attention) and a split verify over the prefilled cache (main read-only,
    float scratch). The cache holds JAX's bytes and scales (bytes up to
    rounding ties, see `_assert_bytes_equal_up_to_ties`; scales to 1e-6
    relative), and the logits agree at 1e-4 (f32), which assumes no tie
    flipped a byte: with one, 5e-3."""
    _, _, jt, tt = models
    n = 12
    toks, pos = np.arange(3, 3 + n) * 7 % CFG.vocab_size, np.arange(n)
    gm = uniform_tree(2, 2)
    ts, anc = n - 1, gm.ancestors
    vt = (np.arange(gm.size) * 13 + 5) % CFG.vocab_size
    vpos = ts + gm.depth
    jkv0, tkv = _caches(kv_quant, packing)
    quantized, quantize_rows = [], tkv.quantize_rows   # the float rows the port quantizes
    tkv.quantize_rows = lambda x: (quantized.append(x.clone()), quantize_rows(x))[1]
    jl1, jkv = jmodel.forward(jt, CFG_J, jnp.asarray(toks), jnp.asarray(pos), jkv0, 0,
                              jmasks.causal_mask(n, M, 0))
    jmain, jscr = jmasks.split_tree_masks(anc, ts, M, False)
    jl2, jscratch = jmodel.forward(
        jt, CFG_J, jnp.asarray(vt), jnp.asarray(vpos), jkv, ts, jmain,
        scratch=jcache.KVCache.init(CFG_J, gm.size, jnp.float32), scratch_offset=0,
        scratch_mask=jscr)
    tl1, out = tmodel.forward(tt, CFG, torch.as_tensor(toks), torch.as_tensor(pos), tkv, 0,
                              tmasks.causal_mask(n, M, 0, "cpu"))
    assert out is tkv
    before = [t.clone() for t in (tkv.k, tkv.v, tkv.ks, tkv.vs)]
    tmain, tscr = tmasks.split_tree_masks(torch.as_tensor(anc), ts, M, False)
    scratch = tcache.KVCache.init(CFG, gm.size, torch.float32, "cpu")
    tl2, out = tmodel.forward(tt, CFG, torch.as_tensor(vt), torch.as_tensor(vpos), tkv, ts,
                              tmain, scratch=scratch, scratch_offset=0, scratch_mask=tscr)
    assert out is scratch and scratch.k.dtype == torch.float32
    for a, b in zip(before, (tkv.k, tkv.v, tkv.ks, tkv.vs)):
        assert torch.equal(a, b)                   # split mode: main cache read-only
    np.testing.assert_allclose(scratch.k.numpy(), np.asarray(jscratch.k), rtol=1e-4, atol=1e-5)

    # The cache against JAX's: unpack int4 so that a tie moves one value.
    unpack = (lambda x: x) if kv_quant == "int8" else (
        lambda x: tcache.unpack_kv_rows4(torch.from_numpy(x), packing=packing).numpy())
    assert len(quantized) == 2 * CFG.num_layers    # k then v, layer by layer
    flips = 0
    for i, name in enumerate(("k", "v")):
        ints = unpack(getattr(tkv, name).numpy())
        jints = unpack(np.array(getattr(jkv, name)))
        scales = getattr(tkv, name + "s").numpy()
        np.testing.assert_allclose(scales, np.asarray(getattr(jkv, name + "s")), rtol=1e-6)
        assert scales[:, :n].all() and not scales[:, n:].any() and not ints[:, n:].any()
        floats = torch.stack(quantized[i::2]).numpy()          # [L, n, Hkv, D]
        flips += _assert_bytes_equal_up_to_ties(
            name, ints[:, :n], jints[:, :n], floats, scales[:, :n],
            127 if kv_quant == "int8" else 7)
    tol = 1e-4 if flips == 0 else 5e-3
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=tol, atol=tol)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=tol, atol=tol)


# (d) the engines with each kv_quant ------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_greedy_spec_token_exact_with_jax(models, kv_quant):
    """Greedy speculative decoding with an int8 / int4 target cache: the
    same tokens as the JAX engine, on the verify recipe (uniform_tree(3, 2),
    max_length 128, prefill chunks of 16). Not equal to greedy AR: verify
    reads float scratch rows that AR has already quantized."""
    jd, td, jt, tt = models
    jeng = JaxSpec(jd, CFG_J, jt, CFG_J, jax_uniform_tree(3, 2), algorithm="greedy",
                   max_length=128, prefill_chunk=16, kv_quant=kv_quant)
    eng = SpecEngine(td, CFG, tt, CFG, uniform_tree(3, 2), algorithm="greedy",
                     max_length=128, prefill_chunk=16, kv_quant=kv_quant, device="cpu")
    assert eng._kv4_packing == jeng._kv4_packing == "head"
    prompt = np.array([11, 23, 5, 99, 42, 7])
    want = jeng.generate(prompt, max_new_tokens=30, seed=0)
    got = eng.generate(prompt, max_new_tokens=30, seed=0)
    assert len(got) > len(prompt)
    np.testing.assert_array_equal(got, want)
    state = eng.prefill(prompt)
    assert isinstance(state.target_kv, tcache.KV_CACHES[kv_quant])
    assert isinstance(state.draft_kv, tcache.KVCache)          # the draft's stays float
    assert state.draft_kv.k.dtype == torch.float32


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_greedy_ar_token_exact_with_jax(models, kv_quant):
    """The AR baseline with a quantized cache (prefill writes quantized rows,
    every step commits one quantized row): the JAX baseline's tokens."""
    _, _, jt, tt = models
    prompt = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    want = JaxAR(jt, CFG_J, max_length=64, greedy=True, prefill_chunk=16,
                 kv_quant=kv_quant).generate(prompt, max_new_tokens=20)
    got = ARBaseline(tt, CFG, max_length=64, greedy=True, prefill_chunk=16,
                     kv_quant=kv_quant, device="cpu").generate(prompt, max_new_tokens=20)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
@pytest.mark.parametrize("algo", ["sequoia", "specinfer", "greedys"])
def test_stochastic_algorithms_run_with_kv_quant(models, algo, kv_quant):
    _, td, _, tt = models
    eng = SpecEngine(td, CFG, tt, CFG, uniform_tree(2, 2), algorithm=algo, max_length=96,
                     temperature=0.7, top_p=0.9, prefill_chunk=16, kv_quant=kv_quant,
                     device="cpu")
    out = eng.generate(np.array([11, 23, 5, 99]), max_new_tokens=12, seed=1)
    assert len(out) > 4 and out.min() >= 0 and out.max() < CFG.vocab_size


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_testbed_kv_quant_on_cpu(capsys, kv_quant):
    from sequoia_torch.cli.testbed import main

    main(["--draft", "test-tiny", "--target", "test-tiny", "--growmap", "tree:2x2",
          "--prompts", "synthetic:1,8", "--gen", "6", "--M", "64", "--dtype", "f32",
          "--kv-quant", kv_quant, "--device", "cpu"])
    assert "per-token latency" in capsys.readouterr().out
    main(["--target", "test-tiny", "--prompts", "synthetic:1,8", "--gen", "4", "--M", "64",
          "--dtype", "f32", "--kv-quant", kv_quant, "--mode", "baseline", "--device", "cpu"])
    assert "decoding steps (tokens): 4" in capsys.readouterr().out
