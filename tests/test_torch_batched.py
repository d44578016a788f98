"""The slot axis of the port's batched engine, below the engine, on the CPU
against the JAX package: the batched tree attention (the JAX Pallas kernel
vmapped, in interpret mode), the batched forward (JAX's forward vmapped over
caches batched on axis 1), the batched caches' commits and slot moves, the
batched latency curve, and no host read inside a batched iteration or
block. The engines' outputs are held against JAX's batched engines in
tests/test_torch_batched_serve.py; the CUDA kernel against its plain
version in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.core.model import forward as jax_forward  # noqa: E402
from sequoia_tpu.kernels.tree_attention import tree_attention as jax_tree_attention  # noqa: E402
from sequoia_tpu.kvcache.cache import (  # noqa: E402
    KVCache as JKVCache, KVCache4 as JKVCache4, KVCache8 as JKVCache8)
from sequoia_torch.cli.testbed import load_growmap  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.core.model import forward, forward_batched  # noqa: E402
from sequoia_torch.engine.batched import (  # noqa: E402
    BatchedAREngine, BatchedSpecEngine, choose_serving_mode)
from sequoia_torch.engine.engine import ALGORITHMS  # noqa: E402
from sequoia_torch.kernels.tree_attention import (  # noqa: E402
    counter, split_count, tile_extents, tree_attention_batched, tree_attention_plain)
from sequoia_torch.kvcache.cache import KV_CACHES, KVCache, KVCache4, slot_rows  # noqa: E402
from sequoia_torch.planner.profile import time_forward_widths  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

CFG_J = get_config("test-tiny")
CFG = port_config("test-tiny")
PROMPTS = [np.array([11, 23, 5, 99, 42, 7]), np.array([3, 1, 4, 1, 5, 9, 2, 6]),
           np.array([100, 50])]
FORMATS = ["float", "int8", "int4_head", "int4_dsplit"]
NEG_INF = float("-inf")


class _NoHostReads(TorchDispatchMode):
    """Raises on `aten._local_scalar_dense` (`.item()`, `bool(t)`, a 0-d
    tensor index), as in tests/test_torch_device_loop.py."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a host read inside the device loop")
        return func(*args, **(kwargs or {}))


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


# (a) the batched tree attention ------------------------------------------------

def _slots_case(B=3, Q=12, M=40, S=12, Hkv=2, g=2, D=16, seed=0):
    """Per-slot inputs: a prefix main mask with its own length per slot, a
    causal scratch mask (numpy, f32)."""
    rng = np.random.default_rng(seed)
    H = Hkv * g
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, Q, H, D), f(B, M, Hkv, D), f(B, M, Hkv, D)
    sk, sv = f(B, S, Hkv, D), f(B, S, Hkv, D)
    ts = np.array([5, 23, 37][:B] + [11] * max(0, B - 3))
    mask = np.arange(M)[None, None, :] < ts[:, None, None] + np.zeros((B, Q, 1), int)
    smask = np.broadcast_to(np.tril(np.ones((Q, S), bool)), (B, Q, S)).copy()
    return q, k, v, mask, sk, sv, smask, g, D


def _slot_rows(k, v, fmt):
    """Port rows (k, v, ks, vs) of every slot in `fmt`, and the f32 rows they
    stand for (JAX's kernel reads float rows; the JAX model dequantizes)."""
    from sequoia_torch.kvcache.cache import quantize_kv_rows, quantize_kv_rows4, unpack_kv_rows4

    if fmt == "float":
        return (torch.from_numpy(k), torch.from_numpy(v), None, None), (k, v)
    quant = quantize_kv_rows if fmt == "int8" else (
        lambda x: quantize_kv_rows4(x, packing=fmt[5:]))
    ints = (lambda x: x) if fmt == "int8" else (lambda x: unpack_kv_rows4(x, packing=fmt[5:]))
    (kq, ks), (vq, vs) = quant(torch.from_numpy(k)), quant(torch.from_numpy(v))
    deq = [(ints(x).float() * s[..., None]).numpy() for x, s in ((kq, ks), (vq, vs))]
    return (kq, vq, ks, vs), deq


@pytest.mark.parametrize("fmt", FORMATS)
def test_batched_plain_matches_vmapped_pallas(fmt):
    """`tree_attention_batched_plain` against the JAX kernel in interpret
    mode under `jax.vmap` (the batched engine's Pallas call), every cache
    format, within 1e-5; each slot equals the single plain call."""
    q, k, v, mask, sk, sv, smask, g, D = _slots_case()
    (kp, vp, ks, vs), (kd, vd) = _slot_rows(k, v, fmt)
    bias = lambda m: jnp.where(jnp.asarray(m), 0.0, NEG_INF).astype(jnp.float32)  # noqa: E731
    want = np.asarray(jax.vmap(lambda *a: jax_tree_attention(
        *a, g=g, scale=D ** -0.5, block_m=32, interpret=True))(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), bias(mask), jnp.asarray(sk),
        jnp.asarray(sv), bias(smask)))
    t = torch.from_numpy
    got = tree_attention_batched(t(q), kp, vp, t(mask), t(sk), t(sv), t(smask),
                                 scale=D ** -0.5, ks=ks, vs=vs)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for b in range(q.shape[0]):
        one = tree_attention_plain(t(q[b]), kp[b], vp[b], t(mask[b]), t(sk[b]), t(sv[b]),
                                   t(smask[b]), scale=D ** -0.5,
                                   ks=None if ks is None else ks[b],
                                   vs=None if vs is None else vs[b])
        assert torch.equal(got[b], one)


def test_batched_attention_route_bookkeeping():
    """Each slot gets its own prefix skip; the split count counts every
    slot's (tile, head) pairs; batched launches have counters of their own."""
    q, k, v, mask, sk, sv, smask, g, D = _slots_case(Q=20)
    ext = tile_extents(torch.from_numpy(mask), torch.from_numpy(smask))
    assert ext.shape == (3, 2, 2)
    assert ext[:, 0, 0].tolist() == [5, 23, 37]   # main keys read: the slot's prefix
    for b in range(3):
        assert torch.equal(ext[b], tile_extents(torch.from_numpy(mask[b]),
                                                torch.from_numpy(smask[b])))
    # 8 slots of the 7B verify (Q 64, H 32) fill an H100 without splitting.
    assert split_count(64, 32, 512, 64, sms=132, batch=8) == 1
    assert split_count(64, 32, 512, 64, sms=132, batch=1) == 3
    assert split_count(64, 32, 512, 64, sms=132, dtype=torch.float32, batch=8) == 1
    assert counter("int4_dsplit", torch.float32, batched=True) == \
        "tree_attention_batched_kv4_dsplit_f32"
    assert counter("float", torch.bfloat16, batched=True) == "tree_attention_batched"


# (b) the batched caches ---------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_batched_cache_commit_and_slot_moves(kv_quant):
    """A batched commit equals each slot's single commit (a window past a
    slot's end cut to its last row); take / put / copy move whole slots."""
    B, M, S = 3, 24, 6
    gen = torch.Generator().manual_seed(0)
    cache = KV_CACHES[kv_quant].init(CFG, M, torch.float32, device="cpu", batch=B)
    singles = [KV_CACHES[kv_quant].init(CFG, M, torch.float32, device="cpu") for _ in range(B)]
    scr = KVCache.init(CFG, S, torch.float32, "cpu", batch=B)
    for t in scr.tensors():
        t.copy_(torch.randn(t.shape, generator=gen))
    src = torch.tensor([[0, 2, 2], [5, 1, 0], [3, 4, 4]])
    dest = torch.tensor([4, 0, 22])          # slot 2's window runs one row past M
    cache.commit_rows(scr, src, dest)
    for b in range(B):
        one = KVCache(k=scr.k[:, b], v=scr.v[:, b])
        singles[b].commit_rows(one, src[b, :2] if b == 2 else src[b],
                               int(dest[b]))
        if b == 2:   # the cut row: the last write of the window lands on row M - 1
            singles[b].commit_rows(one, src[b, 2:], M - 1)
        for x, y in zip(singles[b].tensors(), cache.tensors()):
            assert torch.equal(x, y[:, b])
    assert slot_rows(torch.tensor([[1, 30]]), 24).tolist() == [1, 23]
    sub = KV_CACHES[kv_quant].init(CFG, M, torch.float32, device="cpu", batch=2)
    idx = torch.tensor([2, 0])
    cache.take_slots(idx, sub)
    for x, y in zip(sub.tensors(), cache.tensors()):
        assert torch.equal(x, y[:, [2, 0]])
    before = [t.clone() for t in cache.tensors()]
    for t in sub.tensors():
        t.add_(1)
    cache.put_slots(sub, idx)
    for x, y, s in zip(cache.tensors(), before, sub.tensors()):
        assert torch.equal(x[:, 1], y[:, 1]) and torch.equal(x[:, [2, 0]], s)
    cache.copy_slot(1, singles[0])
    for x, y in zip(cache.tensors(), singles[0].tensors()):
        assert torch.equal(x[:, 1], y)
    if kv_quant == "int4":
        assert KVCache4.init(CFG, M, packing="dsplit", device="cpu", batch=B).packing == "dsplit"


# (c) the batched forward ----------------------------------------------------------

_JCACHE = {None: JKVCache, "int8": JKVCache8, "int4": JKVCache4}


def _jax_slots_forward(params, kv_quant, toks, pos, prefill_mask, split):
    """JAX: the chunk prefill of every slot, then a split-mode forward over
    per-slot prefixes, each vmapped with caches batched on axis 1 (the
    batched engine's placement). Returns the split forward's logits."""
    B, Q = toks.shape
    cls = _JCACHE[kv_quant]
    kv_axes = cls(*([1] * len(cls._fields)))
    kv = jax.vmap(lambda _: cls.init(CFG_J, 32, jnp.float32), out_axes=kv_axes)(jnp.arange(B))

    def write(kv, t, p):
        return jax_forward(params, CFG_J, t, p, kv, 0, jnp.asarray(prefill_mask))[1]

    kv = jax.vmap(write, in_axes=(kv_axes, 0, 0), out_axes=kv_axes)(
        kv, jnp.asarray(toks), jnp.asarray(pos))
    stoks, spos, smain, sscr = split

    def tree(kv, t, p, m):
        scratch = JKVCache.init(CFG_J, t.shape[0], jnp.float32)
        return jax_forward(params, CFG_J, t, p, kv, 0, m, scratch=scratch, scratch_offset=0,
                           scratch_mask=jnp.asarray(sscr))[0]

    return np.asarray(jax.vmap(tree, in_axes=(kv_axes, 0, 0, 0))(
        kv, jnp.asarray(stoks), jnp.asarray(spos), jnp.asarray(smain)))


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_forward_batched_matches_vmapped_jax(models, kv_quant):
    """Logits of a batched chunk prefill followed by a batched split-mode
    tree forward (per-slot prefixes) against JAX's forward vmapped over the
    slot axis, at atol 1e-5; every slot's logits and cache bits equal the
    single forward's."""
    _, jt, _, tt = models
    B, Q, M, W = 3, 8, 32, 4
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab_size, (B, Q))
    pos = np.broadcast_to(np.arange(Q), (B, Q)).copy()
    prefill_mask = np.arange(M)[None, :] <= np.arange(Q)[:, None]
    ts = np.array([3, 8, 6])
    stoks = rng.integers(0, CFG.vocab_size, (B, W))
    spos = ts[:, None] + np.arange(W)
    smain = np.broadcast_to(np.arange(M)[None, None, :] < ts[:, None, None], (B, W, M)).copy()
    sscr = np.tril(np.ones((W, W), bool))
    want = _jax_slots_forward(jt, kv_quant, toks, pos, prefill_mask, (stoks, spos, smain, sscr))

    t = torch.from_numpy
    kv = KV_CACHES[kv_quant].init(CFG, M, torch.float32, device="cpu", batch=B)
    forward_batched(tt, CFG, t(toks), t(pos), kv, torch.zeros(B, dtype=torch.long),
                    t(prefill_mask).expand(B, Q, M))
    scratch = KVCache.init(CFG, W, torch.float32, "cpu", batch=B)
    got, _ = forward_batched(tt, CFG, t(stoks), t(spos), kv, t(ts), t(smain),
                             scratch=scratch, scratch_offset=0,
                             scratch_mask=t(sscr).expand(B, W, W))
    assert got.shape == (B, W, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for b in range(B):
        one = KV_CACHES[kv_quant].init(CFG, M, torch.float32, device="cpu")
        forward(tt, CFG, t(toks[b]), t(pos[b]), one, 0, t(prefill_mask))
        for x, y in zip(one.tensors(), kv.tensors()):
            assert torch.equal(x, y[:, b])
        logits, _ = forward(tt, CFG, t(stoks[b]), t(spos[b]), one, int(ts[b]), t(smain[b]),
                            scratch=KVCache.init(CFG, W, torch.float32, "cpu"),
                            scratch_offset=0, scratch_mask=t(sscr))
        assert torch.equal(logits, got[b])


def test_forward_batched_needs_a_batched_cache(models):
    tt = models[3]
    with pytest.raises(TypeError):
        forward_batched(tt, CFG, torch.zeros(1, 2, dtype=torch.long),
                        torch.zeros(1, 2, dtype=torch.long),
                        KVCache.init(CFG, 8, torch.float32, "cpu"), torch.zeros(1),
                        torch.ones(1, 2, 8, dtype=torch.bool))


# (d) engine edges -------------------------------------------------------------------

def test_choose_serving_mode():
    assert choose_serving_mode(0.012, 3.0, 0.010) == "spec"
    assert choose_serving_mode(0.020, 3.0, 0.002) == "ar"
    assert choose_serving_mode(0.010, 1.0, 0.010) == "ar"   # a tie goes to AR


def test_batched_options_raise(models):
    """admit_width 0 raises (JAX's loop would never end), as do an empty
    batch, harvest_batch 0, a wrong prompt count and a prompt too long."""
    _, _, td, tt = models
    gm = uniform_tree(2, 2)
    for kw in ({"admit_width": 0}, {"batch_size": 0}, {"harvest_batch": 0}):
        with pytest.raises(ValueError):
            BatchedSpecEngine(td, CFG, tt, CFG, gm, device="cpu", **kw)
    with pytest.raises(ValueError):
        BatchedAREngine(tt, CFG, batch_size=0, device="cpu")
    eng = BatchedSpecEngine(td, CFG, tt, CFG, gm, batch_size=2, max_length=48,
                            prefill_chunk=16, device="cpu", algorithm="greedy")
    assert eng.admit_width == 2
    with pytest.raises(ValueError):
        eng.generate_batch(PROMPTS, max_new_tokens=4)
    with pytest.raises(ValueError):
        eng.serve_device([np.arange(30) % 50 + 1], max_new_tokens=4)   # past M - C - size
    with pytest.raises(ValueError):
        eng.serve_device([], max_new_tokens=4)


def test_batched_latency_curve(models):
    """`time_forward_widths(batch=2)` times the batched forward, one cache
    per slot in the serving format (an int8 one here; a float one in
    tests/test_torch_quant.py)."""
    curve = time_forward_widths(models[3], CFG, [1, 4], max_length=32, kv_len=8,
                                dtype=torch.float32, reps=1, batch=2, kv_quant="int8")
    assert len(curve) == 2 and all(x > 0 for x in curve)


# (e) no host read inside a batched iteration or block -------------------------------

@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_batched_iteration_and_block_read_nothing_back(models, algo, kv_quant):
    """A batched iteration (the planned 64-node growmap, 2 slots) and a
    block of two, an admission step and a batched AR step make no host
    read (`_local_scalar_dense`)."""
    _, _, td, tt = models
    eng = BatchedSpecEngine(td, CFG, tt, CFG, load_growmap("planned"), batch_size=2,
                            algorithm=algo, max_length=96, temperature=0.7, prefill_chunk=16,
                            kv_quant=kv_quant, device="cpu")
    st = eng.prefill_batch(PROMPTS[:2], seed=0)
    eng._arm_slots(40, 96, [True, True])
    with _NoHostReads():
        eng.iterate_batch(st)
        for _ in range(2):
            eng._iteration()
        eng._admit_step(st)
    assert int(eng._bsteps) == 3
    ar = BatchedAREngine(tt, CFG, batch_size=2, max_length=64, greedy=algo == "greedy",
                         temperature=0.7, prefill_chunk=16, kv_quant=kv_quant, device="cpu")
    ar._fill(PROMPTS[:2], 0)
    ar._arm_slots(3, 64, [True, True])
    with _NoHostReads():
        for _ in range(4):
            ar._iteration()
    assert ar._bproduced.tolist() == [3, 3] and int(ar._bsteps) == 3


def test_slots_that_are_not_live_keep_their_tokens(models):
    """A slot past its budget, and an inactive slot at the very end of its
    buffer, keep their committed tokens and length through iterations
    (their windows cut to the buffer's last row)."""
    _, _, td, tt = models
    eng = BatchedSpecEngine(td, CFG, tt, CFG, uniform_tree(3, 2), batch_size=2,
                            algorithm="sequoia", max_length=40, prefill_chunk=16,
                            temperature=0.7, device="cpu")
    st = eng.prefill_batch(PROMPTS[:2], seed=0)
    st.gtl[1] = 40          # a full buffer
    before = st.tokens.clone()
    eng._arm_slots(4, 40, [True, False])
    for _ in range(4):
        eng._iteration()
    assert st.gtl[1] == 40 and torch.equal(st.tokens[1], before[1])
    g0 = int(st.gtl[0])
    assert g0 - len(PROMPTS[0]) == int(eng._bproduced[0])
    assert int(eng._bproduced[0]) >= 4 or bool(st.terminal[0])
    assert torch.equal(st.tokens[0, :6], before[0, :6])
    eng._iteration()    # past the budget: nothing more
    assert int(st.gtl[0]) == g0
