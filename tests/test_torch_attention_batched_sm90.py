"""The Hopper slot-axis tree attention's decomposition on the CPU:
`tree_attention_batched_sm90_model` (work items of 64 query rows of one KV
head, key tiles of 64 (bf16) or 16 (f32) keys, 3xTF32 for f32) against the
JAX kernel in interpret mode under `jax.vmap` (the batched engine's Pallas
call), every main-cache format and both dtypes; and the routing rule and its
bookkeeping (`sm90_route`: Q > 16 queries a slot and work items for 3/4 of
the SMs take the Hopper kernel's counters, every other call the slot-grid
route's). The
CUDA kernel itself is held to its plain version in tests/test_torch_cuda.py
(cuda-marked) and chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.kernels.tree_attention import tree_attention as jax_tree_attention  # noqa: E402
from sequoia_torch.kernels import tree_attention as ta  # noqa: E402
from sequoia_torch.kvcache.cache import (  # noqa: E402
    quantize_kv_rows, quantize_kv_rows4, unpack_kv_rows4)

FORMATS = ["float", "int8", "int4_head", "int4_dsplit"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# Stated tolerances, of the largest |output|: f32 keeps f32's accuracy
# (3xTF32 sums truncate, the JAX kernel rounds otherwise); bf16 rounds the
# probabilities (and, in the JAX reference, the dequantized rows) to bf16.
TOL = {"f32": 1e-5, "bf16": 2e-2}
B, Hkv = 3, 2
# (Q, D, g, S): every Q in {17, 64, 80}, D in {64, 128}, g in {1, 2}, S in
# {0, 64}.
CASES = [(17, 64, 1, 64), (64, 128, 1, 64), (80, 64, 2, 0), (64, 128, 2, 0)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(Q, D, g, S, M=64, seed=0, dead=True):
    """Per-slot inputs from numpy: main masks that are each slot's own
    prefix (5, 37 and all 64 keys), a causal scratch mask, and (`dead`) a
    middle row of the last slot that attends nothing. M is a multiple of the
    JAX kernel's key block: it pads M, and a row that attends nothing gets
    the mean over the padded rows there."""
    rng = np.random.default_rng(seed + Q + D + g + S)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, Q, Hkv * g, D), f(B, M, Hkv, D), f(B, M, Hkv, D)
    sk, sv = f(B, S, Hkv, D), f(B, S, Hkv, D)
    ts = np.array([5, 37, M])
    mask = np.arange(M)[None, None, :] < ts[:, None, None] + np.zeros((B, Q, 1), int)
    smask = np.broadcast_to(np.tril(np.ones((Q, S), bool)), (B, Q, S)).copy()
    if dead:
        mask[B - 1, Q // 2] = False
        smask[B - 1, Q // 2] = False
    return q, k, v, mask, sk, sv, smask


def _port_rows(k, v, fmt):
    """(k, v, ks, vs) of the port in `fmt`, and the f32 rows they stand for."""
    if fmt == "float":
        return (torch.from_numpy(k), torch.from_numpy(v), None, None), (k, v)
    quant = quantize_kv_rows if fmt == "int8" else (
        lambda x: quantize_kv_rows4(x, packing=fmt[5:]))
    ints = (lambda x: x) if fmt == "int8" else (lambda x: unpack_kv_rows4(x, packing=fmt[5:]))
    (kq, ks), (vq, vs) = quant(torch.from_numpy(k)), quant(torch.from_numpy(v))
    return (kq, vq, ks, vs), [(ints(x).float() * s[..., None]).numpy() for x, s in
                              ((kq, ks), (vq, vs))]


def _jax_reference(q, kd, vd, mask, sk, sv, smask, g, D, jdt):
    """The JAX kernel under vmap in interpret mode. It takes no empty
    scratch: S = 0 runs with 8 masked scratch rows, which add zero to every
    row that attends a key (S = 0 cases have no row that attends nothing)."""
    if sk.shape[1] == 0:
        sk = sv = np.zeros((B, 8, Hkv, D), np.float32)
        smask = np.zeros((B, q.shape[1], 8), bool)
    bias = lambda m: jnp.where(jnp.asarray(m), 0.0, -jnp.inf).astype(jnp.float32)  # noqa: E731
    x = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    out = jax.vmap(lambda *a: jax_tree_attention(*a, g=g, scale=D ** -0.5, block_m=32,
                                                 interpret=True))(
        x(q), x(kd), x(vd), bias(mask), x(sk), x(sv), bias(smask))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("Q,D,g,S", CASES)
def test_sm90_model_matches_vmapped_pallas(Q, D, g, S, fmt, dtype):
    """The model of the Hopper kernel against the JAX kernel under vmap,
    within TOL[dtype] of the largest |output|."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, mask, sk, sv, smask = _inputs(Q, D, g, S, dead=S > 0)
    (kp, vp, ks, vs), (kd, vd) = _port_rows(k, v, fmt)
    if tdt == torch.bfloat16 and fmt == "float":
        kp, vp = kp.to(tdt), vp.to(tdt)
    t = lambda a: torch.from_numpy(a).to(tdt) if a.dtype == np.float32 else torch.from_numpy(a)  # noqa: E731,E501
    got = ta.tree_attention_batched_sm90_model(
        t(q), kp, vp, t(mask), t(sk), t(sv), t(smask), scale=D ** -0.5, ks=ks, vs=vs)
    assert got.shape == q.shape and got.dtype == tdt
    want = _jax_reference(q, kd, vd, mask, sk, sv, smask, g, D, jdt)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sm90_model_rows_that_attend_nothing(dtype):
    """With an empty scratch, a row that attends no key gets the mean of
    the main V rows in the model as in the plain version; each slot keeps
    its own prefix skip (`tile_extents` over the flattened rows)."""
    tdt = DTYPES[dtype][0]
    q, k, v, mask, sk, sv, smask = (torch.from_numpy(a) for a in _inputs(80, 64, 2, 0))
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    got = ta.tree_attention_batched_sm90_model(q, k, v, mask, sk.to(tdt), sv.to(tdt), smask,
                                               scale=64 ** -0.5)
    want = ta.tree_attention_batched_plain(q, k, v, mask, sk.to(tdt), sv.to(tdt), smask,
                                           scale=64 ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item()
    mean_v = v[B - 1].float().mean(dim=0)                      # [Hkv, D]
    dead = got[B - 1, 40].float().view(Hkv, 2, 64)             # query 40's four heads
    torch.testing.assert_close(dead, mean_v[:, None].expand(Hkv, 2, 64),
                               rtol=TOL[dtype], atol=TOL[dtype])
    rows = mask.repeat_interleave(2, 1), smask.repeat_interleave(2, 1)
    ext = ta.tile_extents(*rows, rows=ta.SM90_ROWS)
    assert ext.shape == (B, 3, 2)
    assert ext[:2, :, 0].tolist() == [[5, 5, 5], [37, 37, 37]]
    assert ext[2, :, 0].tolist() == [64, 64, 64]               # the dead row's tile walks all


def test_sm90_routing_bookkeeping():
    """The Hopper kernel's counters and the slot-grid route's, per format
    and dtype; on the CPU both routes are the plain version."""
    for fmt, suffix in (("float", ""), ("int8", "_kv8"), ("int4_head", "_kv4_head"),
                        ("int4_dsplit", "_kv4_dsplit")):
        for dtype, tail in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            assert ta.counter(fmt, dtype, batched=True) == \
                f"tree_attention_batched{suffix}{tail}"
            assert ta.counter(fmt, dtype, batched=True, sm90=True) == \
                f"tree_attention_batched_sm90{suffix}{tail}"
            assert ta.counter(fmt, dtype) == f"tree_attention{suffix}{tail}"
    from sequoia_torch.kernels import build
    assert all(ta.counter(f, d, batched=True, sm90=True) in build.launches
               for f in FORMATS for d in (torch.bfloat16, torch.float32))
    q, k, v, mask, sk, sv, smask = (torch.from_numpy(a) for a in _inputs(17, 64, 1, 64))
    got = ta.tree_attention_batched(q, k, v, mask, sk, sv, smask, scale=0.125)
    assert torch.equal(got, ta.tree_attention_batched_plain(q, k, v, mask, sk, sv, smask,
                                                            scale=0.125))


# (B, Q, H, Hkv, route on an H100's 132 SMs, 99 work items at least): the
# rule reads shapes alone.
ROUTES = [
    (8, 64, 32, 32, True),     # the 7B batched verify / prefill chunk: 256 work items
    (8, 16, 32, 32, False),    # Q <= 16: a 16-query tile reads each K/V tile once
    (1, 64, 32, 32, False),    # one slot: 32 items would leave 100 SMs idle
    (2, 64, 32, 32, False),    # 64 items
    (4, 64, 32, 32, True),     # 128 items
    (8, 64, 8, 8, False),      # distill's training forward (8 heads): 64 items
    (25, 32, 4, 4, True),      # test-small at 25 slots: 100 items
    (24, 32, 4, 4, False),     # 96 items
    (2, 64, 64, 8, True),      # g = 8: 512 rows, 8 items a KV head, 128 in all
]


@pytest.mark.parametrize("B,Q,H,Hkv,want", ROUTES)
def test_sm90_route_fills_the_card(B, Q, H, Hkv, want):
    """The Hopper kernel takes a call only where Q > 16 and its work items
    (B x Hkv x ceil(Q g / 64)) number at least 3/4 of the SMs."""
    assert ta.sm90_route(B, Q, H, Hkv, 132) is want
