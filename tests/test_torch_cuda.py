"""The CUDA kernels against their plain versions, on the card. Skips
without a CUDA device. The file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from sequoia_torch.kernels import quant_matmul as qmm
from sequoia_torch.kernels import top_p as tp
from sequoia_torch.kernels.tree_attention import (counter, split_count, tree_attention,
                                                  tree_attention_batched,
                                                  tree_attention_batched_plain,
                                                  tree_attention_plain)
from sequoia_torch.kvcache.cache import quantize_kv_rows, quantize_kv_rows4
from sequoia_torch.quant.qtensor import QuantizedTensor, tile_int4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _attention_inputs(Q, M, S, Hkv, g, D, dtype):
    rng = np.random.default_rng(Q + M + S)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    mask = torch.from_numpy(rng.random((Q, M)) < 0.7).cuda()
    mask[:, 0] = True
    smask = torch.tril(torch.ones(Q, S, dtype=torch.bool)).cuda()
    return t(Q, Hkv * g, D), t(M, Hkv, D), t(M, Hkv, D), mask, t(S, Hkv, D), t(S, Hkv, D), smask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Q,M,S,Hkv,g,D", [
    (64, 256, 64, 32, 1, 128),   # 7B verify
    (13, 256, 64, 12, 1, 64),    # 68m grow level
    (9, 48, 11, 2, 2, 16),       # test-tiny GQA, ragged
    (128, 256, 0, 4, 2, 32),     # prefill, empty scratch
    (1, 256, 1, 32, 1, 128),     # AR step
    (15, 256, 64, 32, 1, 128),   # one ragged query tile
    (17, 200, 64, 32, 1, 128),   # a ragged second tile, M not a multiple of 16
])
def test_tree_attention_kernel_matches_plain(Q, M, S, Hkv, g, D, dtype, tol):
    _need_cuda()
    args = _attention_inputs(Q, M, S, Hkv, g, D, dtype)
    got = tree_attention(*args, scale=D ** -0.5)
    want = tree_attention_plain(*args, scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fmt", ["int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("Q,M,S,Hkv,g,D", [
    (64, 256, 64, 32, 1, 128),   # 7B verify
    (1, 256, 1, 32, 1, 128),     # AR step
    (128, 256, 0, 32, 1, 128),   # prefill, empty scratch
    (9, 48, 11, 2, 2, 16),       # test-tiny GQA, ragged; a dsplit row has 8 bytes
    (21, 64, 21, 4, 1, 32),      # test-small; a dsplit row has 16 bytes
    (15, 256, 64, 32, 1, 128),   # one ragged query tile
    (17, 200, 64, 32, 1, 128),   # a ragged second tile, M not a multiple of 16
])
def test_tree_attention_quantized_cache_matches_plain(Q, M, S, Hkv, g, D, fmt, dtype, tol):
    """The main cache as int8 / int4 rows with per-row scales, the rows past
    M - 5 never written (zero bytes, scale 0, masked): the kernel against
    the plain version in the same dtype, at the float kernel's tolerances."""
    _need_cuda()
    q, k, v, mask, sk, sv, smask = _attention_inputs(Q, M, S, Hkv, g, D, dtype)
    mask[:, M - 5:] = False
    quant = quantize_kv_rows if fmt == "int8" else (
        lambda x: quantize_kv_rows4(x, packing=fmt[5:]))
    (kq, ks), (vq, vs) = quant(k), quant(v)
    for t in (kq, vq, ks, vs):
        t[M - 5:] = 0
    args = (q, kq, vq, mask, sk, sv, smask)
    name = counter(fmt, dtype)
    before = qmm.build.launches[name]
    got = tree_attention(*args, scale=D ** -0.5, ks=ks, vs=vs)
    assert qmm.build.launches[name] == before + 1
    want = tree_attention_plain(*args, scale=D ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _cache(k, v, fmt):
    if fmt == "float":
        return k, v, None, None
    quant = quantize_kv_rows if fmt == "int8" else (
        lambda x: quantize_kv_rows4(x, packing=fmt[5:]))
    (kq, ks), (vq, vs) = quant(k), quant(v)
    return kq, vq, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("Q,M,S,ts", [
    (64, 256, 64, 191),   # 7B verify: the prefix ends mid-tile, a dead tail past it
    (1, 256, 1, 37),      # AR step, a short prefix
    (17, 200, 16, 150),   # ragged tiles, M not a multiple of 16
])
def test_tree_attention_prefix_mask_matches_plain(Q, M, S, ts, fmt, dtype, tol):
    """The engine's mask: a per-row prefix k < ts, so the bf16 kernel skips
    the tiles past ts; the same answer as the plain version."""
    _need_cuda()
    q, k, v, _, sk, sv, smask = _attention_inputs(Q, M, S, 32, 1, 128, dtype)
    mask = (torch.arange(M, device="cuda") < ts)[None].expand(Q, M).contiguous()
    kc, vc, ks, vs = _cache(k, v, fmt)
    args = (q, kc, vc, mask, sk, sv, smask)
    got = tree_attention(*args, scale=128 ** -0.5, ks=ks, vs=vs)
    want = tree_attention_plain(*args, scale=128 ** -0.5, ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
def test_tree_attention_row_with_no_live_key(fmt, dtype, tol):
    """A valid row that attends no key gets the mean of all V rows (as the
    plain version and the JAX kernel give it): its tile walks everything,
    past the prefix of the other rows."""
    _need_cuda()
    Q, M, S = 20, 256, 16
    q, k, v, _, sk, sv, smask = _attention_inputs(Q, M, S, 32, 1, 128, dtype)
    mask = (torch.arange(M, device="cuda") < 100)[None].expand(Q, M).contiguous()
    mask[3] = False
    smask[3] = False
    kc, vc, ks, vs = _cache(k, v, fmt)
    args = (q, kc, vc, mask, sk, sv, smask)
    got = tree_attention(*args, scale=128 ** -0.5, ks=ks, vs=vs)
    want = tree_attention_plain(*args, scale=128 ** -0.5, ks=ks, vs=vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("Q,S,want", [(1, 1, {torch.bfloat16: 5, torch.float32: 3}),
                                      (64, 64, {torch.bfloat16: 3, torch.float32: 1})])
def test_tree_attention_split_count_on_the_card(Q, S, want, dtype, tol):
    """The split count the wrapper picks at the 7B AR step and verify: bf16,
    at least two blocks per SM unless every warp already has one key tile
    (5 and 3 on a 132-SM H100); f32, one wave of at most one block per SM
    unless every warp of 8 has one key tile (3 and 1); the kernel runs once,
    with the workspace it needs."""
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = split_count(Q, 32, 256, S, sms, dtype)
    tiles = 256 // 16 + -(-S // 16)
    blocks = -(-Q // 16) * 32 * splits
    if dtype == torch.bfloat16:
        assert splits == -(-tiles // 4) or blocks >= 2 * sms
    else:
        assert splits == 1 or splits == -(-tiles // 8) or blocks <= sms
    if sms == 132:
        assert splits == want[dtype]
    args = _attention_inputs(Q, 256, S, 32, 1, 128, dtype)
    name = counter("float", dtype)
    before = qmm.build.launches[name]
    got = tree_attention(*args, scale=128 ** -0.5)
    assert qmm.build.launches[name] == before + 1
    want_out = tree_attention_plain(*args, scale=128 ** -0.5)
    torch.testing.assert_close(got.float(), want_out.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("B,Q,M,S,Hkv,g,D", [
    (8, 64, 512, 64, 32, 1, 128),   # 8 slots of the 7B verify
    (3, 9, 48, 11, 2, 2, 16),       # test-tiny GQA, ragged; a dsplit row has 8 bytes
    (2, 1, 256, 1, 32, 1, 128),     # 2 slots of the 7B AR step
    (4, 20, 200, 0, 4, 2, 32),      # a prefill chunk, empty scratch
])
def test_tree_attention_batched_kernel_matches_plain(B, Q, M, S, Hkv, g, D, fmt, dtype, tol):
    """The slot-axis launch against the plain version slot by slot: each
    slot its own prefix (one slot with a row that attends nothing), every
    cache format, one launch counted on the counter of the route it takes."""
    from sequoia_torch.kernels import tree_attention as ta

    _need_cuda()
    rng = np.random.default_rng(B + Q + M)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    q, k, v, sk, sv = t(B, Q, Hkv * g, D), t(B, M, Hkv, D), t(B, M, Hkv, D), \
        t(B, S, Hkv, D), t(B, S, Hkv, D)
    ts = torch.from_numpy(rng.integers(1, M, size=B)).cuda()
    mask = (torch.arange(M, device="cuda")[None, None, :] < ts[:, None, None]).expand(
        B, Q, M).contiguous()
    smask = torch.tril(torch.ones(Q, S, dtype=torch.bool, device="cuda")).expand(
        B, Q, S).contiguous()
    mask[B - 1, Q // 2] = False
    smask[B - 1, Q // 2] = False
    kc, vc, ks, vs = _cache(k, v, fmt)
    args = (q, kc, vc, mask, sk, sv, smask)
    sm90 = ta.sm90_route(B, Q, Hkv * g, Hkv, ta._sm_count(0))   # B = 8 at 32 heads: Hopper's
    name = counter(fmt, dtype, batched=True, sm90=sm90)
    before = qmm.build.launches[name]
    got = tree_attention_batched(*args, scale=D ** -0.5, ks=ks, vs=vs)
    assert qmm.build.launches[name] == before + 1
    want = tree_attention_batched_plain(*args, scale=D ** -0.5, ks=ks, vs=vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fmt", ["float", "int8", "int4_head", "int4_dsplit"])
@pytest.mark.parametrize("B,Q,M,S,Hkv,g,D", [
    (3, 17, 100, 64, 2, 1, 64),     # a ragged 64-row tile
    (3, 64, 90, 64, 2, 1, 128),     # the verify's tile, a ragged main region
    (2, 80, 70, 0, 2, 2, 64),       # g = 2: 160 rows, three tiles, no scratch
    (2, 64, 128, 0, 2, 2, 128),     # g = 2, no scratch
    (2, 33, 40, 24, 4, 2, 16),      # head dim 16; a dsplit row has 8 bytes
    (2, 40, 64, 20, 2, 1, 32),      # head dim 32: the 64-byte swizzle
    (2, 64, 4096, 64, 2, 1, 128),   # llama-2's 4096-key context
    (2, 80, 8192, 0, 2, 2, 64),     # 8192 keys, g = 2
])
def test_tree_attention_batched_sm90_matches_plain(B, Q, M, S, Hkv, g, D, fmt, dtype, tol):
    """The Hopper slot-axis kernel against the plain version: mixed
    prefixes, a slot whose middle row attends nothing, every format, dtype
    and head dim, and contexts of 4096 and 8192 keys (the shared memory
    does not grow with M)."""
    from sequoia_torch.kernels import tree_attention as ta

    _need_cuda()
    rng = np.random.default_rng(B + Q + M + D)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    q, k, v, sk, sv = t(B, Q, Hkv * g, D), t(B, M, Hkv, D), t(B, M, Hkv, D), \
        t(B, S, Hkv, D), t(B, S, Hkv, D)
    ts = torch.from_numpy(rng.integers(1, M, size=B)).cuda()
    mask = (torch.arange(M, device="cuda")[None, None, :] < ts[:, None, None]).expand(
        B, Q, M).contiguous()
    smask = torch.tril(torch.ones(Q, S, dtype=torch.bool, device="cuda")).expand(
        B, Q, S).contiguous()
    mask[B - 1, Q // 2] = False
    smask[B - 1, Q // 2] = False
    kc, vc, ks, vs = _cache(k, v, fmt)
    args = (q, kc, vc, mask, sk, sv, smask)
    name = counter(fmt, dtype, batched=True, sm90=True)
    before = qmm.build.launches[name]
    got = ta._launch_sm90(q, kc, vc, mask, sk, sv, smask, ks, vs, fmt, D ** -0.5, B, Q,
                          Hkv * g, Hkv, D, M, S, name)
    assert qmm.build.launches[name] == before + 1
    want = tree_attention_batched_plain(*args, scale=D ** -0.5, ks=ks, vs=vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again = ta._launch_sm90(q, kc, vc, mask, sk, sv, smask, ks, vs, fmt, D ** -0.5, B, Q,
                            Hkv * g, Hkv, D, M, S, name)
    assert torch.equal(got, again)   # no atomics: the same bits every launch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fill", ["at the fill", "one slot short"])
def test_tree_attention_batched_routes_by_fill(fill, dtype, tol):
    """`tree_attention_batched` at Q = 64 takes the Hopper kernel where the
    work items (slot x KV head here) number SM90_FILL of the SMs, and the
    slot-grid route with one slot fewer; each matches the plain version."""
    from sequoia_torch.kernels import tree_attention as ta

    _need_cuda()
    Hkv, Q, M, S, D = 4, 64, 192, 64, 64
    B = -(-math.ceil(ta.SM90_FILL * ta._sm_count(0)) // Hkv) - (fill == "one slot short")
    rng = np.random.default_rng(B)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    q, k, v, sk, sv = t(B, Q, Hkv, D), t(B, M, Hkv, D), t(B, M, Hkv, D), \
        t(B, S, Hkv, D), t(B, S, Hkv, D)
    ts = torch.from_numpy(rng.integers(1, M, size=B)).cuda()
    mask = (torch.arange(M, device="cuda")[None, None, :] < ts[:, None, None]).expand(
        B, Q, M).contiguous()
    smask = torch.tril(torch.ones(Q, S, dtype=torch.bool, device="cuda")).expand(
        B, Q, S).contiguous()
    sm90 = fill == "at the fill"
    assert ta.sm90_route(B, Q, Hkv, Hkv, ta._sm_count(0)) == sm90
    before = dict(qmm.build.launches)
    got = tree_attention_batched(q, k, v, mask, sk, sv, smask, scale=D ** -0.5)
    for route in (True, False):
        name = counter("float", dtype, batched=True, sm90=route)
        assert qmm.build.launches[name] == before[name] + (route == sm90), name
    want = tree_attention_batched_plain(q, k, v, mask, sk, sv, smask, scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("rows,vocab", [(64, 32000), (1, 32000), (7, 1000)])
def test_top_p_kernels_match_plain(rows, vocab, top_p):
    """The fused kernel and the plain bisection see the same probabilities
    and sum masses in f64: identical thresholds. The from-logits kernel
    does its own softmax, an ulp away from torch.softmax: identical nuclei
    except an ill-conditioned boundary token (`boundary_disagreements`),
    and |dt| <= 1e-6 on every row whose nucleus agrees."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(rows)
    logits = torch.randn(rows, vocab, generator=gen, device="cuda") * 3
    probs = torch.softmax(logits / 0.6, dim=-1)
    got = tp.top_p_threshold_fused(probs, top_p)
    torch.testing.assert_close(got, tp.top_p_threshold_plain(probs, top_p), rtol=0, atol=0)
    got = tp.top_p_threshold_from_logits(logits, top_p, 0.6)
    want = tp.top_p_threshold_from_logits_plain(logits, top_p, 0.6)
    tp.boundary_disagreements(probs, got, want, top_p)
    same = ((probs >= got[:, None]) == (probs >= want[:, None])).all(dim=1)
    assert torch.where(same, (got - want).abs(), 0.0).max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("rows", [1, 64])
def test_top_p_cluster_route_matches_plain(rows, top_p):
    """V = 128256 (Llama-3) runs the cluster route, under its own counters:
    the fused kernel bit-identical to the plain version, the from-logits
    kernel within `boundary_disagreements`; likewise past 8 blocks of
    register rows (V = 300000, re-read in each pass)."""
    _need_cuda()
    for vocab in (128256, 300000):
        gen = torch.Generator(device="cuda").manual_seed(rows + vocab)
        logits = torch.randn(rows, vocab, generator=gen, device="cuda") * 3
        probs = torch.softmax(logits / 0.6, dim=-1)
        before = dict(qmm.build.launches)
        got = tp.top_p_threshold_fused(probs, top_p)
        torch.testing.assert_close(got, tp.top_p_threshold_plain(probs, top_p), rtol=0, atol=0)
        got = tp.top_p_threshold_from_logits(logits, top_p, 0.6)
        want = tp.top_p_threshold_from_logits_plain(logits, top_p, 0.6)
        tp.boundary_disagreements(probs, got, want, top_p)
        for name in ("top_p_threshold_fused", "top_p_threshold_from_logits"):
            assert qmm.build.launches[name + "_cluster"] == before[name + "_cluster"] + 1
            assert qmm.build.launches[name] == before[name]


def _qmm_inputs(R, K, N, bits, dtype, seed):
    """Random q bytes (every nibble, -8 included) and positive scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, K, generator=gen, device="cuda").to(dtype)
    q = torch.randint(-128, 128, (K if bits == 8 else K // 2, N), generator=gen,
                      device="cuda", dtype=torch.int8)
    scale = torch.rand(1, N, generator=gen, device="cuda") * 0.02 + 0.001
    return x, q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 5, 16, 64, 128, 256, 300])
@pytest.mark.parametrize("K,N,out_dtype", [
    (4096, 4096, None), (4096, 11008, None), (11008, 4096, None),
    (4096, 32000, torch.float32),   # the lm_head: f32 logits
    (96, 200, None),                # ragged: byte loads, masked edges
    (96, 200, torch.float32),
    (200, 136, None),               # ragged K (a partial stage), N % 16 != 0
])
def test_quant_matmul_kernel_matches_plain(bits, R, K, N, out_dtype):
    """bf16 x: bf16 out within 2e-2 of the largest |plain|, f32 out within
    1e-4 (the products are exact; only the f32 sum order differs). Both
    widths run their wgmma kernel (TMA where N % 16 == 0 and K % 8 == 0,
    else the producer warp's copies); R = 300 takes two row tiles."""
    _need_cuda()
    x, q, scale = _qmm_inputs(R, K, N, bits, torch.bfloat16, R + K + N + bits)
    got = qmm.quant_matmul(x, q, scale, bits=bits, out_dtype=out_dtype)
    want = qmm.quant_matmul_plain(x, q, scale, bits=bits, out_dtype=out_dtype)
    tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-4
    assert got.dtype == want.dtype and got.shape == want.shape
    peak = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * peak)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R,K,N", [(3, 96, 200), (64, 128, 256), (17, 4096, 4096)])
def test_quant_matmul_f32_x_matches_plain(bits, R, K, N):
    """f32 x runs on the tensor cores as three exact bf16 planes: within
    1e-4."""
    _need_cuda()
    x, q, scale = _qmm_inputs(R, K, N, bits, torch.float32, R + bits)
    got = qmm.quant_matmul(x, q, scale, bits=bits)
    want = qmm.quant_matmul_plain(x, q, scale, bits=bits)
    peak = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * peak)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [1, 5, 16, 64, 128, 256, 300])
@pytest.mark.parametrize("K,N,out_dtype", [
    (4096, 4096, None), (11008, 4096, None), (4096, 32000, torch.float32),
    (96, 200, None),                # a ragged last panel, K below one stage
])
def test_quant_matmul_tiled_kernel_matches_plain(R, K, N, out_dtype, x_dtype):
    """The panel-tiled int4 kernels (bf16 x: the wgmma kernel's 3-D tensor
    map; f32 x: its planes instantiation) at the row-major int4 kernel's
    tolerances."""
    _need_cuda()
    x, q, scale = _qmm_inputs(R, K, N, 4, x_dtype, R + K + N)
    tiled = tile_int4(QuantizedTensor(q, scale))
    got = qmm.quant_matmul_tiled(x, tiled.q, tiled.scale, out_dtype=out_dtype)
    want = qmm.quant_matmul_tiled_plain(x, tiled.q, tiled.scale, out_dtype=out_dtype)
    assert got.dtype == want.dtype and got.shape == (R, N)
    tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-4
    peak = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * peak)
    with pytest.raises(ValueError, match="128-column panels"):
        t16 = tile_int4(QuantizedTensor(q, scale), bn0=16)
        qmm.quant_matmul_tiled(x, t16.q, t16.scale)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,K", [(1, 4096), (64, 11008), (256, 11008), (5, 96), (3, 100),
                                 (2, 70000)])   # the last: the two-pass loop
def test_quantize_activations_kernel_matches_plain(R, K, x_dtype):
    """The same int8 values and the same f32 scales, bit for bit."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(R + K)
    x = (torch.randn(R, K, generator=gen, device="cuda") * 3).to(x_dtype)
    x[0, :4] = torch.tensor([127.0, 63.5, -0.5, 2.5], device="cuda").to(x_dtype)
    if R > 1:   # sx = 7/64: ties that a multiplication by 1 / sx would round up
        x[1] = x[1].clamp(-13, 13)
        x[1, :3] = torch.tensor([13.890625, 0.7109375, 1.3671875], device="cuda").to(x_dtype)
    got8, gots = qmm.quantize_activations(x)
    want8, wants = qmm.quantize_activations_plain(x)
    assert torch.equal(got8, want8) and torch.equal(gots, wants)
    if R > 1 and x_dtype == torch.float32:
        assert got8[1, :3].tolist() == [127, 6, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 5, 64, 128, 256])
@pytest.mark.parametrize("K,N,out_dtype", [
    (4096, 4096, None), (4096, 11008, None), (11008, 4096, None),
    (4096, 32000, torch.float32),
    (96, 200, None), (96, 200, torch.float32), (100, 72, torch.float32),   # ragged
])
def test_int8_activation_kernels_match_plain(bits, R, K, N, out_dtype):
    """w8a8 and w4a8: the int32 products are exact and the f32 rescale runs
    in the plain version's order, so an f32 output is held to 1e-6 relative
    and a bf16 output to one rounding (2^-8 relative)."""
    _need_cuda()
    x, q, scale = _qmm_inputs(R, K, N, bits, torch.bfloat16, R + K + N + bits)
    if bits == 8:
        got = qmm.quant_matmul_w8a8(x, q, scale, out_dtype=out_dtype)
        want = qmm.quant_matmul_w8a8_plain(x, q, scale, out_dtype=out_dtype)
    else:
        got = qmm.quant_matmul(x, q, scale, bits=4, out_dtype=out_dtype, unpack="w4a8")
        want = qmm.quant_matmul_plain(x, q, scale, bits=4, out_dtype=out_dtype, unpack="w4a8")
    assert got.dtype == want.dtype and got.shape == (R, N)
    tol = 2 ** -8 if got.dtype == torch.bfloat16 else 1e-6
    peak = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * peak)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R,K,N", [(1, 4096, 4096), (64, 4096, 11008), (256, 11008, 4096),
                                   (300, 4096, 4096), (5, 96, 200)])
def test_int8_activation_routes_in_a_graph_equal_plain(bits, R, K, N):
    """Quantizer + matmul (the matmul a programmatic dependent launch, and
    without it), six calls on six inputs captured in one CUDA graph and
    replayed: every call's output equals its plain version bit for bit, so
    no matmul read x8 or sx before the quantizer had written them."""
    _need_cuda()
    xs = [_qmm_inputs(R, K, N, bits, torch.bfloat16, R + K + i)[0] for i in range(6)]
    _, q, scale = _qmm_inputs(R, K, N, bits, torch.bfloat16, N)
    launch = qmm._launch_int8_sm90 if bits == 8 else qmm._launch_int4_sm90

    def route(x, pdl):
        x8, sx = qmm.quantize_activations(x)
        return launch(x8, q, scale, torch.bfloat16, sx=sx, pdl=pdl)

    for pdl in (True, False):
        route(xs[0], pdl)
        torch.cuda.synchronize()
        graph, outs = torch.cuda.CUDAGraph(), []
        with torch.cuda.graph(graph):
            for x in xs:
                outs.append(route(x, pdl))
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        for x, got in zip(xs, outs):
            if bits == 8:
                want = qmm.quant_matmul_w8a8_plain(x, q, scale)
            else:
                want = qmm.quant_matmul_plain(x, q, scale, bits=4, unpack="w4a8")
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_quant_matmul_raises_instead_of_falling_back():
    _need_cuda()
    x, q, scale = _qmm_inputs(4, 96, 200, 8, torch.bfloat16, 0)
    with pytest.raises(TypeError):
        qmm.quant_matmul(x.half(), q, scale, bits=8)
    with pytest.raises(TypeError):
        qmm.quant_matmul(x, q.to(torch.uint8), scale, bits=8)
    misaligned = torch.empty(4 * 96 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(4, 96)
    with pytest.raises(ValueError, match="aligned"):
        qmm.quant_matmul(misaligned, q, scale, bits=8)
    with pytest.raises(ValueError):
        qmm.quant_matmul(x, q.cpu(), scale, bits=8)
    before = dict(qmm.build.launches)
    qmm.quant_matmul(x, q, scale, bits=8)
    assert qmm.build.launches["quant_matmul_int8_wgmma"] == before["quant_matmul_int8_wgmma"] + 1
    qmm.quant_matmul(x.float(), q, scale, bits=8)
    assert qmm.build.launches["quant_matmul_int8"] == before["quant_matmul_int8"] + 1
    assert qmm.build.launches["split_bf16x3"] == before["split_bf16x3"] + 1
    # int4 and tiled int4: bf16 x on the wgmma kernel, f32 x split into bf16
    # planes and on its planes instantiation
    _, q4, scale4 = _qmm_inputs(4, 96, 200, 4, torch.bfloat16, 1)
    tiled = tile_int4(QuantizedTensor(q4, scale4))
    calls = (("quant_matmul_int4", lambda x: qmm.quant_matmul(x, q4, scale4, bits=4)),
             ("quant_matmul_tiled", lambda x: qmm.quant_matmul_tiled(x, tiled.q, tiled.scale)))
    for name, call in calls:
        before = dict(qmm.build.launches)
        call(x)
        assert qmm.build.launches[name + "_wgmma"] == before[name + "_wgmma"] + 1
        assert qmm.build.launches[name] == before[name]
        call(x.float())
        assert qmm.build.launches[name] == before[name] + 1
        assert qmm.build.launches[name + "_wgmma"] == before[name + "_wgmma"] + 1
        assert qmm.build.launches["split_bf16x3"] == before["split_bf16x3"] + 1


def test_boundary_disagreements_rejects_a_real_difference():
    probs = torch.tensor([[0.5, 0.3, 0.15, 0.05]])
    keep3 = torch.tensor([0.1])       # keeps 0.5, 0.3, 0.15
    keep2 = torch.tensor([0.2])       # keeps 0.5, 0.3
    keep1 = torch.tensor([0.4])
    assert tp.boundary_disagreements(probs, keep2, keep2, 0.8) == 0
    assert tp.boundary_disagreements(probs, keep3, keep2, 0.8) == 1  # mass 0.8 above 0.15
    with pytest.raises(ValueError):
        tp.boundary_disagreements(probs, keep3, keep2, 0.9)          # well conditioned
    with pytest.raises(ValueError):
        tp.boundary_disagreements(probs, keep3, keep1, 0.8)          # two tokens


def test_cuda_tensor_never_takes_the_plain_version():
    """Without a card a CUDA tensor cannot exist; with one, a tensor on an
    unsupported device raises instead of running the plain version."""
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tp.top_p_threshold_fused(x, 0.9)


# The device loops as CUDA-graph replays (engine/graphs.py) ---------------------

def _small_engines(algo, kv_quant=None, dtype=torch.float32):
    """test-small draft and target (random, seeded) on the card, a Sequoia
    engine and an AR baseline."""
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.trees.growmap import uniform_tree

    cfg = get_config("test-small")
    draft = random_params(cfg, 7, dtype=dtype, device="cuda")
    target = random_params(cfg, 8, dtype=dtype, device="cuda")
    eng = SpecEngine(draft, cfg, target, cfg, uniform_tree(3, 2), algorithm=algo,
                     max_length=128, temperature=0.7, top_p=0.9, prefill_chunk=16,
                     kv_quant=kv_quant, device="cuda")
    ar = ARBaseline(target, cfg, max_length=128, temperature=0.7, top_p=0.9,
                    greedy=algo == "greedy", prefill_chunk=16, kv_quant=kv_quant, device="cuda")
    return eng, ar


PROMPT = np.arange(5, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["greedy", "sequoia"])
def test_graph_replay_equals_eager(algo):
    """Replayed and eager give the same tokens and counts; two seeds go
    through one captured set of graphs, each equal to its eager run."""
    _need_cuda()
    eng, ar = _small_engines(algo)
    for seed in (1, 2):
        want = eng.generate(PROMPT, max_new_tokens=40, seed=seed)
        steps = eng.num_large_model_steps
        got = eng.generate_fast(PROMPT, max_new_tokens=40, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert eng.num_large_model_steps == steps
        np.testing.assert_array_equal(ar.generate_fast(PROMPT, 40, seed=seed),
                                      ar.generate(PROMPT, 40, seed=seed))
    assert set(eng.graph_report()) == {"grow", "verify", "finalize"}
    assert ar.graph_report()["step"]["replays"] >= 2
    if algo == "greedy":
        exp = ar.generate(PROMPT, 40)
        n = min(len(exp), len(got))
        np.testing.assert_array_equal(got[:n], exp[:n])
        streamed = np.concatenate([PROMPT] + list(eng.stream_fast(PROMPT, 40, chunk_tokens=5)))
        np.testing.assert_array_equal(streamed, got)


@pytest.mark.cuda
def test_full_length_prompt_captures_nothing():
    """A prompt of `max_length` tokens leaves no slot for the warm-up's
    no-op step: with no budget, `generate_fast` captures nothing and
    returns the prompt, and the card stays usable."""
    _need_cuda()
    from sequoia_torch.engine.baseline import ARBaseline

    eng, ar = _small_engines("greedy")
    full = ARBaseline(ar.params, ar.cfg, max_length=len(PROMPT), greedy=True,
                      prefill_chunk=16, device="cuda")
    np.testing.assert_array_equal(full.generate_fast(PROMPT, max_new_tokens=0), PROMPT)
    np.testing.assert_array_equal(eng.generate_fast(PROMPT, max_new_tokens=0), PROMPT)
    torch.cuda.synchronize()
    assert full.graph_report() == {} and eng.graph_report() == {}
    np.testing.assert_array_equal(ar.generate_fast(PROMPT, 8), ar.generate(PROMPT, 8))


@pytest.mark.cuda
def test_graphs_recapture_on_a_cache_change():
    """A new packing or kv_quant on a live engine makes a new cache, and
    the next replay recaptures on it."""
    _need_cuda()
    from sequoia_torch.kernels import build

    eng, _ = _small_engines("greedy", kv_quant="int4")
    first = eng.generate_fast(PROMPT, max_new_tokens=24)
    graphs = dict(eng._graphs.graphs)
    for attr, value, counter in (("_kv4_packing", "dsplit", "tree_attention_kv4_dsplit_f32"),
                                 ("kv_quant", "int8", "tree_attention_kv8_f32")):
        setattr(eng, attr, value)
        before = build.launches[counter]
        got = eng.generate_fast(PROMPT, max_new_tokens=24)
        assert build.launches[counter] > before
        assert all(eng._graphs.graphs[n] is not graphs[n] for n in graphs)
        graphs = dict(eng._graphs.graphs)
        np.testing.assert_array_equal(got, eng.generate(PROMPT, max_new_tokens=24))
    assert len(first) > len(PROMPT)


@pytest.mark.cuda
def test_launch_counters_count_replays():
    """A capture counts nothing; each replay adds its graph's launches."""
    _need_cuda()
    from sequoia_torch.kernels import build

    eng, ar = _small_engines("sequoia")
    eng.generate_fast(PROMPT, max_new_tokens=8)            # captures
    ar.generate_fast(PROMPT, max_new_tokens=8)
    before = dict(build.launches)
    eng.prefill(PROMPT)
    ar.prefill(PROMPT)
    eager = {k: v - before[k] for k, v in build.launches.items()}
    reports = (eng.graph_report(), ar.graph_report())
    before = dict(build.launches)
    eng.generate_fast(PROMPT, max_new_tokens=30, seed=3)
    ar.generate_fast(PROMPT, max_new_tokens=30, seed=3)
    after = (eng.graph_report(), ar.graph_report())
    want = dict(eager)
    for old, new in zip(reports, after):
        for name, g in new.items():
            for k, v in g["launches"].items():
                want[k] += v * (g["replays"] - old[name]["replays"])
    assert {k: v - before[k] for k, v in build.launches.items()} == want
    assert want["top_p_threshold_from_logits"] == after[0]["finalize"]["replays"] \
        - reports[0]["finalize"]["replays"] > 0


@pytest.mark.cuda
def test_capture_failure_raises():
    """A host read inside a captured phase aborts the capture, and
    `generate_fast` raises instead of falling back to the eager loop."""
    _need_cuda()
    eng, _ = _small_engines("greedy")
    grow = eng._grow

    def reads_back(state):
        out = grow(state)
        out[0].sum().item()
        return out

    eng._grow = reads_back
    with pytest.raises(RuntimeError):
        eng.generate_fast(PROMPT, max_new_tokens=8)
    assert not eng._graphs.graphs
    eng._grow = grow
    np.testing.assert_array_equal(eng.generate_fast(PROMPT, max_new_tokens=8),
                                  eng.generate(PROMPT, max_new_tokens=8))


def _small_batched(algo, batch_size=3, **kw):
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.batched import BatchedSpecEngine
    from sequoia_torch.trees.growmap import uniform_tree

    cfg = get_config("test-small")
    draft = random_params(cfg, 7, dtype=torch.float32, device="cuda")
    target = random_params(cfg, 8, dtype=torch.float32, device="cuda")
    eng = BatchedSpecEngine(draft, cfg, target, cfg, uniform_tree(3, 2), algorithm=algo,
                            batch_size=batch_size, max_length=128, temperature=0.7, top_p=0.9,
                            prefill_chunk=16, device="cuda", **kw)
    return eng, draft, target, cfg


BATCH_PROMPTS = [np.arange(5, 16), np.arange(40, 43), np.arange(7, 30), np.arange(90, 95)]


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["greedy", "sequoia"])
def test_batched_graphs_equal_eager(algo):
    """Batched replays (one generator a slot, registered with every graph)
    give the eager loops' tokens: `generate_batch_fast` == `generate_batch`,
    `serve_fast` == `serve`, and `serve_device` (admission graph, a slot's
    generator reseeded between replays) == `serve_fast`; each slot equals
    the single-request engine with its request's seed."""
    _need_cuda()
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.trees.growmap import uniform_tree

    eng, draft, target, cfg = _small_batched(algo, admit_width=2)
    want = eng.generate_batch(BATCH_PROMPTS[:3], max_new_tokens=30, seed=4)
    steps = eng.num_large_model_steps
    got = eng.generate_batch_fast(BATCH_PROMPTS[:3], max_new_tokens=30, seed=4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert eng.num_large_model_steps == steps
    fast = eng.serve_fast(BATCH_PROMPTS, max_new_tokens=20, seed=4)
    for a, b in zip(eng.serve(BATCH_PROMPTS, max_new_tokens=20, seed=4), fast):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(eng.serve_device(BATCH_PROMPTS, max_new_tokens=20, seed=4), fast):
        np.testing.assert_array_equal(a, b)
    assert set(eng.graph_report()) >= {"grow", "verify", "finalize", "admit"}
    single = SpecEngine(draft, cfg, target, cfg, uniform_tree(3, 2), algorithm=algo,
                        max_length=128, temperature=0.7, top_p=0.9, prefill_chunk=16,
                        device="cuda")
    for i, (p, out) in enumerate(zip(BATCH_PROMPTS, fast)):
        np.testing.assert_array_equal(out, single.generate(p, 20, seed=4 + i)[:len(out)])


@pytest.mark.cuda
def test_batched_ar_graphs_equal_single_requests():
    """The batched AR step graph: each request of `serve_fast` equals the
    single-request baseline with its seed (stochastic, T 0.7)."""
    _need_cuda()
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.batched import BatchedAREngine

    _, _, target, cfg = _small_batched("greedy")
    kw = dict(max_length=128, temperature=0.7, top_p=0.9, prefill_chunk=16, device="cuda")
    ar = BatchedAREngine(target, cfg, batch_size=2, **kw)
    outs = ar.serve_fast(BATCH_PROMPTS, max_new_tokens=20, seed=6)
    single = ARBaseline(target, cfg, **kw)
    for i, (p, out) in enumerate(zip(BATCH_PROMPTS, outs)):
        np.testing.assert_array_equal(out, single.generate(p, 20, seed=6 + i))
    assert ar.graph_report()["step"]["replays"] > 0


def _small_offload(stay, dtype=torch.float32, bits=None):
    """test-small on the card, resident and offloaded with `stay` layers
    kept (the rest in pinned host memory), float or int8 / int4."""
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.offload import offload_params
    from sequoia_torch.quant.quantize import quantize_model

    cfg = get_config("test-small")
    target = random_params(cfg, 8, dtype=dtype, device="cuda")
    if bits:
        target = quantize_model(target, bits=bits)
    return cfg, target, offload_params(target, stay_layers=stay)


def _split_forward(cfg, dtype, width=7, kv_len=20, M=64):
    from sequoia_torch.core.model import forward
    from sequoia_torch.kvcache.cache import KVCache

    gen = torch.Generator(device="cuda").manual_seed(width)
    kv = KVCache.init(cfg, M, dtype, "cuda")
    for t in (kv.k, kv.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (width,), generator=gen, device="cuda")
    pos = kv_len + torch.arange(width, device="cuda")
    mask = (torch.arange(M, device="cuda") < kv_len)[None, :].expand(width, M).contiguous()
    smask = torch.tril(torch.ones(width, width, dtype=torch.bool, device="cuda"))

    def run(params):
        scratch = KVCache.init(cfg, width, dtype, "cuda")
        logits, _ = forward(params, cfg, tokens, pos, kv, kv_len, mask, scratch=scratch,
                            scratch_offset=0, scratch_mask=smask)
        return logits, scratch.k, scratch.v

    return run


def _poison(bufs):
    for b in bufs:
        b.fill_(float("nan") if b.is_floating_point() else -128)


@pytest.mark.cuda
@pytest.mark.parametrize("stay,dtype,bits", [(0, torch.float32, None), (1, torch.float32, None),
                                             (0, torch.bfloat16, None), (1, torch.bfloat16, 8),
                                             (0, torch.bfloat16, 4)])
def test_offloaded_forward_equals_resident_eager_and_captured(stay, dtype, bits):
    """The streamed layers lie in pinned memory; the offloaded forward
    equals the resident one bit for bit, eager and replayed from a graph
    (its copies captured with it), also with both staging buffers poisoned
    on the compute stream before the forward or the replay."""
    _need_cuda()
    from sequoia_torch.core.model import is_streamed, layer_leaves
    from sequoia_torch.engine.graphs import GraphSet
    from sequoia_torch.engine.offload import staging_buffers

    cfg, target, off = _small_offload(stay, dtype, bits)
    assert all(a.is_pinned() for a in layer_leaves(off.layers.streamed) if is_streamed(a))
    assert all(a.is_cuda for a in layer_leaves(off.layers.streamed) if not is_streamed(a))
    run = _split_forward(cfg, dtype)
    want = [t.clone() for t in run(target)]

    def same(got):
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    same(run(off))
    bufs = staging_buffers(off)
    _poison(bufs)
    same(run(off))
    graphs = GraphSet(torch.device("cuda"))
    with graphs.warmup():
        run(off)
    outs = graphs.capture("forward", lambda: run(off))
    for _ in range(2):
        _poison(bufs)
        graphs.replay("forward")
        same(outs)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["greedy", "sequoia"])
def test_offloaded_engines_equal_resident(algo):
    """`generate_fast` (graph replays with the copy stream in them) and the
    eager `generate` give the resident target's tokens; AR too."""
    _need_cuda()
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.trees.growmap import uniform_tree

    cfg, target, off = _small_offload(1)
    kw = dict(max_length=128, temperature=0.7, top_p=0.9, prefill_chunk=16, device="cuda")
    draft = random_params(cfg, 7, dtype=torch.float32, device="cuda")
    runs = []
    for t in (target, off):
        eng = SpecEngine(draft, cfg, t, cfg, uniform_tree(3, 2), algorithm=algo, **kw)
        ar = ARBaseline(t, cfg, greedy=algo == "greedy", **kw)
        runs.append((eng.generate_fast(PROMPT, 30, seed=3), eng.generate(PROMPT, 30, seed=3),
                     ar.generate_fast(PROMPT, 30, seed=3)))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_offload_pageable_streamed_layers_raise():
    """No pageable fallback: streamed layers that are not pinned raise."""
    _need_cuda()
    from sequoia_torch.core.model import OffloadLayers, from_leaves, is_streamed, layer_leaves

    cfg, target, off = _small_offload(0)
    streamed = off.layers.streamed
    pageable = from_leaves(streamed, [a.clone() if is_streamed(a) else a
                                      for a in layer_leaves(streamed)])
    assert not pageable.wq.is_pinned()
    params = off._replace(layers=OffloadLayers(resident=None, streamed=pageable))
    with pytest.raises(RuntimeError, match="pinned"):
        _split_forward(cfg, torch.float32)(params)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4", "tiled", "w4a8"])
@pytest.mark.parametrize("K,N,out_dtype", [
    # llama-2-7b's tensor-parallel shards at tp = 2 and 4 (core/model.py, tp=):
    # column shards of qkv / gate-up / the head, row shards of wo / w_down.
    (4096, 2048, None), (4096, 5504, None), (4096, 16000, torch.float32),
    (2048, 4096, None), (5504, 4096, None),
    (4096, 1024, None), (4096, 2752, None), (4096, 8000, torch.float32),
    (1024, 4096, None), (2752, 4096, None),
])
def test_quant_matmuls_at_tp_shard_shapes(kind, K, N, out_dtype):
    """Each quant-matmul kernel at the shard shapes of the tensor-parallel
    forward, 64 rows (a verify), against its plain version at the
    tolerances of the whole shapes; w4a8 with the whole rows' maxima (x is
    the first K of rows twice as wide), as a row shard gets them."""
    _need_cuda()
    bits = 8 if kind == "int8" else 4
    x, q, scale = _qmm_inputs(64, K, N, bits, torch.bfloat16, K + N + bits)
    tol = 2e-2 if out_dtype is None else 1e-4
    if kind == "tiled":
        t = tile_int4(QuantizedTensor(q, scale))
        got = qmm.quant_matmul_tiled(x, t.q, t.scale, out_dtype=out_dtype)
        want = qmm.quant_matmul_tiled_plain(x, t.q, t.scale, out_dtype=out_dtype)
    elif kind == "w4a8":
        wide = torch.cat([x, 4 * x.flip(1)], dim=1)
        amax = wide.float().abs().amax(dim=-1, keepdim=True)
        got = qmm.quant_matmul(x, q, scale, bits=4, unpack="w4a8", out_dtype=out_dtype,
                               amax=amax)
        want = qmm.quant_matmul_plain(x, q, scale, bits=4, unpack="w4a8",
                                      out_dtype=out_dtype, amax=amax)
        tol = 2 ** -8 if out_dtype is None else 1e-6
    else:
        got = qmm.quant_matmul(x, q, scale, bits=bits, out_dtype=out_dtype)
        want = qmm.quant_matmul_plain(x, q, scale, bits=bits, out_dtype=out_dtype)
    assert got.shape == (64, N)
    peak = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * peak)


@pytest.mark.cuda
def test_quantizer_takes_whole_row_maxima():
    """A row-parallel shard quantized by its whole rows' maxima (the
    tensor-parallel w8a8 / w4a8 route): the kernel equals its plain
    version bit for bit, and both equal the whole row's values."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(64, 11008, generator=g, device="cuda").to(torch.bfloat16)
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    part = x[:, :5504].contiguous()
    got8, gots = qmm.quantize_activations(part, amax)
    want8, wants = qmm.quantize_activations_plain(part, amax)
    whole8, whole_s = qmm.quantize_activations(x)
    assert torch.equal(got8, want8) and torch.equal(gots, wants)
    assert torch.equal(got8, whole8[:, :5504]) and torch.equal(gots, whole_s)


@pytest.mark.cuda
def test_graph_entry_points_refuse_gloo_on_cuda(tmp_path):
    """On the card a gloo tp group cannot be captured: `generate_fast`
    raises, naming NCCL; the eager `generate` runs (one gloo rank,
    tests/torch_tp_worker.py)."""
    import os
    import socket
    import subprocess
    import sys

    _need_cuda()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    inp = tmp_path / "input.pt"
    torch.save({"tp": 1}, inp)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    res = subprocess.run([sys.executable, worker, "gloo_cuda", str(inp), str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert got["raised"] and got["eager_tokens"] > 0



@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_cuda():
    """On the card no kernel hands back a detached result for a
    grad-requiring input: every wrapper but float tree attention raises."""
    _need_cuda()
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    q = torch.randint(-127, 128, (64, 32), dtype=torch.int8, device="cuda")
    q4 = torch.randint(-127, 128, (32, 32), dtype=torch.int8, device="cuda")
    scale = torch.rand(1, 32, device="cuda")
    calls = [lambda: qmm.quant_matmul(x, q, scale, bits=8),
             lambda: qmm.quant_matmul(x.bfloat16(), q4, scale, bits=4),
             lambda: qmm.quant_matmul_w8a8(x, q, scale),
             lambda: qmm.quantize_activations(x),
             lambda: qmm.split_bf16x3(x),
             lambda: tp.top_p_threshold_from_logits(x, 0.9, 0.6),
             lambda: tp.top_p_threshold_fused(x.softmax(-1), 0.9)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batched", [False, True])
def test_tree_attention_function_on_cuda_matches_plain_autograd(dtype, tol, batched):
    """Under autograd the kernel (its launch counted) with the written-out
    backward against autograd through the plain version on the card: the
    output and every input's gradient within `tol` of its largest |value|."""
    from sequoia_torch.kernels import build

    _need_cuda()
    args = _attention_inputs(37, 96, 24, 4, 2, 32, dtype)
    if batched:
        args = tuple(torch.stack([a, a.flip(0)]) for a in args)
    dout = torch.randn(args[0].shape, device="cuda", dtype=dtype)
    res = []
    for fn in ((tree_attention_batched, tree_attention_batched_plain) if batched
               else (tree_attention, tree_attention_plain)):
        q, k, v, mask, sk, sv, smask = (a.clone() for a in args)
        diff = [t.requires_grad_(True) for t in (q, k, v, sk, sv)]
        name = counter("float", dtype, batched=batched)
        before = build.launches[name]
        out = fn(q, k, v, mask, sk, sv, smask, scale=32 ** -0.5)
        assert build.launches[name] == before + (fn in (tree_attention, tree_attention_batched))
        out.backward(dout)
        res.append([out.detach()] + [t.grad for t in diff])
    for a, b in zip(*res):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * float(b.float().abs().max()))
