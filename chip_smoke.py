#!/usr/bin/env python3
"""Chip smoke test of sequoia_torch on one CUDA card (an H100).

    python3 chip_smoke.py               # every phase (the contract run)
    python3 chip_smoke.py --attention   # phases 1, 2 and phase 3's tree attention
    python3 chip_smoke.py --qmm         # phases 1, 2 and phase 3's top-p and matmuls
    python3 chip_smoke.py --loops       # phases 1, 2, 4 and phase 5's bf16 path

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from sequoia_torch/csrc (nvcc), with
     each kernel's registers and spills (ptxas);
  3. kernels: each kernel against its plain PyTorch version at the shapes
     of the main paths: tree attention with a float, an int8, an int4
     head-paired and an int4 dsplit main cache, bf16 and f32 (each with its
     split count and the key tiles its prefix skip reads; f32 also at phase
     7's shapes, Q = 1, 16 and 64, with its error and SDPA f32's against
     an f64 version); the top-p cutoffs at V = 32000 (one block
     per row) and V = 128256 (a cluster per row), each at R = 1 and the
     tree size, twice on each input, timed on peaked, flat, uniform and
     tied rows, beside an empty kernel of its grid;
     the quant matmuls (the wgmma kernels: int8 weight-only, w8a8, int4,
     panel-tiled int4 and w4a8 at R in {1, 16, 64, 128, 256} and 300, each
     with its load path, cluster split, row tile and stage depth; the f32-x
     route for int8, int4 and tiled int4, the split into bf16 planes and
     the planes instantiations, at R in {1, 16, 64, 128, 256}, with its
     error against an f64 product beside cuBLAS f32's and two launches held
     to equal bits) at every 7B projection shape and the lm_head, plus a
     ragged small shape; the split alone against its plain version, bit for
     bit; the two int8-activation routes (w4a8, w8a8) with every cycled
     call of the timing graph held to its plain version, the quantizer and
     the matmul timed apart and together, with and without the programmatic
     dependent launch, and w4a8 beside the bf16-x int4 kernel; the
     activation quantizer against an empty kernel of its grid. With device
     times (CUDA graphs of many launches, timed with CUDA events), the least
     time the card could take, and the time of one PyTorch library call
     where one computes the same function; and the host time of one
     quantized projection call against one torch.matmul on the bf16 weight;
  4. small parity: test-small, f32, on the card, with an f32, an int8, an
     int4 and a tiled-int4 target: greedy speculative decoding equals greedy
     AR token for token, eager and replayed (`generate_fast`, CUDA graphs),
     the kernel forward equals the CPU forward, and (f32) all four
     algorithms and the stochastic AR run, seeds 1 and 2 replayed through
     one captured set of graphs equal to eager, with one eager iteration
     (and AR step) under `set_sync_debug_mode("error")`; the int8 target
     with w8a8 forced on and the f32 target with an int8, an int4
     head-paired and an int4 dsplit KV cache: forward against the CPU
     forward, and greedy speculative decoding runs, replayed as eager; then
     bf16 int8, int4 and tiled-int4 targets, whose card forward (the
     tensor-core kernels at 24 and 21 rows) equals the CPU forward; last, a
     capture with a host read inside must raise. Its launches count (the
     f32-x quant matmuls and the f32 route of tree attention, every cache
     format, run here; the float cache also in phase 7's f32 curve);
  5. full width: llama-68m -> llama-2-7b, bf16, random weights (seeded),
     the planned 64-node growmap, max_length 256, 2 synthetic 128-token
     prompts, T=0.6, P=0.9: the stochastic AR baseline and Sequoia through
     the testbed's entry points (`generate_fast`: the captured graphs'
     kernel nodes and capture seconds, then replays, whose launches count),
     with launch counts of every kernel; on the bf16, int8 and int4 paths
     also the eager `generate` on the same prompts and seeds (bf16: the
     tokens must equal the replayed ones), the graphs' replay device times,
     and the busy share of graphed runs (profiler trace, and replay
     events); then
     the same target with kv_quant int8 and int4 (head-paired; one more
     Sequoia prompt with the dsplit packing); then stochastic AR and Sequoia
     at the Llama-3 vocabulary (llama-3.2-1b widths, 2 and 1 layers,
     `generate_fast`), where both top-p kernels must run their cluster
     route;
  6. the same with the target's weights quantized: int8 weight-only (w8a8
     off) and int8 with w8a8 on (Sequoia), int4, and panel-tiled int4
     (tile_int4 over the seven projections and the head), all on the wgmma
     kernels; each kernel of a path must launch on it;
  7. the width curves (planner/profile.py, device time of one split-mode
     forward at widths 1..256): bf16 with each cache format, int8
     weight-only, int8 w8a8, int4, tiled int4, and the int4 target with every
     projection sent through unpack="w4a8"; an int8 target with f32
     activations at widths 1, 16 and 64 (the f32-x route at 7B width, with
     the f32 route of tree attention); the 68m draft's at width 8; the
     tree the planner DP picks from each curve (widths 1..128); beside them,
     the host time to issue one eager forward at widths 1 and 64. Each curve
     is measured right after its path's launches are read, before that
     target is freed.

Prints the kernels JSON line and the card line before the last line, and
ends with one JSON line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, when there is no CUDA card or no sequoia_torch beside
this file.
"""

from __future__ import annotations

import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "tf32": 495e12}

SEED = 1234
FULL = dict(draft="llama-68m", target="llama-2-7b", max_length=256,
            prompts="synthetic:2,128", gen=128, T=0.6, P=0.9)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """`name<template arguments>` of a mangled kernel symbol (ptxas -v names
    each kernel by its symbol): int and bool values, and the activation
    types of the int4 kernel (XBf16, XS8)."""
    rest, parts = mangled[2:], []        # after "_Z"; "N" opens a nested name
    if rest.startswith("N"):
        rest = rest[1:]
    while rest[:1].isdigit():
        n = len(rest) - len(rest.lstrip("0123456789"))
        size = int(rest[:n])
        parts.append(rest[n:n + size])
        rest = rest[n + size:]
    found = (re.findall(r"\d(X[A-Za-z0-9]+?)E|L[ib](\d+)E", rest.split("EEv")[0])
             if rest.startswith("I") else [])
    args = [a or b for a, b in found]
    return parts[-1] + (f"<{','.join(args)}>" if args else "") if parts else mangled


def graph_kernels(graph) -> int:
    """Kernel nodes of a captured CUDA graph (made with keep_graph=True),
    counted with libcuda's cuGraphGetNodes."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    kind, count = ctypes.c_int(), 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        count += kind.value == 0   # CU_GRAPH_NODE_TYPE_KERNEL
    return count


def device_ms(fns, replays: int = 25, outs=None) -> float:
    """Device time of one call, in ms: the calls in `fns` are captured once
    into a CUDA graph (no host gaps between launches), the graph is
    replayed `replays` times under CUDA events, and the median replay is
    divided by len(fns). Fails unless the graph holds at least one kernel
    per call (a launch on another stream than the capturing one runs at
    capture time and would leave the graph without it). `outs`, a list,
    receives the captured calls' results, which hold the last replay's
    values."""
    import torch

    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for f in fns:
            r = f()
            if outs is not None:
                outs.append(r)
    kernels = graph_kernels(graph)
    if kernels < len(fns):
        fail(f"a timing graph of {len(fns)} calls holds {kernels} kernels")
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / len(fns)


def host_us(fn, n: int = 200) -> float:
    """Host time of one call, in µs: the median of 5 loops of `n` calls,
    each loop issued without synchronizing (the device runs behind; `n`
    calls stay well inside the launch queue, so the host never waits)."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(torch, *, Q_rows, layers, H, Hkv, D, M, S, ts, dtype, gen,
                   scratch_rows=None, causal_offset=None):
    """Inputs of one attention call of the main path: `layers` layers of
    main cache (so a timing pass over all of them runs past the 50 MB L2,
    as one forward does), a main mask that is the engine's per-row prefix,
    and the scratch mask the engine builds."""
    dev = "cuda"
    q = torch.randn(Q_rows, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(layers, M, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(layers, M, Hkv, D, generator=gen, device=dev).to(dtype)
    sk = torch.randn(layers, S, Hkv, D, generator=gen, device=dev).to(dtype)
    sv = torch.randn(layers, S, Hkv, D, generator=gen, device=dev).to(dtype)
    k_idx = torch.arange(M, device=dev)[None, :]
    if causal_offset is not None:     # prefill / re-draft: causal, S = 0
        main = k_idx <= (causal_offset + torch.arange(Q_rows, device=dev)[:, None])
    else:
        main = (k_idx < ts).expand(Q_rows, M).contiguous()
    scr = (scratch_rows if scratch_rows is not None
           else torch.ones(Q_rows, S, dtype=torch.bool, device=dev))
    return q, k, v, main, sk, sv, scr.contiguous()


KV_FORMATS = {   # main-cache format -> bytes per stored K/V element (None: q's)
    "float": None, "int8": 1.0, "int4_head": 0.5, "int4_dsplit": 0.5}


def attention_bound(q, main, scr, D, H, Hkv, itemsize, kv_item=None):
    """Least time for the data: the K/V rows some query attends, q, the
    masks and the output move once; 4*D flops per live (query head, key).
    A quantized main cache (`kv_item` bytes per element) also moves two f32
    scales per (row, head). bf16 flops at the bf16 tensor-core rate; f32
    flops as three TF32 passes (the least tensor-core work that keeps f32's
    accuracy: 3xTF32, the kernel's scheme; the CUDA cores' f32 rate would
    take 2.5x as long)."""
    main_rows = int(main.any(dim=0).sum())
    scr_rows = int(scr.any(dim=0).sum())
    main_bytes = (2 * main_rows * Hkv * D * itemsize if kv_item is None
                  else 2 * main_rows * Hkv * (D * kv_item + 4))
    nbytes = (2 * q.numel() * itemsize + main_bytes + 2 * scr_rows * Hkv * D * itemsize
              + main.numel() + scr.numel())
    flops = 4 * D * H * (int(main.sum()) + int(scr.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = flops / PEAK_FLOPS["bf16"] if itemsize == 2 else 3 * flops / PEAK_FLOPS["tf32"]
    t_ops = ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_tree_attention(torch, gm, results):
    """The float-cache kernel at every attention shape of the main path, and
    each quantized cache format at the verify, AR-step and prefill shapes
    (and the f32 verify). The f32 route also at phase 7's shapes (Q = 1, 16,
    64 queries over a 128-key prefix of M = 256 and a causal scratch of Q
    rows), where its error and SDPA f32's against an f64 version of the
    plain version are printed (the kernel's held to 1e-4 of the largest
    |output|). The library yardstick is SDPA on the float cache (for a
    quantized one: on its dequantized rows) under the same mask."""
    from sequoia_torch.kernels.tree_attention import (TILE_K, counter, split_count,
                                                      tile_extents, tree_attention,
                                                      tree_attention_plain)
    from sequoia_torch.kvcache.cache import (quantize_kv_rows, quantize_kv_rows4,
                                             unpack_kv_rows4)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    anc = torch.as_tensor(gm.ancestors, device="cuda")
    draft_scr = []
    for s, w in zip(gm.level_starts, gm.level_widths):
        m = anc[s:s + w].clone()
        m[:, 0] = False
        draft_scr.append((w, m))
    ts = 191  # a decode step: 128-token prompt plus 64 generated
    cases = [
        # name, kwargs, tolerance
        ("verify", dict(Q_rows=gm.size, layers=32, H=32, Hkv=32, D=128, M=256,
                        S=gm.size, ts=ts, dtype=torch.bfloat16, scratch_rows=anc), 2e-2),
        ("verify_f32", dict(Q_rows=gm.size, layers=4, H=32, Hkv=32, D=128, M=256,
                            S=gm.size, ts=ts, dtype=torch.float32, scratch_rows=anc), 1e-4),
        ("prefill", dict(Q_rows=128, layers=32, H=32, Hkv=32, D=128, M=256, S=0, ts=0,
                         dtype=torch.bfloat16, causal_offset=0), 2e-2),
        ("ar_step", dict(Q_rows=1, layers=32, H=32, Hkv=32, D=128, M=256, S=1, ts=ts,
                         dtype=torch.bfloat16), 2e-2),
        ("redraft_68m", dict(Q_rows=1, layers=2, H=12, Hkv=12, D=64, M=256, S=0, ts=0,
                             dtype=torch.bfloat16, causal_offset=ts), 2e-2),
    ]
    for Q in (1, 16, 64):   # phase 7's f32 curve: kv_len 128, a causal scratch of Q rows
        cases.append((f"f32_q{Q}", dict(
            Q_rows=Q, layers=4, H=32, Hkv=32, D=128, M=256, S=Q, ts=128, dtype=torch.float32,
            scratch_rows=torch.tril(torch.ones(Q, Q, dtype=torch.bool, device="cuda"))), 1e-4))
    for lvl, (w, m) in enumerate(draft_scr):
        cases.append((f"grow_68m_l{lvl}", dict(Q_rows=w, layers=2, H=12, Hkv=12, D=64,
                                               M=256, S=gm.size, ts=ts + 1,
                                               dtype=torch.bfloat16, scratch_rows=m), 2e-2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, kw, tol in cases:
        q, k, v, main, sk, sv, scr = attention_case(torch, gen=gen, **kw)
        L, D, H, Hkv = kw["layers"], kw["D"], kw["H"], kw["Hkv"]
        scale = D ** -0.5
        itemsize = 2 if kw["dtype"] == torch.bfloat16 else 4
        # The bf16 kernel's decomposition: blocks per (query tile, head), and
        # the key tiles each query tile reads after the prefix skip (of all).
        M, S = main.shape[1], scr.shape[1]
        ext = tile_extents(main, scr)
        read = int(((ext + TILE_K - 1) // TILE_K).sum())
        walk = (-(-M // TILE_K) + -(-S // TILE_K)) * ext.shape[0]
        route = (f"splits {split_count(q.shape[0], H, M, S, sms, kw['dtype'])}, "
                 f"key tiles {read}/{walk}")
        formats = KV_FORMATS if name in ("verify", "verify_f32", "prefill", "ar_step") \
            else ("float",)
        for fmt in formats:
            kname, kv_item = counter(fmt, kw["dtype"]), KV_FORMATS[fmt]
            if fmt == "float":
                km, vm, ks, vs = k, v, [None] * L, [None] * L
                kd, vd = k, v
            else:   # the float rows quantized as a prefill or a commit writes them
                quant = quantize_kv_rows if fmt == "int8" else (
                    lambda x, f=fmt: quantize_kv_rows4(x, packing=f[5:]))
                (km, ks), (vm, vs) = quant(k), quant(v)
                ints = (lambda x: x) if fmt == "int8" else (
                    lambda x, f=fmt: unpack_kv_rows4(x, packing=f[5:]))
                kd = (ints(km).float() * ks[..., None]).to(kw["dtype"])
                vd = (ints(vm).float() * vs[..., None]).to(kw["dtype"])
            call = lambda fn, i: fn(q, km[i], vm[i], main, sk[i], sv[i], scr, scale=scale,  # noqa: E731
                                    ks=ks[i], vs=vs[i])
            got, want = call(tree_attention, 0), call(tree_attention_plain, 0)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            if not ok or not torch.isfinite(got).all():
                fail(f"{kname}[{name}] disagrees with its plain version: "
                     f"max |err| {err} (tol {tol})")
            kern = [lambda i=i: call(tree_attention, i) for i in range(L)]
            plain = [lambda i=i: call(tree_attention_plain, i) for i in range(L)]
            lib_ms, f64_note = None, ""
            if H == Hkv:
                qb = q.transpose(0, 1)[None]                       # [1, H, Q, D]
                kk = [torch.cat([kd[i], sk[i]]).transpose(0, 1)[None] for i in range(L)]
                vv = [torch.cat([vd[i], sv[i]]).transpose(0, 1)[None] for i in range(L)]
                full_mask = torch.cat([main, scr], dim=1)
                lib_ms = device_ms([lambda i=i: sdpa(qb, kk[i], vv[i], attn_mask=full_mask,
                                                     scale=scale) for i in range(L)])
                if kw["dtype"] == torch.float32:
                    ref = f64_reference(q, km[0], vm[0], main, sk[0], sv[0], scr, scale,
                                        ks[0], vs[0])
                    lib = sdpa(qb, kk[0], vv[0], attn_mask=full_mask, scale=scale)[0]
                    top = ref.abs().max().item()
                    e_k = (got.double() - ref).abs().max().item() / top
                    e_lib = (lib.transpose(0, 1).double() - ref).abs().max().item() / top
                    if not e_k <= 1e-4:
                        fail(f"{kname}[{name}]: error against f64 {e_k} of max|out| > 1e-4")
                    f64_note = (f"; against f64, x max|out| {top:.3g}: kernel {e_k:.3g}, "
                                f"sdpa f32 {e_lib:.3g}")
                del kk, vv
            ms, plain_ms = device_ms(kern), device_ms(plain)
            bound, by = attention_bound(q, main, scr, D, H, Hkv, itemsize, kv_item)
            log(f"  {kname}[{name}] Q={q.shape[0]} H={H} Hkv={Hkv} D={D} M={main.shape[1]} "
                f"S={scr.shape[1]} {str(kw['dtype'])[6:]}: max|err| {err:.3g} (tol {tol}) "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"sdpa {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
                f"  bound {bound:.5f} ms ({by}); {route}{f64_note}")
            if name in ("verify", "verify_f32"):
                results.append(dict(
                    name=kname, route="cuda", source="sequoia_torch/csrc/tree_attention.cu",
                    replaces="sequoia_tpu/kernels/tree_attention.py:111",
                    shape=f"verify Q={q.shape[0]} H={H} D={D} M={main.shape[1]} "
                          f"S={scr.shape[1]} {'bf16' if itemsize == 2 else 'f32'}, "
                          f"main cache {fmt}",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, library_ms=lib_ms))
            del km, vm, kd, vd, kern, plain


def f64_reference(q, k, v, main, sk, sv, scr, scale, ks, vs):
    """The plain version in f64 (quantized rows cast exactly, scales
    widened): the reference of the f32 route's error."""
    from sequoia_torch.kernels.tree_attention import tree_attention_plain

    d = lambda x: x.double() if x is not None and x.is_floating_point() else x  # noqa: E731
    return tree_attention_plain(d(q), d(k), d(v), main, d(sk), d(sv), scr, scale=scale,
                                ks=d(ks), vs=d(vs))


def top_p_bound(R, V, from_logits):
    """Least time for the function, not for one design of it: the input
    read once and the thresholds written; from logits, also the softmax's
    f32 operations (divide by T, subtract the max, exp, normalize: 4 a
    value)."""
    nbytes = R * V * 4 + R * 4
    ops = R * V * 4 if from_logits else 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["f32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


TOP_P_SPECS = [  # counter (the route the wrapper picks from V), rows, from logits, V
    ("top_p_threshold_from_logits", "gm", True, 32000),
    ("top_p_threshold_from_logits", 1, True, 32000),
    ("top_p_threshold_fused", 1, False, 32000),
    ("top_p_threshold_fused", "gm", False, 32000),
    ("top_p_threshold_from_logits_cluster", "gm", True, 128256),   # Llama-3
    ("top_p_threshold_from_logits_cluster", 1, True, 128256),
    ("top_p_threshold_fused_cluster", 1, False, 128256),
    ("top_p_threshold_fused_cluster", "gm", False, 128256),
]


def check_top_p(torch, gm, results):
    """Both top-p kernels on both routes, at R = 1 and R = the tree size:
    V = 32000 (one block per row) and V = 128256 (a cluster per row). The
    fused kernel must equal the plain version bit for bit; the from-logits
    kernel may differ only at an ill-conditioned boundary token, with |dt|
    <= 1e-6 on every other row; two launches on the same input must give
    the same bits. Timed on every kind of row of `qmm_times.TOP_P_KINDS`
    (peaked, flat at T = 0.6 and 1, uniform, tied), each held as strictly;
    the kernels line gets the flat rows' time, the main path's (random
    weights give logits of std ~1). Beside each time, the floor: an empty
    kernel of the kernel's grid (and cluster shape) in the same harness."""
    from sequoia_torch.cli.qmm_times import TOP_P_KINDS, top_p_logits
    from sequoia_torch.kernels import build
    from sequoia_torch.kernels import top_p as tp

    lib = build.load()

    def empty(R, V):   # the stream is read at call time: the capturing one
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.sequoia_top_p_empty(R, V, int(V > tp.REGISTER_VOCAB), stream),
                    "top_p_empty")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    T = FULL["T"]
    for name, R, from_logits, V in TOP_P_SPECS:
        t0 = time.perf_counter()
        R = gm.size if R == "gm" else R
        replaces = "sequoia_tpu/kernels/top_p.py:" + ("99" if from_logits else "140")
        worst, flips = 0.0, 0
        for top_p in (0.5, 0.9, 0.99):
            logits = torch.randn(R, V, generator=gen, device="cuda") * 4
            probs = torch.softmax(logits / T, dim=-1)
            before = build.launches[name]
            if from_logits:
                got = tp.top_p_threshold_from_logits(logits, top_p, T)
                again = tp.top_p_threshold_from_logits(logits, top_p, T)
                want = tp.top_p_threshold_from_logits_plain(logits, top_p, T)
            else:
                got = tp.top_p_threshold_fused(probs, top_p)
                again = tp.top_p_threshold_fused(probs, top_p)
                want = tp.top_p_threshold_plain(probs, top_p)
            torch.cuda.synchronize()
            if build.launches[name] != before + 2:
                fail(f"{name} R={R} V={V}: the wrapper took another route")
            if not torch.equal(got, again):
                fail(f"{name} R={R} V={V} top_p={top_p}: two launches on one input differ")
            if not from_logits and not torch.equal(got, want):
                fail(f"{name} R={R} V={V} top_p={top_p}: not bit-identical to the plain "
                     f"version: max |dt| {(got - want).abs().max().item()}")
            try:
                flips += tp.boundary_disagreements(probs, got, want, top_p)
            except ValueError as e:
                fail(f"{name} R={R} V={V} top_p={top_p}: nuclei differ: {e}")
            same = ((probs >= got[:, None]) == (probs >= want[:, None])).all(dim=1)
            dt = torch.where(same, (got - want).abs(), 0.0).max().item()
            if dt > 1e-6:
                fail(f"{name} R={R} V={V} top_p={top_p}: |dt| {dt} on a row with the same "
                     "nucleus")
            worst = max(worst, dt)
        # Times on each kind of row (qmm_times.TOP_P_KINDS); the first input of
        # each is held as strictly as the rows above.
        top_p, kind_ms = FULL["P"], {}
        for kind in TOP_P_KINDS:
            xs, Tk = zip(*(top_p_logits(torch, kind, R, V, gen) for _ in range(16)))
            Tk = Tk[0]
            if from_logits:
                kern = [lambda x=x: tp.top_p_threshold_from_logits(x, top_p, Tk) for x in xs]
                plain = [lambda x=x: tp.top_p_threshold_from_logits_plain(x, top_p, Tk)
                         for x in xs]
                probs = torch.softmax(xs[0] / Tk, dim=-1)
            else:
                xs = [torch.softmax(x / Tk, dim=-1) for x in xs]
                kern = [lambda x=x: tp.top_p_threshold_fused(x, top_p) for x in xs]
                plain = [lambda x=x: tp.top_p_threshold_plain(x, top_p) for x in xs]
                probs = xs[0]
            got, again, want = kern[0](), kern[0](), plain[0]()
            if not torch.equal(got, again):
                fail(f"{name} R={R} V={V} {kind} rows: two launches on one input differ")
            if not from_logits and not torch.equal(got, want):
                fail(f"{name} R={R} V={V} {kind} rows: not bit-identical to the plain version")
            try:
                flips += tp.boundary_disagreements(probs, got, want, top_p)
            except ValueError as e:
                fail(f"{name} R={R} V={V} {kind} rows: nuclei differ: {e}")
            same = ((probs >= got[:, None]) == (probs >= want[:, None])).all(dim=1)
            worst = max(worst, torch.where(same, (got - want).abs(), 0.0).max().item())
            if worst > 1e-6:
                fail(f"{name} R={R} V={V} {kind} rows: |dt| {worst} on a row with the same "
                     "nucleus")
            kind_ms[kind] = device_ms(kern)
            if kind == "flat":   # the main path's rows: random weights give logits of std ~1
                plain_ms = device_ms(plain, replays=5)
            del xs, kern, plain, probs
        ms = kind_ms["flat"]
        floor_ms = device_ms([lambda: empty(R, V)] * 16)
        bound, by = top_p_bound(R, V, from_logits)
        route = (f"cluster of {tp.cluster_size(V)} blocks per row" if V > tp.REGISTER_VOCAB
                 else "one block per row")
        log(f"  {name} R={R} V={V} ({route}): max|dt| {worst:.3g} on rows with the same "
            f"nucleus, {flips} of {(3 + len(TOP_P_KINDS)) * R} rows differ only at an "
            f"ill-conditioned boundary token{'' if from_logits else ' (thresholds bit-identical)'}"
            f", two launches equal; kernel ms by rows: "
            + ", ".join(f"{k} {v:.4f}" for k, v in kind_ms.items())
            + f"; flat: plain {plain_ms:.4f} ms  bound {bound:.5f} ms ({by}, {ms / bound:.1f}x)"
            f"  empty kernel of its grid {floor_ms:.4f} ms ({ms / floor_ms:.2f}x); library: "
            f"none; {time.perf_counter() - t0:.1f} s")
        if not any(e["name"] == name for e in results):
            results.append(dict(name=name, route="cuda", source="sequoia_torch/csrc/top_p.cu",
                                replaces=replaces,
                                shape=f"R={R} V={V} f32, logits N(0, 1) at T={FULL['T']}",
                                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by, library_ms=None))


QMM_SHAPES = [  # (K, N, out): the 7B projections and the f32-logit lm_head
    (4096, 4096, "bf16"), (4096, 11008, "bf16"), (11008, 4096, "bf16"), (4096, 32000, "f32")]
QMM_REPORT = (64, 4096, 11008)   # the shape of the kernels line: verify, MLP up
QMM_SPLIT_SOURCE = "sequoia_torch/csrc/split_bf16x3.cu"   # f32 x -> three bf16 planes
QMM_A8_SOURCE = "sequoia_torch/csrc/quant_matmul_a8.cu"   # the activation quantizer
QMM_SM90_SOURCE = "sequoia_torch/csrc/quant_matmul_int8_sm90.cu"
QMM_SM90_4_SOURCE = "sequoia_torch/csrc/quant_matmul_int4_sm90.cu"
SM90_ROWS = (1, 16, 64, 128, 256)
A8_PART_ROWS = (1, 64, 256)   # the int8-activation routes' parts are timed at these R
QUANT_CALLS = 64              # calls a quantizer (and empty-kernel) timing graph holds
QMM_KERNELS = {
    # name: weight bits, rows at the 7B shapes, TPU counterpart, source, int8
    # activations. The names of F32_KERNELS take f32 x (split into bf16
    # planes); the others bf16 x.
    "quant_matmul_int8_wgmma": (8, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:85",
                                QMM_SM90_SOURCE, False),
    "quant_matmul_int8": (8, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:85",
                          QMM_SM90_SOURCE, False),
    "quant_matmul_int4_wgmma": (4, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:125",
                                QMM_SM90_4_SOURCE, False),
    "quant_matmul_int4": (4, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:125",
                          QMM_SM90_4_SOURCE, False),
    "quant_matmul_tiled_wgmma": (4, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:197",
                                 QMM_SM90_4_SOURCE, False),
    "quant_matmul_tiled": (4, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:197",
                           QMM_SM90_4_SOURCE, False),
    "quant_matmul_w4a8": (4, SM90_ROWS, "sequoia_tpu/kernels/quant_matmul.py:99",
                          QMM_SM90_4_SOURCE, True),
    "quant_matmul_w8a8_wgmma": (8, (1, 16, 64, 128, 256), "sequoia_tpu/quant/qtensor.py:176",
                                QMM_SM90_SOURCE, True),
}


F32_KERNELS = ("quant_matmul_int8", "quant_matmul_int4", "quant_matmul_tiled")


def qmm_cases(name, rows):
    """(R, K, N, x, out) of one kernel: every 7B shape at `rows` with bf16 x,
    a ragged small shape and 300 rows (two row tiles). The f32-x kernels
    with f32 x and out, at every 7B shape and the ragged one (their row
    tiles stop at 128 or 64, so R = 256 already runs several)."""
    if name in F32_KERNELS:
        return [(R, K, N, "f32", "f32") for K, N, _ in QMM_SHAPES for R in rows] + [
            (5, 96, 200, "f32", "f32")]
    cases = [(R, K, N, "bf16", out) for K, N, out in QMM_SHAPES for R in rows]
    cases.append((5, 96, 200, "bf16", "bf16"))        # ragged: masked loads and edges
    cases.append((300, 4096, 4096, "bf16", "bf16"))
    return cases


def qmm_report(name):
    """The case of a kernel's entry in the kernels line."""
    if name in F32_KERNELS:
        return (64, 4096, 4096, "f32")
    return QMM_REPORT + ("bf16",)


def qmm_bound(R, K, N, bits, x_item, out_item, a8=False):
    """Least time: the packed weight, x, the output and the scale move
    once; 2*R*K*N operations at the peak of the product's type and unit
    (bf16 tensor cores; int8 for the activation-quantized kernels). f32 x
    takes three bf16 passes: the tensor cores' products are exact in f32
    only for bf16 operands, and an f32 x is exactly the sum of three bf16
    planes (one pass would round x to 8 bits, TF32 to 11), so 3 * 2*R*K*N
    bf16 operations are the least tensor-core work that gives the f32
    product (the CUDA cores' f32 rate, 67 TFLOP/s, would take 4.9x as long)."""
    nbytes = K * N * bits // 8 + R * K * x_item + R * N * out_item + N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_FLOPS["int8" if a8 else "bf16"]
    t_ops = (3 if x_item == 4 else 1) * 2 * R * K * N / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def qmm_calls(qm, name):
    """(kernel wrapper, plain version) of one quant-matmul kernel, both as
    f(x, q, scale, out_dtype)."""
    if name.startswith("quant_matmul_tiled"):
        return (lambda x, q, s, o: qm.quant_matmul_tiled(x, q, s, out_dtype=o),
                lambda x, q, s, o: qm.quant_matmul_tiled_plain(x, q, s, out_dtype=o))
    if name == "quant_matmul_w8a8_wgmma":
        return (lambda x, q, s, o: qm.quant_matmul_w8a8(x, q, s, out_dtype=o),
                lambda x, q, s, o: qm.quant_matmul_w8a8_plain(x, q, s, out_dtype=o))
    kw = dict(bits=8) if name.startswith("quant_matmul_int8") else dict(bits=4)
    if name == "quant_matmul_w4a8":
        kw["unpack"] = "w4a8"
    return (lambda x, q, s, o: qm.quant_matmul(x, q, s, out_dtype=o, **kw),
            lambda x, q, s, o: qm.quant_matmul_plain(x, q, s, out_dtype=o, **kw))


def sm90_route(qm, name, R, K, N):
    """A wgmma kernel's load path, cluster size, row tile and stage depth
    for a shape (the stage bytes and shared-memory budgets of
    csrc/quant_matmul_int8_sm90.cu and csrc/quant_matmul_int4_sm90.cu)."""
    kind = ("int4" if "int4" in name or "tiled" in name else
            "w4a8" if "w4a8" in name else "w8a8" if "w8a8" in name else "int8")
    planes = 3 if name in F32_KERNELS else 1    # x tiles a stage: bf16 planes of f32 x
    if planes > 1:
        kind += "_f32"
    rt, splits = qm._sm90_tiling(R, K, N, kind, 0)
    if kind.startswith(("int4", "w4a8")):
        tma = ("tiled" in name or N % 16 == 0) and K % (16 if kind == "w4a8" else 8) == 0
        x_row = 64 if kind == "w4a8" else 128      # bytes of 64 k of x8 or bf16 x
        stage, budget = 2 * planes * rt * x_row + 64 * 128, 216 * 1024
    else:
        tma = N % 16 == 0 and K % (16 if kind == "w8a8" else 8) == 0
        stage, budget = planes * rt * 128 + (128 if kind == "w8a8" else 64) * 128, 200 * 1024
    if planes > 1:
        budget = 224 * 1024
    return (f"{'TMA' if tma else 'producer-warp copies'}, cluster of "
            f"{splits}, row tile {rt}, "
            f"{min(budget // stage, 16)} stages of {stage // 1024} KB")


def check_quant_matmul(torch, results):
    """Every quant-matmul kernel against its plain version at every 7B shape
    and a ragged small one (`qmm_cases`). Tolerances: the weight-only
    kernels (tiled included) 2e-2 relative for a bf16 output and 1e-4 for
    an f32 one (exact products, f32 sums in another order); the
    activation-quantized routes (w4a8, w8a8) 0: exact int32 products and
    the plain version's order of the f32 rescale give equal bits. Timing
    cycles through enough weight matrices that a pass exceeds the 50 MB L2;
    the activation-quantized and f32-x routes also through as many inputs
    x, and every call captured in the timing graph is held to its plain
    version after the replays (a matmul that read x8 or the planes before
    the kernel before it wrote them would show the previous call's). For
    them the line also gives, at R in A8_PART_ROWS, the route without the
    programmatic dependent launch, the matmul alone on x quantized (or
    split) beforehand and the quantizer (or split) alone, so that what the
    launch hides reads off (`dep_times`); and, for w4a8, the bf16-x int4
    kernel on the same weights. The library yardstick is torch.matmul on
    the dequantized weight (cuBLAS; bf16, twice the int8 bytes, or f32 for
    f32 x); beside it torch._weight_int8pack_mm
    for int8, and torch._int_mm (the int8 x int8 product alone, without
    quantizer and rescale) for w8a8, where the installed PyTorch takes the
    shape. The wgmma kernels' times against the kernels they replaced come
    from sequoia_torch/cli/qmm_times.py, run on both checkouts in one call.
    The f32-x kernels (split into bf16 planes, then the planes
    instantiations) are also held to an f64 product (1e-4 of its largest
    |value|), beside cuBLAS f32's error (TF32 off: main() sets
    allow_tf32 = False), and two launches on one input to equal bits."""
    from sequoia_torch.kernels import build
    from sequoia_torch.kernels import quant_matmul as qm
    from sequoia_torch.quant import qtensor
    from sequoia_torch.quant.qtensor import QuantizedTensor, dequantize, tile_int4

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    int8pack, int_mm = hasattr(torch, "_weight_int8pack_mm"), hasattr(torch, "_int_mm")
    for name, (bits, rows, replaces, source, a8) in QMM_KERNELS.items():
        t_name = time.perf_counter()
        kernel, plain_fn = qmm_calls(qm, name)
        tiled = name.startswith("quant_matmul_tiled")
        for R, K, N, xs, outs in qmm_cases(name, rows):
            x_dt = torch.bfloat16 if xs == "bf16" else torch.float32
            out_dt = torch.bfloat16 if outs == "bf16" else torch.float32
            wbytes = K * N * bits // 8
            n = max(2, -(-150_000_000 // wbytes))
            Kq = K if bits == 8 else K // 2
            rowmajor = [torch.randint(-128, 128, (Kq, N), generator=gen, device="cuda",
                                      dtype=torch.int8) for _ in range(n)]
            ss = [torch.rand(1, N, generator=gen, device="cuda") * 0.02 + 0.001
                  for _ in range(n)]
            qs = [tile_int4(QuantizedTensor(q, s)).q for q, s in zip(rowmajor, ss)] \
                if tiled else rowmajor
            x = torch.randn(R, K, generator=gen, device="cuda").to(x_dt)
            # Routes whose matmul waits for the kernel that prepares x: x is
            # cycled with the weights, and each replayed call held to its
            # plain version.
            dep = a8 or name in F32_KERNELS
            xc = [x] + [torch.randn(R, K, generator=gen, device="cuda").to(x_dt)
                        for _ in range(n - 1 if dep else 0)]
            xi = lambda i: xc[i % len(xc)]  # noqa: E731  the input of cycled call i
            before = build.launches[name]
            got = kernel(x, qs[0], ss[0], out_dt)
            want = plain_fn(x, qs[0], ss[0], out_dt)
            torch.cuda.synchronize()
            if build.launches[name] != before + 1:
                fail(f"{name} R={R} K={K} N={N} x {xs}: the wrapper took another kernel")
            tol = 0.0 if a8 else 2e-2 if out_dt == torch.bfloat16 else 1e-4
            peak = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all() or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol * peak):
                fail(f"{name} R={R} K={K} N={N} x {xs} out {outs} disagrees with its "
                     f"plain version: max |err| {err} (tol {tol} x max|plain| {peak})")
            if name in F32_KERNELS and not torch.equal(got, kernel(x, qs[0], ss[0], out_dt)):
                fail(f"{name} R={R} K={K} N={N}: two launches on one input differ")
            kern = [lambda i=i: kernel(xi(i), qs[i], ss[i], out_dt) for i in range(n)]
            plain = [lambda i=i: plain_fn(xi(i), qs[i], ss[i], out_dt) for i in range(n)]
            replayed = []
            ms, plain_ms = device_ms(kern, replays=10, outs=replayed), device_ms(plain, replays=3)
            dep_line = ""
            if dep:
                for i, o in enumerate(replayed):
                    want_i = plain_fn(xi(i), qs[i], ss[i], out_dt).float()
                    e = (o.float() - want_i).abs().max().item()
                    if not torch.allclose(o.float(), want_i, rtol=tol,
                                          atol=tol * want_i.abs().max().item()):
                        fail(f"{name} R={R} K={K} N={N}: call {i} replayed in the graph "
                             f"differs from its plain version: max |err| {e} (tol {tol})")
                    err = max(err, e)
                dep_line = dep_times(qm, name, R, K, N, qs, ss, xi, out_dt, ms)
            del replayed
            deq = [dequantize(QuantizedTensor(rowmajor[i], ss[i]), K, x_dt) for i in range(n)]
            lib_ms = device_ms([lambda i=i: torch.matmul(x, deq[i]) for i in range(n)],
                               replays=10)
            f64 = ""
            if name in F32_KERNELS:   # both against the exact product, in f64
                w = rowmajor[0] if bits == 8 else qm.unpack_int4(rowmajor[0])
                ref = (x.double() @ w.double()) * ss[0].double()
                top = ref.abs().max().item()
                e_k = (got.double() - ref).abs().max().item() / top
                e_lib = (torch.matmul(x, deq[0]).double() - ref).abs().max().item() / top
                if e_k > 1e-4:
                    fail(f"{name} R={R} K={K} N={N}: max |err| against the f64 product "
                         f"{e_k:.3g} x its largest |value| (tol 1e-4)")
                f64 = (f"; against f64, x max|f64|: kernel {e_k:.3g}, cuBLAS f32 {e_lib:.3g}; "
                       "two launches equal")
                del w, ref
            other_ms = host = None
            other = ""
            if R == 1 and not a8 and not tiled and xs == "bf16":
                # the model's call on each weight kind, as one AR step makes it
                mm_out = None if outs == "bf16" else torch.float32
                wq = QuantizedTensor(qs[0], ss[0])
                qtensor.set_w8a8("off")
                host = (host_us(lambda: qtensor.matmul(x, wq, out_dtype=mm_out)),
                        host_us(lambda: qtensor.matmul(x, deq[0], out_dtype=mm_out)))
            del deq
            if name == "quant_matmul_int8_wgmma" and int8pack:
                qt = [q.T.contiguous() for q in qs]
                st = [s.reshape(-1).to(torch.bfloat16) for s in ss]
                try:
                    torch._weight_int8pack_mm(x, qt[0], st[0])
                except (RuntimeError, NotImplementedError) as e:
                    int8pack = False
                    log(f"  torch._weight_int8pack_mm is not available on CUDA here: "
                        f"{str(e).splitlines()[0][:100]}")
                else:
                    other, other_ms = "_weight_int8pack_mm", device_ms(
                        [lambda i=i: torch._weight_int8pack_mm(x, qt[i], st[i])
                         for i in range(n)], replays=10)
                del qt, st
            if name == "quant_matmul_w8a8_wgmma" and int_mm and R > 16 and N % 8 == 0:
                x8, _ = qm.quantize_activations_plain(x)
                try:
                    torch._int_mm(x8, qs[0])
                except (RuntimeError, NotImplementedError) as e:
                    int_mm = False
                    log(f"  torch._int_mm is not available here: "
                        f"{str(e).splitlines()[0][:100]}")
                else:
                    other, other_ms = "_int_mm", device_ms(
                        [lambda i=i: torch._int_mm(x8, qs[i]) for i in range(n)], replays=10)
            bound, by = qmm_bound(R, K, N, bits, x.element_size(), got.element_size(), a8)
            route = (f"; {sm90_route(qm, name, R, K, N)}" if name.endswith("_wgmma")
                     or name in ("quant_matmul_w4a8",) + F32_KERNELS else "")
            log(f"  {name} R={R} K={K} N={N} x {xs} out {outs}: max|err| {err:.3g} "
                f"(tol {tol:.3g} x {peak:.3g}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"cuBLAS {xs} dequantized {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"
                + (f"  {other} {other_ms:.4f} ms" if other_ms is not None else "")
                + f"  bound {bound:.5f} ms ({by}, {ms / bound:.2f}x)"
                f"  [{n} weights cycled]{f64}{dep_line}{route}"
                + (f"; host µs per qtensor.matmul call: quantized {host[0]:.1f}, "
                   f"bf16 weight {host[1]:.1f}" if host is not None else ""))
            if (R, K, N, xs) == qmm_report(name):
                results.append(dict(
                    name=name, route="cuda", source=source, replaces=replaces,
                    shape=f"R={R} K={K} N={N} x {xs} out {outs}",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=lib_ms))
            del qs, rowmajor, ss, kern, plain
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t_name:.1f} s")
    qtensor.set_w8a8("auto")
    check_quantize_activations(torch, qm, gen, results)
    check_split(torch, qm, gen, results)


def dep_times(qm, name, R, K, N, qs, ss, xi, out_dt, ms):
    """The parts of a route whose matmul is a programmatic dependent launch
    after the kernel that prepares x (w4a8 and w8a8: the quantizer; the
    f32-x routes: the split into bf16 planes) at one shape, device ms: at R
    in A8_PART_ROWS, the route without the programmatic dependent launch,
    the matmul alone on x prepared beforehand, the preparing kernel alone,
    and what the launch hides of the route; for w4a8 the bf16-x int4 kernel
    on the same weights and inputs."""
    w4 = name == "quant_matmul_w4a8"
    if name in F32_KERNELS:
        part = "split"
        prep = lambda x: (qm.split_bf16x3(x), None)  # noqa: E731  (planes, no sx)
        launch = (qm._launch_int8_sm90 if name == "quant_matmul_int8" else functools.partial(
            qm._launch_int4_sm90, tiled=name == "quant_matmul_tiled"))
    else:
        part, prep = "quantizer", qm.quantize_activations
        launch = qm._launch_int4_sm90 if w4 else qm._launch_int8_sm90
    n, line = len(qs), ""
    if R in A8_PART_ROWS:
        def no_pdl(i):
            xp, sx = prep(xi(i))
            return launch(xp, qs[i], ss[i], out_dt, sx=sx, pdl=False)

        pre = [prep(xi(i)) for i in range(n)]
        nopdl_ms = device_ms([lambda i=i: no_pdl(i) for i in range(n)], replays=10)
        mm_ms = device_ms([lambda i=i: launch(pre[i][0], qs[i], ss[i], out_dt, sx=pre[i][1])
                           for i in range(n)], replays=10)
        prep_ms = device_ms([lambda i=i: prep(xi(i)) for i in range(n)], replays=10)
        line = (f"; route without PDL {nopdl_ms:.4f} ms, matmul alone {mm_ms:.4f} ms, "
                f"{part} {prep_ms:.4f} ms, PDL hides {(nopdl_ms - ms) * 1e3:.2f} us")
    if w4:
        int4_ms = device_ms([lambda i=i: qm.quant_matmul(xi(i), qs[i], ss[i], bits=4,
                                                          out_dtype=out_dt)
                             for i in range(n)], replays=10)
        line += f"; bf16-x int4 kernel {int4_ms:.4f} ms ({ms / int4_ms:.2f}x)"
    return line


def check_quantize_activations(torch, qm, gen, results):
    """The activation quantizer against its plain version: the same int8
    values and the same f32 scales, bit for bit (tolerance 0), on every
    call of the timing graph. Beside its time, the floor: an empty kernel
    of its grid (one block per row, the quantizer's block size) in the same
    harness, each graph QUANT_CALLS calls long so that device time, not
    the events around a replay, dominates; and the least time for its
    bytes."""
    from sequoia_torch.kernels import build

    lib = build.load()

    def empty(R, threads):   # the stream is read at call time: the capturing one
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.sequoia_empty_kernel(R, threads, stream), "empty_kernel")

    for R, K in ((1, 4096), (64, 4096), (64, 11008), (256, 4096), (256, 11008), (5, 100)):
        xs = [torch.randn(R, K, generator=gen, device="cuda").to(torch.bfloat16) * 3
              for _ in range(8)] * (QUANT_CALLS // 8)
        replayed = []
        ms = device_ms([lambda x=x: qm.quantize_activations(x) for x in xs], outs=replayed)
        err = 0
        for x, (got8, gots) in zip(xs, replayed):
            want8, wants = qm.quantize_activations_plain(x)
            err = max(err, (got8.int() - want8.int()).abs().max().item(),
                      (gots - wants).abs().max().item())
        if err != 0:
            fail(f"quantize_activations R={R} K={K} differs from its plain version: {err}")
        plain_ms = device_ms([lambda x=x: qm.quantize_activations_plain(x) for x in xs[:8]])
        threads = qm.quantizer_block(K, 2)[1]
        floor_ms = device_ms([lambda: empty(R, threads)] * QUANT_CALLS)
        nbytes = R * K * 2 + R * K + R * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 6 * R * K / PEAK_FLOPS["f32"] * 1e3
        bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        log(f"  quantize_activations R={R} K={K} bf16: equal bits on {len(xs)} calls; kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.3g} ms ({by})  empty kernel of "
            f"its grid ({R} x {threads} threads) {floor_ms:.4f} ms: {ms / floor_ms:.2f}x the "
            f"floor, {ms / max(bound, floor_ms):.2f}x max(bound, floor)")
        if (R, K) == QMM_REPORT[:2]:
            results.append(dict(
                name="quantize_activations", route="cuda", source=QMM_A8_SOURCE,
                replaces="sequoia_tpu/kernels/quant_matmul.py:361",
                shape=f"R={R} K={K} bf16 (verify, MLP up)", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None))


def check_split(torch, qm, gen, results):
    """The split of f32 x into three bf16 planes, the f32-x route's first
    kernel, against its plain version: equal bits on every call of the
    timing graph (QUANT_CALLS calls cycling 8 inputs), at the route's row
    counts and K. Beside its time, the least time for its bytes (R*K*4 read,
    R*K*6 written)."""
    for R, K in ((1, 4096), (64, 4096), (64, 11008), (256, 11008), (5, 97)):
        xs = [torch.randn(R, K, generator=gen, device="cuda") * 3
              for _ in range(8)] * (QUANT_CALLS // 8)
        replayed = []
        ms = device_ms([lambda x=x: qm.split_bf16x3(x) for x in xs], outs=replayed)
        for x, got in zip(xs, replayed):
            want = qm.split_bf16x3_plain(x)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                fail(f"split_bf16x3 R={R} K={K} differs from its plain version")
        plain_ms = device_ms([lambda x=x: qm.split_bf16x3_plain(x) for x in xs[:8]])
        bound = R * K * 10 / HBM_BYTES_PER_S * 1e3
        log(f"  split_bf16x3 R={R} K={K} f32: equal bits on {len(xs)} calls; kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bound:.3g} ms (bytes, {ms / bound:.1f}x)")
        if (R, K) == (64, 4096):
            results.append(dict(
                name="split_bf16x3", route="cuda", source=QMM_SPLIT_SOURCE,
                replaces="sequoia_tpu/kernels/quant_matmul.py:294",
                shape=f"R={R} K={K} f32 (the f32-x route's planes)", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None))


# ---------------------------------------------------------------------------
# Phase 4: small parity on the card
# ---------------------------------------------------------------------------

def tree_to(t, dev):
    """A params tree (nested NamedTuples of tensors) on `dev`."""
    if hasattr(t, "to") and not isinstance(t, tuple):
        return t.to(dev)
    return type(t)(*(tree_to(x, dev) for x in t))


def tile_model(params):
    """`tile_int4` over the seven projections and the head of a packed-int4
    model (the layout of `quant_matmul_tiled`)."""
    from sequoia_torch.quant.qtensor import QuantizedTensor, tile_int4

    lay = params.layers
    tiled = type(lay)(*(tile_int4(w) if isinstance(w, QuantizedTensor) else w for w in lay))
    return params._replace(layers=tiled, lm_head=tile_int4(params.lm_head))


def small_parity(torch):
    """test-small on the card. f32 x with an f32, an int8, an int4 and a
    tiled-int4 target (the quantized weights run the f32-x path of the quant
    kernels); w8a8 forced on; an int8, an int4 head-paired and an int4
    dsplit KV cache; then bf16 int8, int4 and tiled-int4 targets (the
    tensor-core path of every 7B projection), forward only."""
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.kvcache.cache import KVCache, KVCache4, KVCache8
    from sequoia_torch.quant import qtensor
    from sequoia_torch.quant.quantize import random_quantized_model
    from sequoia_torch.trees.growmap import uniform_tree

    cfg = get_config("test-small")
    draft = random_params(cfg, 7, dtype=torch.float32, device="cuda")
    float_kv = lambda dt: (lambda dev: KVCache.init(cfg, 64, dt, dev))  # noqa: E731
    qtensor.set_w8a8("off")   # the int8 target below is weight-only
    targets = {}
    for kind in ("f32", "int8", "int4", "tiled-int4"):
        if kind == "f32":
            target = random_params(cfg, 8, dtype=torch.float32, device="cuda")
        elif kind == "tiled-int4":
            target = tile_model(targets["int4"])
        else:
            target = random_quantized_model(cfg, 8, bits=int(kind[3:]), dtype=torch.float32,
                                            device="cuda")
        targets[kind] = target
        worst, _, _ = forward_card_vs_cpu(torch, cfg, target, float_kv(torch.float32), 32,
                                          uniform_tree(2, 2))
        if worst > 1e-4:
            fail(f"test-small {kind} forward on the card differs from the CPU: {worst}")
        log(f"  {kind} target: forward card vs CPU (test-small f32 x, prefill 32 + verify 7): "
            f"max|err| {worst:.3g} (tol 1e-4)")
        greedy_parity(torch, cfg, draft, target, kind)

    # Activation- and cache-quantized variants. Card and CPU sum in another
    # order, so a value on a rounding tie may quantize one step apart on the
    # two devices; one such step moves a logit by about 1e-4 of the largest.
    # The logits are held to 1e-3 x max|CPU logits| (an H100 read 5e-7 x,
    # no byte differing), and the cache bytes that differ are counted.
    tol = 1e-3
    qtensor.set_w8a8("on")
    worst, peak, _ = forward_card_vs_cpu(torch, cfg, targets["int8"], float_kv(torch.float32),
                                         32, uniform_tree(2, 2))
    if worst > tol * peak:
        fail(f"test-small int8 w8a8 forward on the card differs from the CPU: {worst}")
    log(f"  int8 target, w8a8 on: forward card vs CPU: max|err| {worst:.3g} "
        f"(tol {tol} x max|CPU logits| {peak:.3g})")
    greedy_runs(torch, cfg, draft, targets["int8"], "int8 target, w8a8 on")
    qtensor.set_w8a8("off")
    for label, kv_quant, packing, make_kv in (
            ("int8", "int8", None, lambda dev: KVCache8.init(cfg, 64, device=dev)),
            ("int4 head-paired", "int4", "head",
             lambda dev: KVCache4.init(cfg, 64, packing="head", device=dev)),
            ("int4 dsplit", "int4", "dsplit",
             lambda dev: KVCache4.init(cfg, 64, packing="dsplit", device=dev))):
        worst, peak, flips = forward_card_vs_cpu(torch, cfg, targets["f32"], make_kv, 32,
                                                 uniform_tree(2, 2))
        if worst > tol * peak:
            fail(f"test-small forward with an {label} KV cache differs from the CPU: {worst}")
        log(f"  f32 target, {label} KV cache: forward card vs CPU: max|err| {worst:.3g} "
            f"(tol {tol} x max|CPU logits| {peak:.3g}); {flips} cache bytes differ")
        greedy_runs(torch, cfg, draft, targets["f32"], f"{label} KV cache", kv_quant=kv_quant,
                    kv4_packing=packing)

    # bf16: prefill 24 and a 21-node verify, both in the 17..32-row tile.
    for kind in ("int8", "int4", "tiled-int4"):
        target = random_quantized_model(cfg, 8, bits=8 if kind == "int8" else 4,
                                        dtype=torch.bfloat16, device="cuda")
        if kind == "tiled-int4":
            target = tile_model(target)
        worst, peak, _ = forward_card_vs_cpu(torch, cfg, target, float_kv(torch.bfloat16), 24,
                                             uniform_tree(2, 4))
        # bf16 activations round differently on the two devices (int8 read
        # 6.5e-3 x max|CPU logits| on an H100): about twice that reading.
        tol = 1.5e-2
        if worst > tol * peak:
            fail(f"test-small bf16 {kind} forward on the card differs from the CPU: "
                 f"max|err| {worst} > {tol} x max|CPU| {peak}")
        log(f"  {kind} target, bf16: forward card vs CPU (prefill 24 + verify 21): "
            f"max|err| {worst:.3g} (tol {tol} x max|CPU logits| {peak:.3g})")
    qtensor.set_w8a8("auto")
    capture_failure_is_fatal(torch, cfg, draft, targets["f32"])


def forward_card_vs_cpu(torch, cfg, target, make_kv, n_prefill, tree):
    """The kernel forward (card) against the plain forward (CPU) on the
    same weights: a prefill of `n_prefill` tokens into the cache
    `make_kv(device)`, then a split-mode verify of `tree`. Returns (max |err|
    of the logits, max |CPU logits|, the number of bytes in which the two
    devices' quantized caches differ, or None for a float cache)."""
    from sequoia_torch.core.model import forward
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks

    outs, caches = {}, {}
    for dev, params in (("cuda", target), ("cpu", tree_to(target, "cpu"))):
        kv = make_kv(dev)
        M, dtype = kv.max_length, params.embed.dtype
        toks = torch.arange(10, 10 + n_prefill, device=dev)
        lg1, _ = forward(params, cfg, toks, torch.arange(n_prefill, device=dev), kv, 0,
                         masks.causal_mask(n_prefill, M, 0, dev))
        anc = torch.as_tensor(tree.ancestors, device=dev)
        main, scr = masks.split_tree_masks(anc, n_prefill, M, root_in_main=False)
        scratch = KVCache.init(cfg, anc.shape[0], dtype, dev)
        lg2, _ = forward(params, cfg, toks[:anc.shape[0]], n_prefill + torch.as_tensor(
            tree.depth, device=dev), kv, n_prefill, main, scratch=scratch,
            scratch_offset=0, scratch_mask=scr)
        outs[dev] = (lg1.float().cpu(), lg2.float().cpu())
        caches[dev] = kv
    if not all(bool(torch.isfinite(x).all()) for x in outs["cuda"]):
        fail("non-finite test-small logits on the card")
    flips = None
    if not isinstance(caches["cpu"], KVCache):
        flips = sum(int((getattr(caches["cuda"], n).cpu() != getattr(caches["cpu"], n)).sum())
                    for n in ("k", "v"))
    worst = max((a - b).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    return worst, max(b.abs().max().item() for b in outs["cpu"]), flips


def no_sync(torch, fn, label):
    """Run `fn` (eager launches) under `set_sync_debug_mode("error")`: a
    host read or a blocking copy inside it fails the phase."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        fail(f"{label}: a synchronizing CUDA operation inside the iteration: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def replayed_equals_eager(eng, prompt, label, seeds=(0,), n=40):
    """`generate_fast` (graph replays) gives `generate`'s tokens and counts
    for each seed, all through one captured set of graphs; returns the
    last output."""
    import numpy as np

    for seed in seeds:
        want = eng.generate(prompt, max_new_tokens=n, seed=seed)
        steps = eng.num_large_model_steps
        got = eng.generate_fast(prompt, max_new_tokens=n, seed=seed)
        if not np.array_equal(got, want) or eng.num_large_model_steps != steps:
            fail(f"{label}: replayed tokens differ from eager ones (seed {seed}):\n{want}\n{got}")
    return got


def greedy_runs(torch, cfg, draft, target, label, kv_quant=None, kv4_packing=None):
    """Greedy speculative decoding runs and emits valid tokens, replayed as
    eager, with no host read in an eager iteration. (Under a quantized
    cache it need not equal greedy AR: verify reads float scratch rows that
    AR has already quantized.)"""
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.trees.growmap import uniform_tree
    import numpy as np

    eng = SpecEngine(draft, cfg, target, cfg, uniform_tree(3, 2), algorithm="greedy",
                     max_length=128, prefill_chunk=16, kv_quant=kv_quant, device="cuda")
    if kv4_packing is not None:
        eng._kv4_packing = kv4_packing   # the engine itself picks "head" for an even Hkv
    prompt = np.random.default_rng(5).integers(3, cfg.vocab_size, size=11)
    state = eng.prefill(prompt)
    no_sync(torch, lambda: eng.iterate(state), label)
    out = replayed_equals_eager(eng, prompt, label)
    if len(out) <= len(prompt) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"{label}: greedy speculative decoding produced invalid output {out}")
    log(f"  {label}: greedy spec, {len(out) - len(prompt)} tokens in "
        f"{eng.num_large_model_steps} target steps; replayed == eager; no sync in an "
        "eager iteration")


def greedy_parity(torch, cfg, draft, target, kind):
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.trees.growmap import uniform_tree
    import numpy as np

    gm = uniform_tree(3, 2)
    rng = np.random.default_rng(3)
    ar = ARBaseline(target, cfg, max_length=128, greedy=True, prefill_chunk=16, device="cuda")
    eng = SpecEngine(draft, cfg, target, cfg, gm, algorithm="greedy",
                     max_length=128, prefill_chunk=16, device="cuda")
    for trial in range(3):
        prompt = rng.integers(3, cfg.vocab_size, size=9 + trial)
        exp = ar.generate(prompt, max_new_tokens=40)
        if not np.array_equal(ar.generate_fast(prompt, max_new_tokens=40), exp):
            fail(f"{kind} target: replayed greedy AR != eager (trial {trial})")
        got = replayed_equals_eager(eng, prompt, f"{kind} target, greedy", seeds=(trial,))
        n = min(len(exp), len(got))
        if n <= len(prompt) or not np.array_equal(exp[:n], got[:n]):
            fail(f"{kind} target: greedy spec != greedy AR on the card (trial {trial}):"
                 f"\n{exp}\n{got}")
    log(f"  {kind} target: greedy spec == greedy AR, token for token, eager and replayed "
        "(test-small f32, 3 prompts x 40 tokens)")
    if kind != "f32":
        return
    prompt = np.arange(5, 14)
    for greedy in (True, False):
        ar = ARBaseline(target, cfg, max_length=128, greedy=greedy, temperature=0.7,
                        top_p=0.9, prefill_chunk=16, device="cuda")
        state = ar.prefill(prompt, seed=1)
        no_sync(torch, lambda: ar.step(state), f"AR step (greedy {greedy})")
        for seed in (1, 2):
            if not np.array_equal(ar.generate_fast(prompt, 30, seed=seed),
                                  ar.generate(prompt, 30, seed=seed)):
                fail(f"AR (greedy {greedy}, seed {seed}): replayed tokens differ from eager")
    for algo in ("sequoia", "specinfer", "greedy", "greedys"):
        eng = SpecEngine(draft, cfg, target, cfg, gm, algorithm=algo, max_length=128,
                         temperature=0.7, top_p=0.9, prefill_chunk=16, device="cuda")
        state = eng.prefill(prompt, seed=1)
        no_sync(torch, lambda: eng.iterate(state), algo)
        out = replayed_equals_eager(eng, prompt, algo, seeds=(1, 2), n=30)
        if len(out) <= 9 or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{algo} produced invalid output {out}")
        log(f"  {algo}: {len(out) - 9} tokens in {eng.num_large_model_steps} target steps; "
            "seeds 1 and 2 replayed == eager through one captured set; no sync in an "
            "eager iteration")
    log("  AR (greedy and stochastic): no sync in an eager step; seeds 1 and 2 replayed == "
        "eager")


def capture_failure_is_fatal(torch, cfg, draft, target):
    """A phase that reads the host inside its capture: `generate_fast`
    must raise (no fallback to the eager loop)."""
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.trees.growmap import uniform_tree
    import numpy as np

    eng = SpecEngine(draft, cfg, target, cfg, uniform_tree(3, 2), algorithm="greedy",
                     max_length=128, prefill_chunk=16, device="cuda")
    grow = eng._grow

    def reads_back(state):
        out = grow(state)
        out[0].sum().item()
        return out

    eng._grow = reads_back
    try:
        eng.generate_fast(np.arange(5, 14), max_new_tokens=8)
    except RuntimeError as e:
        log(f"  a host read inside a capture raises: {str(e).splitlines()[0][:100]}")
    else:
        fail("a capture with a host read inside did not raise")
    eng._grow = grow


# ---------------------------------------------------------------------------
# Phase 5: full width through the testbed's entry points
# ---------------------------------------------------------------------------

def profile_kernels(torch, fn, label, top=8):
    """The device work of `fn` from a torch.profiler trace: (its kernel ms,
    its kernels' (start, end) µs in start order), with the `top` largest
    kernels and the top-p kernels (µs a launch on this path's own rows)
    printed unless `top` is 0; None when the trace holds no device time
    (then the share is not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    total_ms = sum(r[1] for r in rows) / 1e3
    if not rows or not spans:
        log(f"  {label}: the profiler trace holds no device time (busy share not measured)")
        return None
    log(f"  {label} trace: {total_ms:.3f} kernel ms in {sum(r[2] for r in rows)} kernels"
        + (("; top: " + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{n}" for k, t, n in rows[:top]))
           if top else ""))
    if top:
        top_p = [(k, t, n) for k, t, n in rows if "top_p_kernel" in k]
        log(f"  {label} trace, top-p: " + ("; ".join(
            f"{k[k.index('top_p_kernel'):][:28]} {t / 1e3:.4f} ms x{n} ({t / n:.2f} µs a launch)"
            for k, t, n in top_p) or "no launch"))
    return total_ms, spans


def busy_share(spans):
    """The share of the window from the first kernel's start to the last
    kernel's end in which some kernel runs (overlapping kernels once)."""
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (end - spans[0][0])


PATH_KERNELS = ("tree_attention", "top_p_threshold_from_logits", "top_p_threshold_fused")
CURVE_WIDTHS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
PLAN_WIDTHS = CURVE_WIDTHS[:8]   # the planner's budgets, as in the earlier slices


def load_models(torch, quant_bits=None, dtype="bf16"):
    """(target, target cfg, draft, draft cfg): llama-2-7b in bf16 or with
    int8 / packed-int4 weights (activations `dtype`, "bf16" or "f32"), and
    the bf16 68m draft, random from SEED."""
    from sequoia_torch.cli.testbed import build_params
    from sequoia_torch.utils import hard_sync

    t0 = time.perf_counter()
    target, tcfg = build_params(FULL["target"], "random", dtype, SEED, "cuda",
                                quant_bits=quant_bits)
    draft, dcfg = build_params(FULL["draft"], "random", "bf16", SEED + 1, "cuda")
    hard_sync("cuda")
    log(f"  random weights on the card ({dtype if quant_bits is None else f'int{quant_bits}'} "
        f"target, {dtype} activations): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return target, tcfg, draft, dcfg


def graph_lines(torch, engine, label):
    """Kernel nodes and capture seconds of each graph `engine` captured."""
    return ", ".join(
        f"{name} {graph_kernels(g.graph)} kernels, captured in {g.seconds:.2f} s"
        for name, g in engine._graphs.graphs.items())


def step_graph_ms(torch, ar, prompt, replays=16):
    """Device ms of one replay of the AR step graph: CUDA events around
    `replays` replays after a prefill of `prompt`, with a budget of
    `replays` tokens (a step after a stop token is a no-op of the same
    kernels)."""
    ar.prefill(prompt, seed=SEED)
    ar._produced.zero_()
    ar._budget.fill_(replays)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ar._graphs.replay("step", replays)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / replays


def prefill_ms(torch, engine, prompt, reps=5):
    """Wall ms of `engine.prefill(prompt)`, synced on both sides (median)."""
    from sequoia_torch.utils import hard_sync

    times = []
    for _ in range(reps):
        hard_sync("cuda")
        t0 = time.perf_counter()
        engine.prefill(prompt, seed=SEED)
        hard_sync("cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def block_start(parts, k):
    """Index (among the generated tokens) of the first token that is new
    and is emitted by the first iteration of a block of `k` after the first
    block; `parts` holds each iteration's tokens."""
    seen = [t for p in parts[:k] for t in p]
    for j in range(k, len(parts)):
        for t in parts[j]:
            if j % k == 0 and t not in seen:
                return len(seen)
            seen.append(t)
    fail("block costs: no new token starts a block")


def block_costs(torch, models, gm, prompt, ar_out, sq_out, ar, eng, label):
    """What the blocks of replays cost and save, on prompt 0 with its seed.

    The no-op tail: an AR baseline and a Sequoia engine whose stop tokens
    add a token that the seeded run emits first in the first iteration of
    a block (`block_start`), so the rest of that block replays as no-ops. Each
    request runs once with the full budget and once with a budget that ends
    at the stop token (the same tokens; the blocks shrink to it): the wall
    time between them over the no-op replays between them is the cost of
    one no-op (alternated, 2 runs each). Then the block cap swept on the
    engines without the stop token: wall ms/token and host reads at each
    cap; the difference between caps over the reads they save is the cost
    of one host read. Every run's tokens are checked against prompt 0's."""
    import dataclasses
    import itertools

    import numpy as np

    from sequoia_torch.engine import baseline as baseline_mod
    from sequoia_torch.engine import engine as engine_mod
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.utils import hard_sync

    target, tcfg, draft, dcfg = models
    M, gen, T, P, plen = FULL["max_length"], FULL["gen"], FULL["T"], FULL["P"], len(prompt)

    def wall(fn, budget, want):
        hard_sync("cuda")
        t0 = time.perf_counter()
        out = fn(prompt, max_new_tokens=budget, seed=SEED)
        hard_sync("cuda")
        dt = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(out, want):
            fail(f"{label}: block costs: a run's tokens differ from prompt 0's")
        return dt

    def replays(e, name):
        return e.graph_report()[name]["replays"]

    # The Sequoia iterations of prompt 0, eagerly (the replayed tokens).
    k_sq, k_ar = engine_mod.BLOCK_ITERATIONS, baseline_mod.BLOCK_STEPS
    iters = [list(t) for t in itertools.islice(eng.stream(prompt, gen, seed=SEED), 16)]
    gen_ar, gen_sq = list(ar_out[plen:]), list(sq_out[plen:])
    at = {"AR": block_start([[t] for t in gen_ar], k_ar), "sequoia": block_start(iters, k_sq)}
    for name, want_full, graph in (("AR", gen_ar, "step"), ("sequoia", gen_sq, "finalize")):
        i = at[name]
        cfg = dataclasses.replace(tcfg, stop_tokens=tuple(tcfg.stop_tokens) + (want_full[i],))
        if name == "AR":
            e = ARBaseline(target, cfg, max_length=M, temperature=T, top_p=P, device="cuda")
        else:
            e = SpecEngine(draft, dcfg, target, cfg, gm, algorithm="sequoia", max_length=M,
                           temperature=T, top_p=P, device="cuda")
        want = np.asarray(list(prompt) + want_full[:i + 1], dtype=np.int32)
        e.generate_fast(prompt, max_new_tokens=4, seed=SEED)   # capture
        times, noops = {"full": [], "exact": []}, {}
        for case in ("full", "exact", "exact", "full"):
            r0 = replays(e, graph)
            times[case].append(wall(e.generate_fast, gen if case == "full" else i + 1, want))
            live = len(want) - plen if name == "AR" else e.num_large_model_steps
            noops[case] = replays(e, graph) - r0 - live
        full, exact = (sum(times[c]) / 2 for c in ("full", "exact"))
        per = (full - exact) / max(noops["full"] - noops["exact"], 1)
        log(f"  stop-token tail, {name}: stop at generated token {i} (blocks of "
            f"{k_ar if name == 'AR' else k_sq} {'steps' if name == 'AR' else 'iterations'}"
            f"), wall {full:.3f} ms with {noops['full']} no-op replays, {exact:.3f} ms with "
            f"the budget ending at the stop ({noops['exact']} no-ops): {per:.3f} ms a no-op "
            f"(runs: {times})")
        del e
    torch.cuda.empty_cache()

    # The block cap swept, without the stop token.
    reads = []
    block = eng._block
    eng._block = lambda state, k: (reads.append(k), block(state, k))
    try:
        for name, base, caps, want in (("AR", ar, (16, 8, 4, 2, 1), ar_out),
                                       ("sequoia", eng, (8, 4, 2, 1), sq_out)):
            times, n_reads = {k: [] for k in caps}, {}
            for k in caps + caps[::-1]:
                if name == "AR":
                    baseline_mod.BLOCK_STEPS = k
                else:
                    engine_mod.BLOCK_ITERATIONS = k
                reads.clear()
                times[k].append(wall(base.generate_fast, gen, want))
                n_reads[k] = len(reads) if name == "sequoia" else -(-gen // k)
            baseline_mod.BLOCK_STEPS, engine_mod.BLOCK_ITERATIONS = k_ar, k_sq
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            per_read = (ms[1] - ms[caps[0]]) / (n_reads[1] - n_reads[caps[0]])
            log(f"  block cap swept, {name} (prompt 0, {len(want) - plen} tokens): " + ", ".join(
                f"k {k}: {ms[k] / (len(want) - plen):.4f} ms/token, {n_reads[k]} host reads"
                for k in caps) + f"; {per_read:.4f} ms a host read (k 1 against k {caps[0]}); "
                f"runs {times}")
    finally:
        baseline_mod.BLOCK_STEPS, engine_mod.BLOCK_ITERATIONS = k_ar, k_sq
        del eng._block


def full_width(torch, gm, models, label, need, *, kv_quant=None, run_ar=True, extras=False,
               dsplit_prompt=False, check_eager=False, stop_tail=False):
    """One full-width path on `models`: the stochastic AR baseline (unless
    `run_ar` is off) and Sequoia over the prompts through `generate_fast`
    (CUDA-graph replays; the testbed's timed entry point), with the kernels
    in `need` required to launch under replay. `extras` adds the eager
    `generate` over the same prompts and seeds (the eager-vs-graphed
    column; `check_eager` fails unless the tokens are equal), the phase
    graphs' replay times (`generate_benchmark`), the step graph's, the
    profiler traces of graphed runs and the busy share; `dsplit_prompt` one
    more Sequoia prompt with the int4 cache in its dsplit packing (a
    recapture); `stop_tail` (with `extras`) `block_costs`. Returns the main
    path's launches of the kernels in `need`."""
    import numpy as np

    from sequoia_torch.cli.testbed import load_prompts
    from sequoia_torch.core.model import forward
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks
    from sequoia_torch.quant.quantize import model_bytes
    from sequoia_torch.utils import hard_sync

    target, tcfg, draft, dcfg = models
    prompts = load_prompts(FULL["prompts"], tcfg.vocab_size, SEED)
    M, gen, T, P = FULL["max_length"], FULL["gen"], FULL["T"], FULL["P"]
    ar = ARBaseline(target, tcfg, max_length=M, temperature=T, top_p=P, kv_quant=kv_quant,
                    device="cuda")
    eng = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia", max_length=M,
                     temperature=T, top_p=P, kv_quant=kv_quant, device="cuda")

    # Finite logits at the first steps of both entry points.
    st = ar.prefill(prompts[0], seed=SEED)
    ar.step(st)
    ds = eng.prefill(prompts[0], seed=SEED)
    ts = len(prompts[0]) - 1   # a verify forward over the whole tree
    main, scr = masks.split_tree_masks(torch.as_tensor(gm.ancestors, device="cuda"), ts, M,
                                       root_in_main=False)
    verify_logits, _ = forward(
        target, tcfg, torch.as_tensor(prompts[0][-gm.size:], device="cuda"),
        ts + torch.as_tensor(gm.depth, device="cuda"), ds.target_kv, ts, main,
        scratch=KVCache.init(tcfg, gm.size, torch.bfloat16, "cuda"), scratch_offset=0,
        scratch_mask=scr)
    eng.iterate(ds)
    for name, x in (("AR last_logits", st.last_logits), ("verify logits", verify_logits),
                    ("draft root logits", ds.root_draft_logits)):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: non-finite {name}")
    del st, ds
    # Warm up and capture (a failed capture raises: nothing falls back).
    if run_ar:
        ar.generate_fast(prompts[0], max_new_tokens=4)
    eng.generate_fast(prompts[0], max_new_tokens=4)
    log(f"  graphs: sequoia {graph_lines(torch, eng, label)}"
        + (f"; AR {graph_lines(torch, ar, label)}" if run_ar else ""))

    def timed(fn, p, seed):
        hard_sync("cuda")
        t0 = time.perf_counter()
        out = fn(p, max_new_tokens=gen, seed=seed)
        hard_sync("cuda")
        dt = time.perf_counter() - t0
        if len(out) <= len(p) or out.min() < 0 or out.max() >= tcfg.vocab_size:
            fail(f"{label}: {fn.__qualname__} produced no or out-of-range tokens")
        return out, dt

    build.reset_launches()                               # the main path starts here
    ar_out, ar_dts, ar_tokens, t_ar = [], [], 0, 0.0
    for i, p in enumerate(prompts if run_ar else []):
        out, dt = timed(ar.generate_fast, p, SEED + i)
        ar_out.append(out)
        ar_dts.append(dt)
        t_ar += dt
        ar_tokens += len(out) - len(p)
    ar_launches = dict(build.launches)
    sq_out, sq_dts, sq_steps_0, sq_tokens, sq_steps, t_sq = [], [], None, 0, 0, 0.0
    for i, p in enumerate(prompts):
        out, dt = timed(eng.generate_fast, p, SEED + i)
        sq_out.append(out)
        sq_dts.append(dt)
        t_sq += dt
        sq_tokens += eng.num_decoding_steps
        sq_steps += eng.num_large_model_steps
        if i == 0:
            sq_steps_0 = eng.num_large_model_steps
    sq_launches = {k: v - ar_launches[k] for k, v in build.launches.items()}
    if dsplit_prompt:
        eng._kv4_packing = "dsplit"   # the engine itself picks "head" for an even Hkv
        eng.generate_fast(prompts[0], max_new_tokens=4)  # recapture on the new cache
        _, dt = timed(eng.generate_fast, prompts[0], SEED)
        log(f"  sequoia, int4 cache in the dsplit packing (recaptured: "
            f"{graph_lines(torch, eng, label)}), prompt 0 again: "
            f"{dt / eng.num_decoding_steps * 1e3:.3f} ms/token, "
            f"{eng.num_decoding_steps / eng.num_large_model_steps:.3f} tokens per target step, "
            f"{build.launches['tree_attention_kv4_dsplit']} launches of its kernel")
        eng._kv4_packing = "head"
    launches = dict(build.launches)                      # ... and ends here

    # One forward reads every weight once, but only Q rows of the embedding.
    weight_bytes = model_bytes(target) - target.embed.numel() * target.embed.element_size()
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    sq_ms = t_sq / sq_tokens * 1e3
    if run_ar:
        ar_ms = t_ar / ar_tokens * 1e3
        log(f"  AR generate_fast (stochastic, T={T} P={P}): {ar_tokens} tokens, "
            f"{ar_ms:.3f} ms/token (weight stream bound {bound_ms:.3f} ms/forward, "
            f"{weight_bytes / 1e9:.3f} GB)")
    log(f"  sequoia generate_fast: {sq_tokens} tokens in {sq_steps} iterations, "
        f"{sq_ms:.3f} ms/token, iteration {t_sq / sq_steps * 1e3:.3f} ms, accepted tokens "
        f"per target step {sq_tokens / sq_steps:.3f}"
        + (f", speedup vs AR {ar_ms / sq_ms:.3f}x" if run_ar else ""))
    shown = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    log(f"  launches (replays counted): AR {shown(ar_launches)}; sequoia {shown(sq_launches)} "
        f"(per iteration: " + ", ".join(f"{k} {v / sq_steps:.1f}" for k, v in
                                        shown(sq_launches).items()) + ")")
    for k in need:
        if launches[k] == 0:
            fail(f"{label}: {k} never launched on this path: {shown(launches)}")
        # A kernel this path adds runs under both entry points (the dsplit
        # packing only in its one Sequoia prompt).
        both = run_ar and k not in PATH_KERNELS and k != "tree_attention_kv4_dsplit"
        if both and (ar_launches[k] == 0 or sq_launches[k] == 0):
            fail(f"{label}: {k} did not launch on both entry points: AR {ar_launches[k]}, "
                 f"sequoia {sq_launches[k]}")

    if extras:
        # The eager loops over the same prompts and seeds: the time the
        # graphs save, and the same tokens.
        e_ar = e_sq = 0.0
        same = []
        for i, p in enumerate(prompts):
            out, dt = timed(ar.generate, p, SEED + i)
            e_ar += dt
            same.append(np.array_equal(out, ar_out[i]))
            out, dt = timed(eng.generate, p, SEED + i)
            e_sq += dt
            same.append(np.array_equal(out, sq_out[i]))
        log(f"  eager generate, the same prompts and seeds: AR {e_ar / ar_tokens * 1e3:.3f} "
            f"ms/token, sequoia {e_sq / sq_tokens * 1e3:.3f} ms/token; graphed / eager: AR "
            f"{t_ar / e_ar:.3f}, sequoia {t_sq / e_sq:.3f}; tokens equal to the replayed "
            f"runs: {all(same)} ({same})")
        if check_eager and not all(same):
            fail(f"{label}: replayed tokens differ from eager ones (seeded, AR and sequoia "
                 f"per prompt: {same})")
        phases, b_steps = {}, 0
        for i, p in enumerate(prompts):
            _, tot = eng.generate_benchmark(p, max_new_tokens=gen, seed=SEED + i)
            b_steps += eng.num_large_model_steps
            for k, v in tot.items():
                phases[k] = phases.get(k, 0.0) + v
        iter_dev = sum(phases.values()) / b_steps * 1e3
        step_ms = step_graph_ms(torch, ar, prompts[0])
        log("  graph replay device ms (CUDA events between replays): " + ", ".join(
            f"{k} {v / b_steps * 1e3:.3f}" for k, v in phases.items())
            + f" (iteration {iter_dev:.3f}); AR step {step_ms:.3f}")
        # Device busy share of the graphed runs: the kernel ms of a
        # torch.profiler trace of prompt 0's run (its prompt, seed and
        # budget) over the wall ms of its timed run; then of the decode loop
        # alone, without the prefill's kernel ms (a trace of its own) and
        # wall ms (`prefill_ms`). Beside them the share of the traced run's
        # own device window in which a kernel runs (the profiler slows that
        # run), and the share the replay events give.
        traces = [profile_kernels(torch, lambda: e.generate_fast(prompts[0], gen, seed=SEED),
                                  f"{name} graphed") for name, e in (("AR", ar), ("sequoia", eng))]
        prefills = [profile_kernels(torch, lambda: e.prefill(prompts[0], seed=SEED),
                                    f"{name} prefill", top=0)
                    for name, e in (("AR", ar), ("sequoia", eng))]
        pre_wall = [prefill_ms(torch, e, prompts[0]) for e in (ar, eng)]
        walls = [ar_dts[0] * 1e3, sq_dts[0] * 1e3]
        loops = [w - p for w, p in zip(walls, pre_wall)]
        n_ar0 = len(ar_out[0]) - len(prompts[0])
        wall_tok, wall_it = t_ar / ar_tokens * 1e3, t_sq / sq_steps * 1e3
        log(f"  prefill of prompt 0 ({len(prompts[0])} tokens), wall ms (median of 5): AR "
            f"{pre_wall[0]:.3f}, sequoia {pre_wall[1]:.3f}; the decode loop without it: AR "
            f"{loops[0] / n_ar0:.3f} ms/token ({loops[0] / n_ar0 - step_ms:.3f} ms a step past "
            f"the step graph's replay), sequoia iteration {loops[1] / sq_steps_0:.3f} ms "
            f"({loops[1] / sq_steps_0 - iter_dev:.3f} ms past the phase graphs' replays)")
        if None not in traces + prefills:
            share = [t[0] / w for t, w in zip(traces, walls)]
            loop_share = [(t[0] - p[0]) / w for t, p, w in zip(traces, prefills, loops)]
            window = [busy_share(t[1]) for t in traces]
            log(f"  device busy share, graphed (trace, prompt 0): AR {share[0]:.3f}, sequoia "
                f"{share[1]:.3f} (kernel ms over the timed run's wall ms); the decode loop "
                f"alone: AR {loop_share[0]:.3f}, sequoia {loop_share[1]:.3f}; the prefill "
                f"alone: AR {prefills[0][0] / pre_wall[0]:.3f}, sequoia "
                f"{prefills[1][0] / pre_wall[1]:.3f}; within the profiled run's device window:"
                f" AR {window[0]:.3f}, sequoia {window[1]:.3f}")
        log(f"  device busy share, graphed (replay events): AR {step_ms / wall_tok:.3f}, "
            f"sequoia {iter_dev / wall_it:.3f} (replay ms per token / iteration over wall ms)")
        if stop_tail:
            block_costs(torch, models, gm, prompts[0], ar_out[0], sq_out[0], ar, eng, label)
    return {k: launches[k] for k in need}


def width_curve(torch, models, label, *, kv_quant=None, need=(), host=False,
                widths=CURVE_WIDTHS):
    """Phase 7, one curve: device time of the target's split-mode forward
    at `widths` through `planner/profile.py` (CUDA-graph replays; caches in
    the target's activation type), with the kernels in `need` required to
    launch. Returns (curve in seconds, launches of `need`)."""
    from sequoia_torch.kernels import build
    from sequoia_torch.planner.profile import time_forward_widths

    target, tcfg = models[:2]
    t0 = time.perf_counter()
    build.reset_launches()
    curve = time_forward_widths(target, tcfg, widths, max_length=FULL["max_length"],
                                kv_len=128, reps=10, kv_quant=kv_quant,
                                dtype=target.embed.dtype)
    launches = {k: build.launches[k] for k in need}
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the {label} curve never launched: {launches}")
    log(f"  [7] {label} target forward, CUDA graph replays: " + ", ".join(
        f"w{w} {t * 1e3:.3f} ms" for w, t in zip(widths, curve))
        + f" ({time.perf_counter() - t0:.1f} s)")
    if host:
        log(f"  [7] {label} target forward, eager, host ms to issue it: " + ", ".join(
            f"w{w} {forward_host_ms(torch, target, tcfg, w, FULL['max_length']):.3f}"
            for w in (1, 64)))
    return curve, launches


def forward_host_ms(torch, params, cfg, width, M, kv_len=128):
    """Host time (ms) to issue one eager split-mode forward at `width`, the
    inputs of `time_forward_widths`: the median of 5 after a warm-up, the
    device drained before each (the forward itself never synchronizes)."""
    from sequoia_torch.core.model import forward
    from sequoia_torch.kvcache.cache import KVCache

    kv = KVCache.init(cfg, M, torch.bfloat16, "cuda")
    scratch = KVCache.init(cfg, width, torch.bfloat16, "cuda")
    tokens = torch.zeros(width, dtype=torch.long, device="cuda")
    pos = kv_len + torch.arange(width, device="cuda")
    mask = (torch.arange(M, device="cuda") < kv_len)[None, :].expand(width, M).contiguous()
    scr = torch.tril(torch.ones(width, width, dtype=torch.bool, device="cuda"))
    samples = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(params, cfg, tokens, pos, kv, kv_len, mask, scratch=scratch, scratch_offset=0,
                scratch_mask=scr)
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples[1:])


def plan_from_curves(curves, draft_time):
    """What the planner DP picks from each measured curve with the bundled
    68m->7b acceptance vector (the testbed's max_depth 8)."""
    from sequoia_torch.planner.dp import plan
    from sequoia_torch.planner.profile import default_acceptance_vector

    n = len(PLAN_WIDTHS)
    for label, curve in curves.items():
        log(f"  {label}: " + ", ".join(f"{w}:{t * 1e3:.3f}" for w, t in zip(CURVE_WIDTHS, curve))
            + " ms")
        gm, info = plan(default_acceptance_vector(), PLAN_WIDTHS, curve[:n], draft_time,
                        max_depth=8)
        log(f"    plan: size {gm.size}, depth {info['depth']}, expected accepted "
            f"{info['expected_accepted']:.3f}, predicted {info['dec_time'] * 1e3:.3f} ms/token "
            f"(device time; draft w8 {draft_time * 1e3:.4f} ms)")


def llama3_vocab(torch, gm):
    """The Llama-3 vocabulary through both entry points, to show that both
    top-p kernels run their cluster route on a real path: llama-3.2-1b's
    widths (V = 128256) cut to 2 layers for the target and 1 for the draft,
    random bf16 weights (seeded), the planned growmap, stochastic AR and
    Sequoia (T=0.6, P=0.9) through `generate_fast` (graph replays) over 2
    synthetic 64-token prompts, 32 new tokens each. Returns the launches of
    this path."""
    import dataclasses

    import numpy as np

    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.utils import hard_sync

    base = get_config("llama-3.2-1b")
    tcfg, dcfg = dataclasses.replace(base, num_layers=2), dataclasses.replace(base, num_layers=1)
    target = random_params(tcfg, SEED + 5, dtype=torch.bfloat16, device="cuda")
    draft = random_params(dcfg, SEED + 6, dtype=torch.bfloat16, device="cuda")
    T, P, M = FULL["T"], FULL["P"], FULL["max_length"]
    prompts = [np.random.default_rng(SEED + i).integers(3, tcfg.vocab_size, 64) for i in (0, 1)]
    ar = ARBaseline(target, tcfg, max_length=M, temperature=T, top_p=P, device="cuda")
    eng = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia", max_length=M,
                     temperature=T, top_p=P, device="cuda")
    ar.generate_fast(prompts[0], max_new_tokens=4)       # warm up and capture
    eng.generate_fast(prompts[0], max_new_tokens=4)
    hard_sync("cuda")
    build.reset_launches()                               # the path starts here
    t0 = time.perf_counter()
    n_ar = n_sq = steps = 0
    t_ar = t_sq = 0.0
    for i, p in enumerate(prompts):
        t1 = time.perf_counter()
        out = ar.generate_fast(p, max_new_tokens=32, seed=SEED + i)
        t_ar += time.perf_counter() - t1
        n_ar += len(out) - len(p)
        if len(out) <= len(p) or out.min() < 0 or out.max() >= tcfg.vocab_size:
            fail(f"Llama-3 vocabulary: AR produced invalid tokens {out[len(p):]}")
        t1 = time.perf_counter()
        out = eng.generate_fast(p, max_new_tokens=32, seed=SEED + i)
        t_sq += time.perf_counter() - t1
        n_sq += eng.num_decoding_steps
        steps += eng.num_large_model_steps
        if len(out) <= len(p) or out.min() < 0 or out.max() >= tcfg.vocab_size:
            fail(f"Llama-3 vocabulary: Sequoia produced invalid tokens {out[len(p):]}")
    hard_sync("cuda")
    launches = dict(build.launches)                      # ... and ends here
    shown = {k: v for k, v in launches.items() if v}
    log(f"  {n_ar} AR and {n_sq} Sequoia tokens ({steps} target steps) in "
        f"{time.perf_counter() - t0:.1f} s, generate_fast: AR {t_ar / n_ar * 1e3:.3f} ms/token, "
        f"sequoia {t_sq / n_sq * 1e3:.3f} ms/token, iteration {t_sq / steps * 1e3:.3f} ms; "
        f"graphs: sequoia {graph_lines(torch, eng, 'llama-3')}; launches {shown}")
    for k in ("top_p_threshold_from_logits_cluster", "top_p_threshold_fused_cluster"):
        if launches[k] == 0:
            fail(f"Llama-3 vocabulary: {k} never launched: {shown}")
    for k in ("top_p_threshold_from_logits", "top_p_threshold_fused"):
        if launches[k]:
            fail(f"Llama-3 vocabulary: the one-block route {k} ran at V = 128256")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in full f32
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    try:
        from sequoia_torch.kernels import build
        from sequoia_torch.cli.testbed import load_growmap
    except ImportError as e:
        fail(f"sequoia_torch is not importable next to chip_smoke.py: {e}")
    t_start = time.perf_counter()

    log("[1] device")
    card = card_line()
    log(f"  {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("[2] build")
    try:
        build.load(verbose=True)
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    took = build.build_seconds
    log(f"  built in {took:.1f} s" if took is not None else "  library was cached")
    kernel = "?"
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line and "0 bytes spill" not in line:
            log(f"  ptxas: {kernel}: " + line.split(":", 1)[-1].strip())
        elif "C75" in line:   # e.g. C7513, wgmma serialized
            log(f"  ptxas: {line.strip()}")

    gm = load_growmap("planned")
    log(f"  planned growmap: {gm.size} nodes, depth {int(gm.depth.max())}, "
        f"max branch {gm.max_branch}, level widths {gm.level_widths}")

    kernels = []
    if "--loops" in sys.argv[1:]:
        log("[4] small parity on the card")
        small_parity(torch)
        log("[5] full width: llama-68m -> llama-2-7b bf16")
        full_width(torch, gm, load_models(torch), "bf16", PATH_KERNELS, extras=True,
                   check_eager=True, stop_tail=True)
        log(f"  --loops: phase 4 and the bf16 path only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return

    log("[3] kernels vs plain versions")
    if "--qmm" not in sys.argv[1:]:
        check_tree_attention(torch, gm, kernels)
    if "--attention" in sys.argv[1:]:
        log(f"  --attention: tree attention only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return
    check_top_p(torch, gm, kernels)
    check_quant_matmul(torch, kernels)
    if "--qmm" in sys.argv[1:]:
        log(f"  --qmm: top-p and the quant matmuls only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return

    launches, curves = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    log("[4] small parity on the card")
    build.reset_launches()
    small_parity(torch)
    add(build.launches)   # f32 x: the f32-x matmuls and f32 attention run here and in phase 7

    from sequoia_torch.core import model as model_mod
    from sequoia_torch.kernels.quant_matmul import quant_matmul
    from sequoia_torch.planner.profile import time_forward_widths
    from sequoia_torch.quant import qtensor

    log("[5] full width: llama-68m -> llama-2-7b bf16")
    models = load_models(torch)
    add(full_width(torch, gm, models, "bf16", PATH_KERNELS, extras=True, check_eager=True,
                   stop_tail=True))
    curves["bf16"], _ = width_curve(torch, models, "bf16", need=("tree_attention",), host=True)
    draft_time = time_forward_widths(models[2], models[3], [8], max_length=FULL["max_length"],
                                     kv_len=128, reps=20)[0]
    log(f"  [7] 68m draft forward at width 8: {draft_time * 1e3:.4f} ms")
    for kv_quant, counter in (("int8", "tree_attention_kv8"),
                              ("int4", "tree_attention_kv4_head")):
        log(f"[5] full width: bf16 weights, kv_quant {kv_quant}")
        need = PATH_KERNELS + (counter,)
        if kv_quant == "int4":
            need += ("tree_attention_kv4_dsplit",)
        add(full_width(torch, gm, models, f"bf16, {kv_quant} KV", need, kv_quant=kv_quant,
                       dsplit_prompt=kv_quant == "int4"))
        curves[f"bf16, {kv_quant} KV"], _ = width_curve(
            torch, models, f"bf16, {kv_quant} KV", kv_quant=kv_quant, need=(counter,))
    del models
    torch.cuda.empty_cache()

    log("[5] stochastic AR and Sequoia at the Llama-3 vocabulary (V = 128256)")
    add(llama3_vocab(torch, gm))
    torch.cuda.empty_cache()

    log("[6] full width: int8 weights, weight-only (w8a8 off)")
    models = load_models(torch, quant_bits=8)
    qtensor.set_w8a8("off")
    add(full_width(torch, gm, models, "int8", PATH_KERNELS + ("quant_matmul_int8_wgmma",),
                   extras=True))
    curves["int8"], _ = width_curve(torch, models, "int8", need=("quant_matmul_int8_wgmma",),
                                    host=True)
    log("[6] full width: int8 weights, w8a8 on (int8 activations, every row count)")
    qtensor.set_w8a8("on")
    need = ("tree_attention", "top_p_threshold_from_logits", "quant_matmul_w8a8_wgmma",
            "quantize_activations")   # Sequoia only: the fused cutoff is the AR step's
    add(full_width(torch, gm, models, "int8 w8a8", need, run_ar=False))
    curves["int8 w8a8"], _ = width_curve(torch, models, "int8 w8a8", need=need[-2:], host=True)
    qtensor.set_w8a8("auto")
    del models
    torch.cuda.empty_cache()

    log("[7] int8 weights with f32 activations (the f32-x route at 7B width)")
    models = load_models(torch, quant_bits=8, dtype="f32")
    need = ("quant_matmul_int8", "split_bf16x3", "tree_attention_f32")
    _, counts = width_curve(torch, models, "int8, f32 x", need=need, widths=(1, 16, 64))
    log(f"  [7] int8, f32 x curve launches: {counts}")
    add(counts)
    del models
    torch.cuda.empty_cache()

    log("[6] full width: int4 weights (weight-only)")
    models = load_models(torch, quant_bits=4)
    add(full_width(torch, gm, models, "int4", PATH_KERNELS + ("quant_matmul_int4_wgmma",),
                   extras=True))
    curves["int4"], _ = width_curve(torch, models, "int4", need=("quant_matmul_int4_wgmma",),
                                    host=True)
    log("[6] int4 weights, every projection through unpack=\"w4a8\" (the profiler's "
        "entry point; qtensor.matmul has no route to it)")

    def routed(x, w, *, out_dtype=None):
        if isinstance(w, qtensor.QuantizedTensor):
            return quant_matmul(x, w.q, w.scale, bits=4, unpack="w4a8", out_dtype=out_dtype)
        return qtensor.matmul(x, w, out_dtype=out_dtype)

    model_mod.matmul = routed
    try:
        need = ("quant_matmul_w4a8", "quantize_activations")
        curves["int4 w4a8"], counts = width_curve(torch, models, "int4 w4a8", need=need)
    finally:
        model_mod.matmul = qtensor.matmul
    add(counts)
    log("[6] full width: panel-tiled int4 weights (tile_int4 over the projections and the head)")
    models = (tile_model(models[0]),) + models[1:]
    torch.cuda.empty_cache()
    add(full_width(torch, gm, models, "tiled int4",
                   PATH_KERNELS + ("quant_matmul_tiled_wgmma",)))
    curves["tiled int4"], _ = width_curve(torch, models, "tiled int4",
                                          need=("quant_matmul_tiled_wgmma",))
    del models
    torch.cuda.empty_cache()

    for e in kernels:
        e["launches"] = launches.get(e["name"], 0)
        if e["launches"] == 0:
            fail(f"{e['name']} never launched on any main path")

    log("[7] latency curves (H100, device time of one split-mode forward at kv_len 128)")
    plan_from_curves(curves, draft_time)

    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
