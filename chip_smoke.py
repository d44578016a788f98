#!/usr/bin/env python3
"""Chip smoke test of sequoia_torch on one CUDA card (an H100).

    python3 chip_smoke.py               # every phase (the contract run)
    python3 chip_smoke.py --attention   # phases 1, 2, phase 3's and phase 9's tree attention
    python3 chip_smoke.py --qmm         # phases 1, 2 and phase 3's top-p and matmuls
    python3 chip_smoke.py --loops       # phases 1, 2, 4 and phase 5's bf16 path
    python3 chip_smoke.py --plan        # phases 1, 2 and 8 (its own short bf16 curve)
    python3 chip_smoke.py --batched     # phases 1, 2 and 9
    python3 chip_smoke.py --offload     # phases 1, 2 and 10
    python3 chip_smoke.py --tp          # phases 1, 2 and 11
    python3 chip_smoke.py --tools       # phases 1, 2 and 12 (its own short bf16 curve)

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
     also the eager `generate` on prompt 0 and its seed (bf16: the
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
     target is freed;
  8. measure -> plan -> serve (bf16): an HF checkpoint of the draft, both
     acceptance methods, the plan on the native DP table, the four walks;
  9. batched serving (`engine/batched.py`): test-small on the card at
     enough slots that its 32-row prefill chunks fill the card and take the
     Hopper kernel (f32 greedy `serve_fast` equal to its CPU run; every
     cache format, f32 and bf16, replayed equal to eager `serve`, bf16 up to
     a near-tie token); then llama-68m -> llama-2-7b
     bf16 at B = 8 slots over a queue of 16 synthetic requests of 32-256
     tokens (64 new tokens each, max_length 512, prefill_chunk 64): Sequoia
     through `serve_fast` and `serve_device` (admit_width 4) and batched AR
     through `serve_fast`, with the bf16 and the int8 KV cache (each
     engine's graphs captured by an untimed warm-up run first), then
     `serve_auto` on the measured costs (it must pick the device loop),
     each with tokens/s, iterations and admission steps, the graphs'
     replay device ms and the prefill's wall ms; greedy
     `serve_device` equal to `serve_fast`, replayed equal to eager
     `generate_batch`, each slot of `generate_batch_fast` equal to the
     single-request `generate_fast`; last, the batched tree-attention
     kernels at B = 8 against their plain version, every format and dtype:
     the route `sm90_route` picks (the Hopper kernel where Q > 16 and the
     work items fill the card) at the verify, timed beside the other route
     on the same inputs, B single launches and SDPA with a [B, ...] mask,
     then at the verify of one slot, the prefill chunk and distill's
     forward; the slot-grid route at the batched AR step;
 10. host offload (`engine/offload.py`): the host link's rate for one
     llama-2-7b and one llama-2-70b layer, a copy alone and a run of 8
     back to back (the link bound's rate); llama-2-7b bf16 (seeded random
     weights) offloaded with 0 and 16 layers kept on the card, the rest
     streamed from pinned memory: the forward at widths 1 and 64 equal to
     the resident forward bit for bit (logits and scratch K/V), eager,
     eager with the staging buffers poisoned, replayed and replayed
     poisoned, with no synchronizing call in the eager forward, its graph's
     nodes (kernels and copies) beside the resident graph's, and its replay
     device ms against the link bound; stochastic Sequoia and AR
     (`generate_fast`, 2 prompts x 32 tokens) equal to the resident
     engines' tokens, with ms/token; the offloaded curve at widths 1..1024
     and the tree the planner picks from it; int8 weight-only 7B at stay 0
     equal to its resident forward (kernel 4 on two alternating staging
     addresses); llama-2-70b at full width cut to 8 layers, all streamed
     (built in pinned memory): device ms at widths 1, 64 and 512 and a
     layer, beside the same 8 layers resident, and the reckoned 80-layer
     forward with 36 layers resident;
 11. tensor parallelism (`parallel/`): first each kernel at (b)'s shard
     shapes against its plain version (tree attention at 16 heads in
     every cache format, the quant matmuls at every 7B shard shape, w4a8
     and the quantizer with whole-row maxima); (a) an NCCL group of one
     rank in this process and a (1, 1) mesh: the bf16 7B path through
     `SpecEngine(mesh=...)` and `generate_fast`, the collectives captured
     into the decode graphs, greedy and stochastic tokens equal to the
     mesh-less engine's, each graph's kernel and NCCL nodes, Sequoia
     ms/token, replay ms and prefill ms with and without the mesh; (b) two
     processes on the one card over gloo at tp = 2 (NCCL takes one rank a
     card), llama-2-7b width cut to 4 layers: the verify forward (Q = 64
     over a 128-token prefix) with bf16, int8 and tiled int4 weights
     against the unsharded forward within 2e-2 of its largest |logit|
     (w4a8 logged beside the route's own distance from int4 weight-only),
     one row-parallel w4a8 layer with whole-row maxima within 1e-5 of the
     unsharded layer, and a 32-token greedy generate equal to the
     unsharded one up to the first top-2 logit gap under that amount; a
     failed rank fails the run;
 12. the tools (`tools/distill.py`, `tools/perplexity.py`): (a) one f32
     batch (B = 8, T = 64) of an 8L-256h target, every leaf's gradient
     through the batched f32 tree-attention kernel under autograd
     (`TreeAttentionFunction`) against the plain attention's on the card,
     within 1e-4 of its largest |grad|, the kernel launched; a
     grad-requiring input to a quant matmul, the quantizer or top-p
     raises; (b) `make_correlated_pair` (bench.py's trained pair: target
     8L-256h for 300 steps, a 2L-128h draft distilled for 600, vocab 512,
     on the bundled c4_small rows), ms a step, losses falling, params
     returned without grad; (c) 20 `train_lm` steps at llama-68m's width
     (V 32000); (d) the pair's dynamic acceptance (width 8, 40 steps x 6
     prompts of 24 tokens, T 0.6; rank 1 accepted > 0.15), the plan on the
     bf16 7B curve, Sequoia served through `generate_fast` at more than
     1.15 tokens a target step, planned E beside it; (e) `evaluate` on the
     card equal to the CPU's for the trained target in f32, int8 and int4
     weights with the float, int8 and int4 KV cache, then llama-2-7b
     (random, seeded) in bf16, int8 (w8a8 "auto": int8 activations at
     the chunk's 128 rows; and weight-only) and int4 weights and bf16 with
     int8 / int4 KV on 4 c4_small rows at seq_len 256, chunk 128: finite
     NLLs, int8 within 5% of bf16, ms per chunk forward. Its launches ((b)-(e))
     count.

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


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's heading ("[N] ...") with the seconds since
    the script started, so the phases' times can be read off the log."""
    if re.match(r"\[\d+\]", msg):
        msg += f"  (t = {time.perf_counter() - T0:.1f} s)"
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


def graph_nodes(graph) -> dict:
    """Node counts of a captured CUDA graph (made with keep_graph=True) by
    kind, kernel, memcpy or other, counted with libcuda's cuGraphGetNodes."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    kind, counts = ctypes.c_int(), {"kernel": 0, "memcpy": 0, "other": 0}
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        # CU_GRAPH_NODE_TYPE_KERNEL, CU_GRAPH_NODE_TYPE_MEMCPY
        counts[{0: "kernel", 1: "memcpy"}.get(kind.value, "other")] += 1
    return counts


def graph_kernels(graph) -> int:
    """Kernel nodes of a captured CUDA graph (made with keep_graph=True)."""
    return graph_nodes(graph)["kernel"]


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
    """The larger of `attention_times`' two times, and which it is."""
    t_bytes, t_ops = attention_times(q, main, scr, D, H, Hkv, itemsize, kv_item)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_times(q, main, scr, D, H, Hkv, itemsize, kv_item=None):
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
    return t_bytes, ops * 1e3


def check_tree_attention(torch, gm, results, cases=None, note=""):
    """The float-cache kernel at every attention shape of the main path, and
    each quantized cache format at the verify, AR-step and prefill shapes
    (and the f32 verify). The f32 route also at phase 7's shapes (Q = 1, 16,
    64 queries over a 128-key prefix of M = 256 and a causal scratch of Q
    rows), where its error and SDPA f32's against an f64 version of the
    plain version are printed (the kernel's held to 1e-4 of the largest
    |output|). The library yardstick is SDPA on the float cache (for a
    quantized one: on its dequantized rows) under the same mask. `cases`
    (name, `attention_case` arguments, tolerance) replace the main path's
    shapes, e.g. a tensor-parallel shard's heads; `note` goes into each
    entry's shape."""
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
    cases = cases or [
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
    f32_rows = () if note else (1, 16, 64)
    for Q in f32_rows:   # phase 7's f32 curve: kv_len 128, a causal scratch of Q rows
        cases.append((f"f32_q{Q}", dict(
            Q_rows=Q, layers=4, H=32, Hkv=32, D=128, M=256, S=Q, ts=128, dtype=torch.float32,
            scratch_rows=torch.tril(torch.ones(Q, Q, dtype=torch.bool, device="cuda"))), 1e-4))
    for lvl, (w, m) in enumerate(draft_scr if not note else ()):
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
                    shape=f"{note}verify Q={q.shape[0]} H={H} D={D} M={main.shape[1]} "
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
            n = max(2, -(-100_000_000 // wbytes))   # twice the 50 MB L2
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
    `generate` over prompt 0 with its seed (the eager-vs-graphed
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
        # The eager loops over prompt 0 with its seed: the time the graphs
        # save, and the same tokens.
        p = prompts[0]
        ar_e, e_ar = timed(ar.generate, p, SEED)
        sq_e, e_sq = timed(eng.generate, p, SEED)
        same = [np.array_equal(ar_e, ar_out[0]), np.array_equal(sq_e, sq_out[0])]
        n_ar, n_sq = len(ar_out[0]) - len(p), len(sq_out[0]) - len(p)
        log(f"  eager generate, prompt 0 and its seed: AR {e_ar / n_ar * 1e3:.3f} ms/token, "
            f"sequoia {e_sq / n_sq * 1e3:.3f} ms/token; graphed / eager: AR "
            f"{ar_dts[0] / e_ar:.3f}, sequoia {sq_dts[0] / e_sq:.3f}; tokens equal to the "
            f"replayed runs: {all(same)} ({same})")
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


C4_SMALL = os.path.join(ROOT, "sequoia_tpu", "data", "bundled", "c4_small.json")
PHASE8_CURVE_WIDTHS = [1, 4, 16, 64, 128]   # --plan: its own short bf16 curve


def measure_plan_serve(torch, curve=None, draft_time=None):
    """Phase 8: the measure -> plan -> serve loop on llama-68m -> llama-2-7b,
    bf16, random seeded weights, through the entry points a user calls.

    1. Checkpoint: the full-width 68m draft exported as `pytorch_model.bin`
       (HF naming), loaded back on the card bit for bit, then built through
       the testbed's `--draft-weights DIR` path (`build_params`).
    2. Acceptance: `cli/accept.py`, static and dynamic (W = 8, dynamic at
       most 16 steps a prompt), on 2 rows of the bundled c4_small.json,
       with the draft from that directory; rates in [0, 1], the dynamic
       vector summing to at most 1.
    3. Plan: `cli/tree_search.py` on the dynamic vector and the bf16 curve
       (`curve`, seconds at PLAN_WIDTHS, and `draft_time`; None: measure a
       short one at PHASE8_CURVE_WIDTHS), on the native DP table, whose
       plan must equal numpy's.
    4. Serve: Sequoia on the planned tree through `generate_fast` under
       each walk, 2 synthetic 128-token prompts at the same seeds: every
       walk's tokens equal the node walk's; one eager iteration of each
       walk under `set_sync_debug_mode("error")`; each walk's finalize
       replay ms from `iterate_phased` (`generate_benchmark`). The staged
       walk must launch the fused top-p kernel, the path and unrolled walks
       the from-logits one.
    Returns the launches of the serving runs (graph replays counted)."""
    import tempfile

    import numpy as np

    from sequoia_torch.cli import accept, tree_search
    from sequoia_torch.cli.testbed import build_params, load_prompts
    from sequoia_torch.core.init import export_hf_checkpoint, load_hf_checkpoint
    from sequoia_torch.data.datasets import load_pretokenized_jsonl
    from sequoia_torch.engine.engine import WALKS, SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.native import planner_dp_lib
    from sequoia_torch.planner.dp import plan
    from sequoia_torch.planner.profile import time_forward_widths
    from sequoia_torch.quant.quantize import tensors
    from sequoia_torch.trees.growmap import GrowMap
    from sequoia_torch.utils import hard_sync

    t_phase = time.perf_counter()
    M, gen, T, P = FULL["max_length"], FULL["gen"], FULL["T"], FULL["P"]
    target, tcfg = build_params(FULL["target"], "random", "bf16", SEED, "cuda")
    widths = PLAN_WIDTHS
    if curve is None:
        widths = PHASE8_CURVE_WIDTHS
        t0 = time.perf_counter()
        curve = time_forward_widths(target, tcfg, widths, max_length=M, kv_len=128, reps=10,
                                    dtype=torch.bfloat16)
        log(f"  bf16 target forward (CUDA graph replays): " + ", ".join(
            f"w{w} {t * 1e3:.3f} ms" for w, t in zip(widths, curve))
            + f" ({time.perf_counter() - t0:.1f} s)")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        log("  [8.1] checkpoint")
        t0 = time.perf_counter()
        draft0, dcfg = build_params(FULL["draft"], "random", "bf16", SEED + 1, "cuda")
        if draft_time is None:
            draft_time = time_forward_widths(draft0, dcfg, [8], max_length=M, kv_len=128,
                                             reps=20)[0]
        ckpt = os.path.join(tmp, "draft")
        export_hf_checkpoint(draft0, dcfg, ckpt, weights="bin")
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, back_cfg = load_hf_checkpoint(ckpt, dtype=torch.bfloat16, device="cuda")
        hard_sync("cuda")
        t_load = time.perf_counter() - t0
        draft, _ = build_params(FULL["draft"], ckpt, "bf16", SEED + 1, "cuda")
        pairs = list(zip(tensors(draft0), tensors(back))) + list(zip(tensors(draft0),
                                                                     tensors(draft)))
        same = [a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                for a, b in pairs]
        if not all(same) or back_cfg.hidden_size != dcfg.hidden_size:
            fail(f"checkpoint round trip: {same.count(False)} of {len(same)} tensors differ")
        n_bytes = os.path.getsize(os.path.join(ckpt, "pytorch_model.bin"))
        log(f"  llama-68m exported as pytorch_model.bin ({n_bytes / 1e6:.1f} MB, f32) in "
            f"{t_export:.2f} s, loaded back on the card in {t_load:.2f} s: {len(pairs) // 2} "
            "tensors equal bit for bit, and again through build_params(--draft-weights DIR)")
        del draft0, back

        log("  [8.2] acceptance (cli/accept.py)")
        rows = [np.minimum(r, tcfg.vocab_size - 1).tolist()
                for r in load_pretokenized_jsonl(C4_SMALL, limit=2)]
        via_loader = load_prompts(f"jsonl:{C4_SMALL}", tcfg.vocab_size, SEED)[:2]
        if [r.tolist() for r in via_loader] != rows:
            fail("jsonl: prompts differ from the data layer's rows")
        prompts_path = os.path.join(tmp, "c4_2rows.json")
        with open(prompts_path, "w") as f:
            json.dump(rows, f)
        common = ["--draft", FULL["draft"], "--draft-weights", ckpt, "--target", FULL["target"],
                  "--W", "8", "--T", str(T), "--P", str(P), "--prompts", prompts_path,
                  "--M", str(M), "--seed", str(SEED)]
        vectors, seconds = {}, {}
        for method in ("static", "dynamic"):
            dst = os.path.join(tmp, f"{method}.json")
            hard_sync("cuda")
            t0 = time.perf_counter()
            accept.main(common + ["--method", method, "--steps", "16", "--dst", dst])
            hard_sync("cuda")
            seconds[method] = time.perf_counter() - t0
            with open(dst) as f:
                vec = np.asarray(json.load(f)["vector"])
            if (vec.shape != (9,) or vec[0] != 0.0 or not np.isfinite(vec).all()
                    or (vec < 0).any() or (vec > 1).any() or vec.sum() > 1 + 1e-6):
                fail(f"{method} acceptance: not a vector of rates in [0, 1] summing to <= 1: "
                     f"{vec}")
            vectors[method] = dst
            log(f"  {method}: {np.round(vec, 4).tolist()} (sum {vec.sum():.4f}) in "
                f"{seconds[method]:.2f} s, 2 rows of {[len(r) for r in rows]} tokens "
                "(the 7B target built from the seed inside the CLI)")

        log("  [8.3] plan (cli/tree_search.py, native DP)")
        if planner_dp_lib() is None:
            fail("the native planner DP did not build (g++)")
        n = len(widths)
        config = {"acceptance_rate_vector": vectors["dynamic"], "max_depth": 8,
                  "max_budget": max(widths), "draft_time": draft_time,
                  "valid_budget": widths, "target_time": list(curve[:n]),
                  "dst": os.path.join(tmp, "growmap.json")}
        with open(os.path.join(tmp, "plan.json"), "w") as f:
            json.dump(config, f)
        t0 = time.perf_counter()
        tree_search.main(["--config", os.path.join(tmp, "plan.json")])
        t_plan = time.perf_counter() - t0
        gm = GrowMap.load(config["dst"])
        p_vec = tree_search.load_acceptance_vector(vectors["dynamic"])
        ref, info = plan(p_vec, widths, config["target_time"], draft_time, max_depth=8,
                         backend="numpy")
        if ref.successors != gm.successors:
            fail("the native DP's plan differs from the numpy DP's")
        log(f"  planned tree: {gm.size} nodes, depth {int(gm.depth.max()) if gm.size > 1 else 0}"
            f", max branch {gm.max_branch}, level widths {gm.level_widths}, predicted E "
            f"{info['expected_accepted']:.3f} tokens a step, {info['dec_time'] * 1e3:.3f} "
            f"ms/token (device); tree_search {t_plan:.2f} s (native table)")

    log("  [8.4] serve the plan under each walk (generate_fast)")
    prompts = load_prompts(FULL["prompts"], tcfg.vocab_size, SEED)
    outs, launches, report = {}, {}, []
    for walk in WALKS:
        eng = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia", max_length=M,
                         temperature=T, top_p=P, walk=walk, device="cuda")
        state = eng.prefill(prompts[0], seed=SEED)
        no_sync(torch, lambda: eng.iterate(state), f"walk {walk}")
        eng.generate_fast(prompts[0], max_new_tokens=4)   # warm up and capture
        hard_sync("cuda")
        build.reset_launches()
        t0 = time.perf_counter()
        outs[walk] = [eng.generate_fast(p, max_new_tokens=gen, seed=SEED + i)
                      for i, p in enumerate(prompts)]
        hard_sync("cuda")
        wall = time.perf_counter() - t0
        launches[walk] = dict(build.launches)
        tokens = sum(len(o) - len(p) for o, p in zip(outs[walk], prompts))
        for o, p in zip(outs[walk], prompts):
            if len(o) <= len(p) or o.min() < 0 or o.max() >= tcfg.vocab_size:
                fail(f"walk {walk}: no or out-of-range tokens")
        if any(not np.array_equal(a, b) for a, b in zip(outs[walk], outs["node"])):
            fail(f"walk {walk} emitted other tokens than the node walk at the same seeds")
        _, phases = eng.generate_benchmark(prompts[0], max_new_tokens=gen, seed=SEED)
        steps = eng.num_large_model_steps
        report.append(
            f"{walk}: finalize {phases['accept_kv'] / steps * 1e3:.3f} ms (grow "
            f"{phases['draft_run'] / steps * 1e3:.3f}, verify {phases['target_run'] / steps * 1e3:.3f}"
            f"), {wall / tokens * 1e3:.3f} ms/token over {tokens} tokens, graphs "
            f"{graph_lines(torch, eng, walk)}")
        del eng, state
    for walk in WALKS:
        shown = {k: v for k, v in launches[walk].items() if v}
        log(f"  {report.pop(0)}; launches {shown}")
    need = {"staged": "top_p_threshold_fused", "path": "top_p_threshold_from_logits",
            "unrolled": "top_p_threshold_from_logits", "node": "top_p_threshold_from_logits"}
    for walk, k in need.items():
        if launches[walk][k] == 0 or launches[walk]["tree_attention"] == 0:
            fail(f"walk {walk}: {k} or tree_attention never launched: {launches[walk]}")
    log(f"  tokens equal across the walks ({', '.join(WALKS)}); phase 8 "
        f"{time.perf_counter() - t_phase:.1f} s")
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# Phase 9: batched serving
# ---------------------------------------------------------------------------

BATCHED = dict(B=8, requests=16, lengths=(32, 256), gen=64, max_length=512, chunk=64,
               admit_width=4)


def batched_prompts(vocab, n, seed=SEED):
    """`n` synthetic prompts of mixed lengths in BATCHED["lengths"], from
    `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = BATCHED["lengths"]
    return [rng.integers(3, vocab, size=int(rng.integers(lo, hi + 1))) for _ in range(n)]


def check_batched_attention(torch, gm, results):
    """The slot-axis launches of tree attention against
    `tree_attention_batched_plain`, each slot its own prefix. At the batched
    verify (B = 8 requests of mixed lengths: Q = 64 tree rows over M = 512)
    the route `sm90_route` picks, the Hopper kernel, every cache format and
    both dtypes, timed beside the other route (tree_attention.cu's slot-axis
    launch on the same inputs), B single launches, the plain
    version and SDPA with a [B, 1, Q, M + S] mask (on the dequantized rows
    for an integer cache), with the byte bound of the batched read and the
    route's key tiles (the Hopper kernel: those its prefix skip reads; the
    slot grid: its split count); then the verify of one slot (B = 1: the
    slot-grid route, the Hopper kernel beside it), the batched prefill chunk
    (bf16, Q = 64 causal, S = 0) and distill's forward (f32, B 8, T 64 at
    the trained target's width); then the batched AR step (Q = 1), every
    format and dtype."""
    from sequoia_torch.kernels import tree_attention as ta
    from sequoia_torch.kvcache.cache import quantize_kv_rows, quantize_kv_rows4, unpack_kv_rows4

    B, M, L = BATCHED["B"], BATCHED["max_length"], 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    anc = torch.as_tensor(gm.ancestors, device="cuda")
    ts = torch.tensor([40, 95, 150, 200, 260, 300, 330, 380], device="cuda")[:B]
    k_idx = torch.arange(M, device="cuda")[None, None, :]
    prefix = (k_idx < ts[:, None, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    T = TOOLS["seq_len"]
    th = TOOLS["target_shape"][1] // 32             # the trained target: heads of dim 32
    causal = lambda Q, MM, off: (torch.arange(MM, device="cuda")[None, None, :]  # noqa: E731
                                 <= off[:, None, None] + torch.arange(Q, device="cuda")[None, :, None])
    cases = [   # label, B, Q, H, D, M, S, main mask, scratch mask, dtypes, formats, JSON entries
        ("verify", B, gm.size, 32, 128, M, gm.size, prefix.expand(B, gm.size, M),
         anc.expand(B, gm.size, gm.size), (torch.bfloat16, torch.float32), KV_FORMATS, True),
        ("verify of one slot", 1, gm.size, 32, 128, M, gm.size, prefix[-1:].expand(
            1, gm.size, M), anc.expand(1, gm.size, gm.size), (torch.bfloat16, torch.float32),
         ("float", "int8"), False),
        ("prefill chunk", B, 64, 32, 128, M, 0, causal(64, M, (ts // 64) * 64),
         None, (torch.bfloat16,), ("float", "int8"), False),
        ("distill forward", B, T, th, 32, T, 0, causal(T, T, ts * 0), None, (torch.float32,),
         ("float",), False),
        ("ar step", B, 1, 32, 128, M, 1, prefix.expand(B, 1, M), None,
         (torch.bfloat16, torch.float32), KV_FORMATS, True),
    ]
    for label, B, Q, H, D, MM, S, main, scr, dtypes, formats, entry in cases:
        main = main.contiguous()
        scr = (scr if scr is not None else torch.ones(B, Q, S, dtype=torch.bool, device="cuda")
               ).contiguous()
        sm90 = ta.sm90_route(B, Q, H, H, sms)
        for dtype in dtypes:
            tol, itemsize = tols[dtype], (2 if dtype == torch.bfloat16 else 4)
            q = torch.randn(B, Q, H, D, generator=gen, device="cuda").to(dtype)
            k = torch.randn(L, B, MM, H, D, generator=gen, device="cuda").to(dtype)
            v = torch.randn(L, B, MM, H, D, generator=gen, device="cuda").to(dtype)
            sk = torch.randn(L, B, S, H, D, generator=gen, device="cuda").to(dtype)
            sv = torch.randn(L, B, S, H, D, generator=gen, device="cuda").to(dtype)
            for fmt in formats:
                kv_item = KV_FORMATS[fmt]
                if fmt == "float":
                    km, vm, ks, vs, kd, vd = k, v, [None] * L, [None] * L, k, v
                else:
                    quant = quantize_kv_rows if fmt == "int8" else (
                        lambda x, f=fmt: quantize_kv_rows4(x, packing=f[5:]))
                    (km, ks), (vm, vs) = quant(k), quant(v)
                    ints = (lambda x: x) if fmt == "int8" else (
                        lambda x, f=fmt: unpack_kv_rows4(x, packing=f[5:]))
                    kd = (ints(km).float() * ks[..., None]).to(dtype)
                    vd = (ints(vm).float() * vs[..., None]).to(dtype)
                call = lambda fn, i: fn(q, km[i], vm[i], main, sk[i], sv[i], scr,  # noqa: E731
                                        scale=D ** -0.5, ks=ks[i], vs=vs[i])
                name = ta.counter(fmt, dtype, batched=True, sm90=sm90)
                got = call(ta.tree_attention_batched, 0)
                want = call(ta.tree_attention_batched_plain, 0)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol) \
                        or not torch.isfinite(got).all():
                    fail(f"{name} [{label}] disagrees with its plain version at B={B}: "
                         f"max |err| {err} (tol {tol})")
                ms = device_ms([lambda i=i: call(ta.tree_attention_batched, i) for i in range(L)])
                plain_ms = device_ms([lambda i=i: call(ta.tree_attention_batched_plain, i)
                                      for i in range(L)])
                # The other route on the same inputs where both take the
                # call (Q > 16); its launches count nowhere.
                old_ms, old_note, grid_ms = None, "", None
                if Q > ta.SM90_MIN_Q:
                    other = ta.counter(fmt, dtype, batched=True, sm90=not sm90)
                    launch = ta._launch if sm90 else ta._launch_sm90
                    alt = lambda i: launch(  # noqa: E731
                        q, km[i], vm[i], main, sk[i], sv[i], scr, ks[i], vs[i], fmt, D ** -0.5,
                        B, Q, H, H, D, MM, S, other)
                    if not torch.allclose(alt(0).float(), want.float(), rtol=tol, atol=tol):
                        fail(f"{other} [{label}] (the route not taken) disagrees with its plain "
                             f"version")
                    old_ms = device_ms([lambda i=i: alt(i) for i in range(L)])
                    old_note = (f"  {'slot grid' if sm90 else 'Hopper kernel'} {old_ms:.4f} ms "
                                f"({old_ms / ms:.2f}x)")
                    grid_ms = old_ms if sm90 else ms
                ext = ta.tile_extents(main, scr, rows=ta.SM90_ROWS)   # (g = 1)
                kt = ta.SM90_KEYS[dtype]
                read = int(((ext + kt - 1) // kt).sum())
                walk = (-(-MM // kt) + -(-S // kt)) * ext.shape[0] * ext.shape[1]
                route = (f"Hopper kernel ({B * H * ext.shape[1]} work items on {sms} SMs), "
                         f"{kt}-key tiles {read}/{walk} a KV head" if sm90 else
                         f"slot grid, splits {ta.split_count(Q, H, MM, S, sms, dtype, batch=B)}")
                single_ms = None
                if label == "verify":
                    single_ms = B * device_ms([
                        lambda i=i, b=b: ta.tree_attention(
                            q[b], km[i][b], vm[i][b], main[b], sk[i][b], sv[i][b], scr[b],
                            scale=D ** -0.5, ks=None if ks[i] is None else ks[i][b],
                            vs=None if vs[i] is None else vs[i][b])
                        for i in range(L) for b in range(B)])
                qb = q.transpose(1, 2)                                        # [B, H, Q, D]
                kk = [torch.cat([kd[i], sk[i]], dim=1).transpose(1, 2) for i in range(L)]
                vv = [torch.cat([vd[i], sv[i]], dim=1).transpose(1, 2) for i in range(L)]
                full_mask = torch.cat([main, scr], dim=2)[:, None]            # [B, 1, Q, M + S]
                lib_ms = device_ms([lambda i=i: sdpa(qb, kk[i], vv[i], attn_mask=full_mask,
                                                     scale=D ** -0.5) for i in range(L)])
                del kk, vv
                t_bytes = t_ops = 0.0
                for b in range(B):
                    tb, to = attention_times(q[b], main[b], scr[b], D, H, H, itemsize, kv_item)
                    t_bytes, t_ops = t_bytes + tb, t_ops + to
                bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
                log(f"  {name} [{label}] B={B} Q={Q} H={H} D={D} M={MM} S={S} "
                    f"{str(dtype)[6:]}: max|err| {err:.3g} (tol {tol}) kernel {ms:.4f} ms"
                    f"{old_note}" + (f"  {B} single launches {single_ms:.4f} ms"
                                     if single_ms else "")
                    + f"  plain {plain_ms:.4f} ms  sdpa [B] mask {lib_ms:.4f} ms  "
                    f"bound {bound:.5f} ms ({by}); {route}")
                if entry:
                    source = "tree_attention_batched_sm90.cu" if sm90 else "tree_attention.cu"
                    results.append(dict(
                        name=name, route="cuda", source=f"sequoia_torch/csrc/{source}",
                        replaces="sequoia_tpu/kernels/tree_attention.py:111",
                        shape=f"batched {label} B={B} Q={Q} H={H} D={D} M={MM} S={S} "
                              f"{'bf16' if itemsize == 2 else 'f32'}, main cache {fmt}",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        library_ms=lib_ms, single_launches_ms=single_ms, slot_grid_ms=grid_ms))
                del km, vm, kd, vd
            del q, k, v, sk, sv
            torch.cuda.empty_cache()


def batched_small(torch):
    """test-small on the card through the batched engine, at the fewest
    slots whose 32-row prefill chunks take the Hopper slot-axis kernel
    (`sm90_route`; a KV head of a slot a work item) in every format;
    the 15-node tree's verify takes the slot-grid route. f32 greedy
    `serve_fast` equal to its CPU run (float cache); with a float, int8,
    int4 head-paired and int4 dsplit cache (f32; int4 also bf16) a valid run
    whose `serve_fast` (graph replays) equals eager `serve`. `serve` fills
    slots by the single-request prefill and `serve_fast` by the fused
    batched one, so in bf16 the two sum in different orders: a bf16 run may
    part from `serve` only at a near-tie token (`near_tie` within TIE, its
    gap logged). bf16 int4 caches also through `generate_batch_fast` against
    `generate_batch` (both fused): exact. Last, an int8-weight target (bf16
    activations) the same way."""
    import numpy as np

    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.batched import BatchedSpecEngine
    from sequoia_torch.kernels import tree_attention as ta
    from sequoia_torch.trees.growmap import uniform_tree

    cfg = get_config("test-small")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)) for n in (5, 11, 17, 3, 9, 14)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = next(b for b in range(1, sms + 1)
                 if ta.sm90_route(b, 32, cfg.num_heads, cfg.num_kv_heads, sms))
    kw = dict(algorithm="greedy", max_length=96, batch_size=slots, prefill_chunk=32)
    ties = []

    def compare(label, fast, eager, target, exact):
        """Every output valid; `fast` equal to `eager`, or (not `exact`)
        parted from it first at a near tie."""
        for a, b, p in zip(fast, eager, prompts):
            if len(a) <= len(p) or not np.array_equal(a[:len(p)], p) \
                    or a.max() >= cfg.vocab_size:
                fail(f"{label}: invalid batched output {a}")
            if np.array_equal(a, b):
                continue
            n = min(len(a), len(b))
            if exact or np.array_equal(a[:n], b[:n]):
                fail(f"{label}: batched replays differ from eager:\n{a}\n{b}")
            j, gap, below, spread = near_tie(torch, target, cfg, b, a, kw["max_length"])
            ties.append(f"{label} at position {j} ({j - len(p)} generated): logit gap "
                        f"{gap:.4f}, {below:.4f} below the top, logits' std {spread:.3f}")
            if j < len(p) or gap > TIE * spread or below > TIE * spread:
                fail(f"{label}: serve_fast parts from eager serve past a near tie: {ties[-1]}")

    outs = {}
    for dtype in ("f32", "bf16"):
        tdtype = torch.float32 if dtype == "f32" else torch.bfloat16
        card = (random_params(cfg, 7, dtype=tdtype, device="cuda"),
                random_params(cfg, 8, dtype=tdtype, device="cuda"))
        params = {"cuda": card, "cpu": tuple(tree_to(p, "cpu") for p in card)}
        for kv_quant, packing in ((None, None), ("int8", None), ("int4", "head"),
                                  ("int4", "dsplit")):
            if dtype == "bf16" and kv_quant != "int4":
                continue
            devs = ("cuda", "cpu") if kv_quant is None else ("cuda",)
            for dev in devs:
                eng = BatchedSpecEngine(params[dev][0], cfg, params[dev][1], cfg,
                                        uniform_tree(3, 2), kv_quant=kv_quant, device=dev, **kw)
                if packing is not None:
                    eng._kv4_packing = packing
                outs[dev] = eng.serve_fast(prompts, max_new_tokens=24, seed=SEED)
                if dev == "cuda":
                    eager = eng.serve(prompts, max_new_tokens=24, seed=SEED)
                    compare(f"test-small {dtype}, KV {kv_quant or 'float'} {packing or ''}",
                            outs[dev], eager, card[1], exact=dtype == "f32")
            if kv_quant is None:
                for a, b in zip(outs["cuda"], outs["cpu"]):
                    if not np.array_equal(a, b):
                        fail(f"test-small f32 batched serve_fast: card differs from CPU:\n{a}\n{b}")
                log(f"  test-small f32 batched serve_fast (B={slots}, 6 requests): card == CPU, "
                    "replayed == eager")
            if dtype == "bf16" and kv_quant == "int4":   # both fills fused: exact
                batch = [prompts[i % len(prompts)] for i in range(slots)]   # a prompt a slot
                fast = eng.generate_batch_fast(batch, max_new_tokens=16, seed=SEED)
                for a, b in zip(fast, eng.generate_batch(batch, max_new_tokens=16, seed=SEED)):
                    if not np.array_equal(a, b):
                        fail(f"test-small bf16, KV int4 {packing}: batched replays differ "
                             f"from eager generate_batch:\n{a}\n{b}")
    # A quantized batched target, small: int8 weights (bf16 activations: w8a8
    # off, which "auto" turns on at these slots' 96+ rows), the B x tree rows
    # of a batched verify through the int8 wgmma kernel.
    from sequoia_torch.kernels import build
    from sequoia_torch.quant import qtensor
    from sequoia_torch.quant.quantize import quantize_model

    draft = random_params(cfg, 7, dtype=torch.bfloat16, device="cuda")
    target = quantize_model(random_params(cfg, 8, dtype=torch.bfloat16, device="cuda"), bits=8)
    eng = BatchedSpecEngine(draft, cfg, target, cfg, uniform_tree(3, 2), device="cuda", **kw)
    before = build.launches["quant_matmul_int8_wgmma"]
    qtensor.set_w8a8("off")
    try:
        fast = eng.serve_fast(prompts, max_new_tokens=24, seed=SEED)
        eager = eng.serve(prompts, max_new_tokens=24, seed=SEED)
    finally:
        qtensor.set_w8a8("auto")
    if build.launches["quant_matmul_int8_wgmma"] == before:
        fail("the int8 batched target never reached quant_matmul_int8_wgmma")
    compare("test-small int8-weight target", fast, eager, target, exact=False)
    log(f"  test-small batched runs at B={slots}, 32-row chunks (Hopper kernel), float / int8 / "
        "int4-head / int4-dsplit caches (f32; int4 also bf16) and an int8-weight target: valid, "
        "replayed == eager (f32 exact; bf16 up to near ties); bf16 int4: generate_batch_fast == "
        "generate_batch" + ("".join(f"; {t}" for t in ties) if ties else "; no near tie"))


# Two greedy runs whose target forwards differ in shape (a batch of slots, a
# single request) may round bf16 differently, and then part where two
# tokens' logits tie within that rounding. TIE bounds the tie, as a share
# of the logits' standard deviation.
TIE = 0.05


def near_tie(torch, target, tcfg, want, got, M):
    """Where two greedy sequences first differ: the position, and from the
    target's logits after their common prefix (one bf16 prefill forward),
    the gap between the two tokens' logits, how far the higher one lies
    below the top logit, and the logits' standard deviation."""
    from sequoia_torch.core.model import forward
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks

    j = next(i for i in range(min(len(want), len(got))) if want[i] != got[i])
    toks = torch.as_tensor(want[:j], device="cuda")
    kv = KVCache.init(tcfg, M, torch.bfloat16, "cuda")
    logits, _ = forward(target, tcfg, toks, torch.arange(j, device="cuda"), kv, 0,
                        masks.causal_mask(j, M, 0, "cuda"))
    row = logits[-1].float()
    a, b = row[int(want[j])].item(), row[int(got[j])].item()
    return j, abs(a - b), row.max().item() - max(a, b), row.std().item()


def replay_ms(torch, graphs, names, reps=10):
    """Device ms of one replay of each graph in `names`, in order (CUDA
    events between them, `reps` rounds)."""
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
              for _ in range(reps)]
    torch.cuda.synchronize()
    for ev in events:
        ev[0].record()
        for i, n in enumerate(names):
            graphs.replay(n)
            ev[i + 1].record()
    torch.cuda.synchronize()
    return [statistics.median(ev[i].elapsed_time(ev[i + 1]) for ev in events)
            for i in range(len(names))]


def batched_serving(torch, gm):
    """Phase 9: the bf16 llama-68m -> llama-2-7b pair through the batched
    engines at B = 8, a queue of 16 mixed-length requests: Sequoia through
    `serve_fast` and `serve_device` (admit_width 4) and batched AR through
    `serve_fast`, with the bf16 and the int8 KV cache, then `serve_auto`
    (which must pick the device loop); the greedy checks; the batched
    kernel; test-small on the card. Returns the launches of the runs."""
    import numpy as np

    from sequoia_torch.engine.batched import BatchedAREngine, BatchedSpecEngine
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.planner.dp import expected_accepted
    from sequoia_torch.planner.profile import default_acceptance_vector

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    build.reset_launches()
    batched_small(torch)
    add(build.launches)
    target, tcfg, draft, dcfg = load_models(torch)
    B, gen, M, C = BATCHED["B"], BATCHED["gen"], BATCHED["max_length"], BATCHED["chunk"]
    prompts = batched_prompts(tcfg.vocab_size, BATCHED["requests"])
    n_prompt = sum(len(p) for p in prompts)
    common = dict(max_length=M, prefill_chunk=C, temperature=FULL["T"], top_p=FULL["P"])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def valid(outs, label):
        for o, p in zip(outs, prompts):
            if len(o) <= len(p) or not np.array_equal(o[:len(p)], p) or o.min() < 0 \
                    or o.max() >= tcfg.vocab_size or len(o) > len(p) + gen:
                fail(f"{label}: invalid output (prompt {len(p)}, output {len(o)})")

    costs = {}
    for kv_quant in (None, "int8"):
        kv_label = f"{kv_quant or 'bf16'} KV"
        eng = BatchedSpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia",
                                batch_size=B, admit_width=BATCHED["admit_width"],
                                kv_quant=kv_quant, device="cuda", **common)
        # Untimed: capture the four graphs (a server does it once, at start).
        eng.serve_device(prompts[:B], max_new_tokens=2, seed=SEED)
        for name in ("serve_fast", "serve_device"):
            build.reset_launches()
            outs, wall = timed(lambda: getattr(eng, name)(prompts, max_new_tokens=gen, seed=SEED))
            add(build.launches)
            valid(outs, f"{name}, {kv_label}")
            toks, iters = eng.num_decoding_steps, eng.num_large_model_steps
            extra = (f", admission steps {eng.num_prefill_steps} (width {eng.admit_width})"
                     if name == "serve_device" else "")
            log(f"  Sequoia {name}, {kv_label}: {toks} tokens of {len(prompts)} requests "
                f"({n_prompt} prompt tokens) in {wall:.3f} s = {toks / wall:.1f} tokens/s; "
                f"{iters} batched iterations ({toks / max(iters, 1) / B:.3f} tokens per slot "
                f"and iteration){extra}")
            if name == "serve_device":
                costs[kv_quant] = (wall / max(iters, 1), toks / max(iters, 1) / B)
        rep = eng.graph_report()
        eng._arm_slots(0, M, [False] * B)   # no live slot: the same kernels, nothing kept
        grow, verify, finalize = replay_ms(torch, eng._bgraphs, ("grow", "verify", "finalize"))
        _, fill = timed(lambda: eng.prefill_batch(prompts[:B], seed=SEED))
        _, insert = timed(lambda: eng.insert_slot(eng._bstate, prompts[B], 0, seed=SEED))
        log(f"  replay device ms at B={B}: grow {grow:.3f}, verify {verify:.3f}, finalize "
            f"{finalize:.3f} (iteration {grow + verify + finalize:.3f}); wall ms of the fused "
            f"prefill of {B} prompts {fill * 1e3:.1f}, of one insert_slot {insert * 1e3:.1f}")
        log("  graphs: " + ", ".join(
            f"{n} {graph_kernels(eng._bgraphs.graphs[n].graph)} kernels, captured in "
            f"{g['capture_s']:.2f} s" for n, g in rep.items()))
        ar = BatchedAREngine(target, tcfg, batch_size=B, kv_quant=kv_quant, device="cuda",
                             **common)
        ar.serve_fast(prompts[:B], max_new_tokens=2, seed=SEED)   # untimed: the capture
        build.reset_launches()
        outs, wall = timed(lambda: ar.serve_fast(prompts, max_new_tokens=gen, seed=SEED))
        add(build.launches)
        valid(outs, f"batched AR, {kv_label}")
        toks, steps = ar.num_decoding_steps, ar.num_large_model_steps
        ar._arm_slots(0, M, [False] * B)
        step_ms = replay_ms(torch, ar._bgraphs, ("step",))[0]
        log(f"  batched AR serve_fast, {kv_label}: {toks} tokens in {wall:.3f} s = "
            f"{toks / wall:.1f} tokens/s; {steps} batched steps; step replay {step_ms:.3f} "
            f"device ms, {graph_kernels(ar._bgraphs.graphs['step'].graph)} kernels")
        if kv_quant is None:
            costs["ar"] = wall / max(steps, 1)
            # serve_auto on the measured iteration and step costs and the
            # planned tree's expected acceptance (the bundled vector).
            e_plan = expected_accepted(gm, default_acceptance_vector())
            build.reset_launches()
            outs, wall = timed(lambda: eng.serve_auto(
                prompts, spec_iter_s=costs[None][0], ar_step_s=costs["ar"],
                expected_accepted=e_plan, ar_engine=ar, max_new_tokens=gen, seed=SEED))
            add(build.launches)
            valid(outs, "serve_auto")
            if eng.serving_mode != "spec" or eng.num_prefill_steps == 0:
                fail(f"serve_auto did not route to the device loop (mode {eng.serving_mode})")
            log(f"  serve_auto: spec iteration {costs[None][0] * 1e3:.3f} ms, AR step "
                f"{costs['ar'] * 1e3:.3f} ms, planned E {e_plan:.3f} -> {eng.serving_mode}, "
                f"serve_device ({eng.num_decoding_steps / wall:.1f} tokens/s)")
        del eng, ar
        torch.cuda.empty_cache()

    # Greedy checks, bf16 KV: 8 requests (one wave, so every chunk forward
    # has the same rows in both loops).
    first = prompts[:B]
    eng = BatchedSpecEngine(draft, dcfg, target, tcfg, gm, algorithm="greedy", batch_size=B,
                            admit_width=B, device="cuda", **common)
    fast = eng.serve_fast(first, max_new_tokens=gen, seed=SEED)
    dev = eng.serve_device(first, max_new_tokens=gen, seed=SEED)
    for i, (a, b) in enumerate(zip(fast, dev)):
        if not np.array_equal(a, b):
            fail(f"greedy serve_device differs from serve_fast on request {i}:\n{a}\n{b}")
    short = eng.generate_batch(first, max_new_tokens=8, seed=SEED)
    replayed = eng.generate_batch_fast(first, max_new_tokens=8, seed=SEED)
    for a, b in zip(short, replayed):
        if not np.array_equal(a, b):
            fail(f"batched replays differ from eager generate_batch:\n{a}\n{b}")
    outs = eng.generate_batch_fast(first, max_new_tokens=gen, seed=SEED)
    single = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="greedy", device="cuda",
                        **common)
    same, ties = 0, []
    for s, (p, o) in enumerate(zip(first, outs)):
        want = single.generate_fast(p, max_new_tokens=gen, seed=SEED)
        if np.array_equal(o, want[:len(o)]):
            same += 1
            continue
        j, gap, below, spread = near_tie(torch, target, tcfg, want, o, M)
        ties.append(f"slot {s} at position {j} ({j - len(p)} generated): logit gap "
                    f"{gap:.4f}, {below:.4f} below the top, logits' std {spread:.3f}")
        if j < len(p) or gap > TIE * spread or below > TIE * spread:
            fail(f"greedy slot {s} differs from the single-request engine: {ties[-1]}")
    log(f"  greedy (bf16): serve_device == serve_fast ({B} requests), replayed == eager "
        f"generate_batch; generate_batch_fast == SpecEngine.generate_fast on {same} of {B} "
        f"slots" + "".join(f"; {t}" for t in ties))
    del eng, single, target, draft
    torch.cuda.empty_cache()

    log("[9] the batched kernel against its plain version")
    kernels = []
    check_batched_attention(torch, gm, kernels)
    log(f"  phase 9 {time.perf_counter() - t_phase:.1f} s")
    return launches, kernels


# ---------------------------------------------------------------------------
# Phase 10: host offload
# ---------------------------------------------------------------------------

OFFLOAD = dict(stays=(0, 16), widths=(1, 64), gen=32, prompts="synthetic:2,128",
               curve=(1, 16, 64, 128, 256, 512, 1024), big="llama-2-70b", big_layers=8,
               big_widths=(1, 64, 512), big_stay=36)


def meminfo() -> str:
    """MemTotal and MemAvailable of the host, in GB (/proc/meminfo)."""
    fields = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, rest = line.split(":", 1)
            fields[name] = int(rest.split()[0]) * 1024
    return (f"host MemTotal {fields['MemTotal'] / 1e9:.1f} GB, "
            f"MemAvailable {fields['MemAvailable'] / 1e9:.1f} GB")


def layer_bytes(cfg, itemsize=2) -> int:
    """Bytes of one layer's seven projection matrices (what a streamed
    layer copies; the norms stay on the card)."""
    E, F, H, Hkv, D = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim_)
    return (2 * E * H * D + 2 * E * Hkv * D + 3 * E * F) * itemsize


def host_link(torch, nbytes, reps=5, run=8):
    """Host-to-device GB/s of copies of `nbytes` from pinned memory, CUDA
    events around them: one copy alone, and `run` copies back to back (the
    rate a streamed forward's copies see); each the median of `reps`."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    if not host.is_pinned():
        fail("could not pin host memory")
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    rates = []
    for n in (1, run):
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                dev.copy_(host, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        rates.append(n * nbytes / (statistics.median(times) / 1e3) / 1e9)
    return rates


def poison(torch, bufs) -> None:
    """NaN into every float staging buffer, -128 (no int8 or int4 weight
    value) into every integer one, on the current (compute) stream."""
    for b in bufs:
        b.fill_(float("nan") if b.is_floating_point() else -128)


def split_forward(torch, cfg, width, dtype, kv_len=128, M=256):
    """A split-mode forward at `width` (the verify's shape: the main cache,
    random rows, read-only at `kv_len`; the new rows into a scratch) as a
    function of the params that returns (logits, scratch K, scratch V)."""
    from sequoia_torch.core.model import forward
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops.masks import causal_mask

    gen = torch.Generator(device="cuda").manual_seed(width)
    kv = KVCache.init(cfg, M, dtype, "cuda")
    for t in (kv.k, kv.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (width,), generator=gen, device="cuda")
    pos = kv_len + torch.arange(width, device="cuda")
    mask = (torch.arange(M, device="cuda") < kv_len)[None, :].expand(width, M).contiguous()
    smask = torch.tril(torch.ones(width, width, dtype=torch.bool, device="cuda"))
    wmask = causal_mask(width, M, kv_len, "cuda")

    def run(params):
        scratch = KVCache.init(cfg, width, dtype, "cuda")
        logits, _ = forward(params, cfg, tokens, pos, kv, kv_len, mask, scratch=scratch,
                            scratch_offset=0, scratch_mask=smask)
        return logits, scratch.k, scratch.v

    def write(params):
        """The same rows in write mode (a prefill chunk): into a copy of
        the main cache at `kv_len`; returns (logits, its K, its V)."""
        main = KVCache(kv.k.clone(), kv.v.clone())
        logits, _ = forward(params, cfg, tokens, pos, main, kv_len, wmask)
        return logits, main.k, main.v

    run.write = write
    return run


def graph_of(torch, fn):
    """`fn` captured into a CUDA graph after an eager warm-up (GraphSet):
    (GraphSet, captured outputs, device ms of one replay: median of 3)."""
    from sequoia_torch.engine.graphs import GraphSet

    graphs = GraphSet(torch.device("cuda"))
    with graphs.warmup():
        fn()
    outs = graphs.capture("forward", fn)
    graphs.replay("forward")
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graphs.replay("forward")
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return graphs, outs, statistics.median(times)


def offload_forward_checks(torch, resident, off, cfg, label, widths, rate):
    """The offloaded forward against the resident one, bit for bit (logits
    and the scratch K/V it writes), at each width: eager; in write mode
    (logits and the main cache); eager with the
    staging buffers poisoned first; an eager forward under
    `set_sync_debug_mode("error")` (a pageable copy would synchronize);
    replayed from a graph; replayed with the buffers poisoned before the
    replay. Prints each graph's nodes by kind beside the resident graph's,
    and the offloaded replay's device ms against the link bound (streamed
    bytes over `rate`)."""
    from sequoia_torch.engine.offload import offloaded_bytes, staging_buffers

    host_bytes = offloaded_bytes(off)[0]
    bound_ms = host_bytes / (rate * 1e9) * 1e3
    times = {}
    for w in widths:
        run = split_forward(torch, cfg, w, resident.embed.dtype)
        want = [t.clone() for t in run(resident)]

        def same(got, how):
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"{label} w{w}, {how}: the offloaded forward differs from the resident one")

        same(run(off), "eager")
        wwant = [t.clone() for t in run.write(resident)]
        if not all(torch.equal(a, b) for a, b in zip(run.write(off), wwant)):
            fail(f"{label} w{w}, write mode: the offloaded forward differs from the resident one")
        bufs = staging_buffers(off)
        poison(torch, bufs)
        same(run(off), "eager, staging poisoned")
        no_sync(torch, lambda: run(off), f"{label} w{w} eager offloaded forward")
        graphs, outs, ms = graph_of(torch, lambda: run(off))
        same(outs, "replayed")
        poison(torch, bufs)
        graphs.replay("forward")
        same(outs, "replayed, staging poisoned")
        kinds = graph_nodes(graphs.graphs["forward"].graph)
        del graphs, outs
        rgraphs, _, rms = graph_of(torch, lambda: run(resident))
        rkinds = graph_nodes(rgraphs.graphs["forward"].graph)
        del rgraphs
        times[w] = ms
        log(f"  [10] {label} w{w}: offloaded == resident bit for bit (eager, write mode, "
            f"poisoned, replayed, replayed poisoned); replay {ms:.3f} ms against a link bound of "
            f"{bound_ms:.3f} ms ({host_bytes / 1e9:.3f} GB at {rate:.2f} GB/s: "
            f"{ms / bound_ms:.3f}x), resident {rms:.3f} ms; graph nodes {kinds} "
            f"(resident {rkinds})")
    return times


def offload_engines(torch, gm, draft, dcfg, target, tcfg, prompts, label, want=None):
    """Stochastic Sequoia (T 0.6, P 0.9) and AR through `generate_fast`
    on `target`, `OFFLOAD["gen"]` new tokens a prompt, seeds SEED + i,
    after an untimed warm-up that captures the graphs. Returns
    {kind: outputs}; with `want`, each output must equal it. Prints
    ms/token."""
    import numpy as np

    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.utils import hard_sync

    common = dict(max_length=FULL["max_length"], temperature=FULL["T"], top_p=FULL["P"],
                  device="cuda")
    engines = {"Sequoia": SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia",
                                     **common),
               "AR": ARBaseline(target, tcfg, **common)}
    outs = {}
    for kind, eng in engines.items():
        eng.generate_fast(prompts[0], max_new_tokens=2, seed=SEED)   # capture
        hard_sync("cuda")
        t0 = time.perf_counter()
        outs[kind] = [eng.generate_fast(p, max_new_tokens=OFFLOAD["gen"], seed=SEED + i)
                      for i, p in enumerate(prompts)]
        hard_sync("cuda")
        wall = time.perf_counter() - t0
        tokens = sum(len(o) - len(p) for o, p in zip(outs[kind], prompts))
        if want is not None and not all(np.array_equal(a, b)
                                        for a, b in zip(outs[kind], want[kind])):
            fail(f"{label}: {kind} tokens differ from the resident target's")
        log(f"  [10] {label} {kind} generate_fast: {tokens} tokens in {wall:.3f} s, "
            f"{wall / tokens * 1e3:.3f} ms/token" + (", tokens equal the resident run's"
                                                     if want is not None else "")
            + "; graph nodes " + ", ".join(f"{n} {graph_nodes(g.graph)}"
                                           for n, g in eng._graphs.graphs.items()))
    return outs


def host_offload(torch, gm, draft_time=None):
    """Phase 10: llama-2-7b (bf16, then int8 weight-only) with its layers
    streamed from pinned host memory, held bit for bit against the
    resident forward and engines; the offloaded curve and its plan; then
    llama-2-70b at full width, 8 layers, all streamed. Returns the
    launches of the offloaded runs."""
    import dataclasses

    from sequoia_torch.cli.testbed import build_params, load_prompts
    from sequoia_torch.core.config import get_config
    from sequoia_torch.engine.offload import (offload_params, offloaded_bytes,
                                              random_offloaded_params, resident_params)
    from sequoia_torch.kernels import build
    from sequoia_torch.planner.dp import plan
    from sequoia_torch.planner.profile import default_acceptance_vector, time_forward_widths

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def free_host():
        torch.cuda.empty_cache()
        if hasattr(torch._C, "_host_emptyCache"):   # the pinned blocks back to the host
            torch._C._host_emptyCache()

    cfg7, cfg_big = get_config(FULL["target"]), get_config(OFFLOAD["big"])
    rates = {}
    for name, cfg in ((FULL["target"], cfg7), (OFFLOAD["big"], cfg_big)):
        alone, rates[name] = host_link(torch, layer_bytes(cfg))
        log(f"  [10] host link: one {name} bf16 layer ({layer_bytes(cfg) / 1e9:.3f} GB) "
            f"pinned -> card at {alone:.2f} GB/s alone, {rates[name]:.2f} GB/s in a run of 8 "
            f"(the rate each link bound below uses)")
    rate = rates[FULL["target"]]

    target, tcfg, draft, dcfg = load_models(torch)
    prompts = load_prompts(OFFLOAD["prompts"], tcfg.vocab_size, SEED)
    build.reset_launches()
    want = offload_engines(torch, gm, draft, dcfg, target, tcfg, prompts, "bf16 resident")
    curve = None
    for stay in OFFLOAD["stays"]:
        label = f"7B bf16, stay {stay}"
        streamed = (tcfg.num_layers - stay) * layer_bytes(tcfg)
        log(f"  [10] {label}: {meminfo()}; pinning {streamed / 1e9:.2f} GB")
        t0 = time.perf_counter()
        off = offload_params(target, stay_layers=stay)
        torch.cuda.synchronize()
        host_bytes, dev_bytes = offloaded_bytes(off)
        log(f"  [10] {label}: pinned and filled in {time.perf_counter() - t0:.1f} s, "
            f"{host_bytes / 1e9:.3f} GB on the host, {dev_bytes / 1e9:.3f} GB on the card")
        offload_forward_checks(torch, target, off, tcfg, label, OFFLOAD["widths"], rate)
        build.reset_launches()
        offload_engines(torch, gm, draft, dcfg, off, tcfg, prompts, label, want)
        add(build.launches)
        if stay == 0:
            t0 = time.perf_counter()
            build.reset_launches()
            curve = time_forward_widths(off, tcfg, OFFLOAD["curve"],
                                        max_length=FULL["max_length"], kv_len=128)
            if build.launches["tree_attention"] == 0:
                fail("tree attention never launched in the offloaded curve")
            add(build.launches)
            log(f"  [10] {label} curve (device ms of one split-mode forward, graph replays, "
                f"reps 2): " + ", ".join(f"w{w} {t * 1e3:.3f}" for w, t in
                                          zip(OFFLOAD["curve"], curve))
                + f" ({time.perf_counter() - t0:.1f} s)")
        del off
        free_host()
    if draft_time is None:
        draft_time = time_forward_widths(draft, dcfg, [8], max_length=FULL["max_length"],
                                         kv_len=128, reps=20)[0]
    pgm, info = plan(default_acceptance_vector(), list(OFFLOAD["curve"]), curve, draft_time,
                     max_depth=8)
    log(f"  [10] plan on the offloaded curve (widths {OFFLOAD['curve'][0]}.."
        f"{OFFLOAD['curve'][-1]}, draft w8 {draft_time * 1e3:.4f} ms): size {pgm.size}, "
        f"depth {info['depth']}, expected accepted {info['expected_accepted']:.3f}, "
        f"predicted {info['dec_time'] * 1e3:.3f} ms/token")
    del target, draft
    free_host()

    label = "7B int8 weight-only, stay 0"
    target, tcfg = build_params(FULL["target"], "random", "bf16", SEED, "cuda", quant_bits=8)
    off = offload_params(target, stay_layers=0)
    build.reset_launches()
    offload_forward_checks(torch, target, off, tcfg, label, OFFLOAD["widths"], rate)
    if build.launches["quant_matmul_int8_wgmma"] == 0:
        fail(f"{label}: the int8 wgmma kernel never launched")
    add(build.launches)
    del target, off
    free_host()

    cfg = dataclasses.replace(cfg_big, num_layers=OFFLOAD["big_layers"])
    label = f"{OFFLOAD['big']} bf16, {cfg.num_layers} layers, all streamed"
    streamed = cfg.num_layers * layer_bytes(cfg)
    log(f"  [10] {label}: {meminfo()}; pinning {streamed / 1e9:.2f} GB")
    t0 = time.perf_counter()
    off = random_offloaded_params(cfg, SEED, dtype=torch.bfloat16, stay_layers=0,
                                  device="cuda")
    torch.cuda.synchronize()
    log(f"  [10] {label}: built in pinned memory in {time.perf_counter() - t0:.1f} s, "
        f"{offloaded_bytes(off)[0] / 1e9:.3f} GB on the host")
    build.reset_launches()
    big = time_forward_widths(off, cfg, OFFLOAD["big_widths"], max_length=FULL["max_length"],
                              kv_len=128)
    add(build.launches)
    resident = resident_params(off)
    big_res = time_forward_widths(resident, cfg, OFFLOAD["big_widths"],
                                  max_length=FULL["max_length"], kv_len=128, reps=10)
    big_rate = rates[OFFLOAD["big"]]
    for w, t, r in zip(OFFLOAD["big_widths"], big, big_res):
        per, per_res = t / cfg.num_layers * 1e3, r / cfg.num_layers * 1e3
        full = OFFLOAD["big_stay"] * per_res + (cfg_big.num_layers - OFFLOAD["big_stay"]) * per
        log(f"  [10] {label} w{w}: {t * 1e3:.3f} ms a forward, {per:.3f} ms a streamed layer "
            f"(link bound {layer_bytes(cfg) / (big_rate * 1e9) * 1e3:.3f} ms); resident "
            f"{r * 1e3:.3f} ms, {per_res:.3f} ms a layer; an {cfg_big.num_layers}-layer "
            f"forward with {OFFLOAD['big_stay']} layers resident, reckoned: {full:.1f} ms")
    del off, resident
    free_host()
    log(f"  [10] phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: tensor parallelism (parallel/, the forward's tp collectives)
# ---------------------------------------------------------------------------

# (b)'s two gloo ranks on the one card: llama-2-7b at full width, depth cut
# to `layers`; the verify forward of Q = the planned tree's 64 nodes over a
# `prefix`-token prefix, then a `gen`-token greedy generate. The tolerance:
# the sharded logits within `tol` of the unsharded run's largest |logit|
# (bf16 activations: each rank's partial sums round to bf16 before the
# all-reduce, and w4a8's int8 levels move with them), and greedy tokens
# equal up to the first position whose unsharded top-2 logit gap is under
# that same absolute amount.
TP_CHECK = dict(tp=2, layers=4, prefix=128, gen=32, tol=2e-2, max_length=256)
TP_FORMATS = {   # weight format -> kernels its sharded forward must launch
    "bf16": ("tree_attention",), "int8": ("quant_matmul_int8_wgmma",),
    "tiled int4": ("quant_matmul_tiled_wgmma",),
    "w4a8": ("quant_matmul_w4a8", "quantize_activations")}
# The w4a8 forward is logged beside the route's own distance from
# weight-only int4 on the same weights, not held to TP_CHECK["tol"]: at 7B
# width some activation always lies within one f32 rounding of an int8
# tie, so any other decomposition of a product (key splits, GEMM tiles, the
# partial sums) flips a level, and each flip moves the next layers'
# activations past more ties: 3.4% of max |logit| at 4 layers with bf16 x
# and 3.6% with f32 x on an H100, 60% of the route's own distance. What the
# tensor-parallel path itself adds is held apart, exactly: one row-parallel
# w4a8 layer (`tp_row_layer`).
TP_LOGGED = ("w4a8",)
TP_ROW_TOL = 1e-5   # the row layer: two f32 partial sums against one
TP_SHAPES = {   # llama-2-7b's shard shapes under tp: (K, N) of each projection kind
    "col qkvo": lambda tp: (4096, 4096 // tp), "col gate/up": lambda tp: (4096, 11008 // tp),
    "col lm_head": lambda tp: (4096, 32000 // tp), "row wo": lambda tp: (4096 // tp, 4096),
    "row w_down": lambda tp: (11008 // tp, 4096)}
TP_REPORT = ("col gate/up", "row w_down")   # shard shapes of the kernels line


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def graph_kernel_names(graph):
    """Function names of a captured graph's kernel nodes (libcuda's
    cuGraphKernelNodeGetParams and cuFuncGetName, CUDA 12.3+), or None where
    libcuda does not give them."""
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        get_name = cuda.cuFuncGetName
    except (OSError, AttributeError):
        return None
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    cuda.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    kind, names = ctypes.c_int(), []
    params = (ctypes.c_void_p * 16)()   # CUDA_KERNEL_NODE_PARAMS(_v2): the function first
    for node in nodes:
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:
            continue
        name = ctypes.c_char_p()
        if (cuda.cuGraphKernelNodeGetParams(ctypes.c_void_p(node), params) != 0
                or not params[0] or get_name(ctypes.byref(name), ctypes.c_void_p(params[0])) != 0):
            return None
        names.append(name.value.decode(errors="replace"))
    return names


def tp_graph_line(torch, engine):
    """Each captured phase's nodes and its NCCL kernel nodes."""
    out = []
    for name, g in engine._graphs.graphs.items():
        nodes, names = graph_nodes(g.graph), graph_kernel_names(g.graph)
        nccl = "?" if names is None else sum("nccl" in k.lower() for k in names)
        out.append(f"{name} {nodes['kernel']} kernels ({nccl} NCCL) {nodes['memcpy']} memcpy "
                   f"{nodes['other']} other")
    return ", ".join(out)


def tp_world1(torch, gm):
    """Phase 11 (a): an NCCL group of one rank in this process, a (1, 1)
    mesh, the bf16 llama-68m -> llama-2-7b path through `SpecEngine(mesh=...)`
    and `generate_fast`: the collectives captured into the decode graphs.
    Tokens equal to the mesh-less engine's with the same seeds, greedy and
    stochastic; each graph's kernel nodes and NCCL nodes beside the
    mesh-less ones; Sequoia ms/token with the mesh and without it (the
    difference: the collectives' nodes). Returns the mesh run's launches."""
    import numpy as np
    import torch.distributed as dist

    from sequoia_torch.cli.testbed import load_prompts
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.parallel.sharding import make_mesh, shard_params
    from sequoia_torch.utils import hard_sync

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(tp=1)
        target, tcfg, draft, dcfg = load_models(torch)
        starget = shard_params(target, mesh)
        prompts = load_prompts(FULL["prompts"], tcfg.vocab_size, SEED)
        M, T, P = FULL["max_length"], FULL["T"], FULL["P"]
        kw = dict(max_length=M, temperature=T, top_p=P, device="cuda")
        engines = {}
        for algo in ("greedy", "sequoia"):
            engines[algo] = (SpecEngine(draft, dcfg, target, tcfg, gm, algorithm=algo, **kw),
                             SpecEngine(draft, dcfg, starget, tcfg, gm, algorithm=algo,
                                        mesh=mesh, **kw))
            for e in engines[algo]:
                e.generate_fast(prompts[0], max_new_tokens=4)   # capture
        plain, meshed = engines["sequoia"]
        log(f"  graphs, mesh-less: {tp_graph_line(torch, plain)}")
        log(f"  graphs, (1, 1) NCCL mesh: {tp_graph_line(torch, meshed)}")
        for algo, (e0, e1) in engines.items():
            for i, p in enumerate(prompts):
                a = e0.generate_fast(p, max_new_tokens=64, seed=SEED + i)
                b = e1.generate_fast(p, max_new_tokens=64, seed=SEED + i)
                if len(b) <= len(p) or not np.array_equal(a, b):
                    fail(f"[11] {algo}: tokens under the NCCL mesh differ from the "
                         f"mesh-less engine's (prompt {i})")
        log("  greedy and stochastic tokens under the mesh equal the mesh-less engine's "
            f"({len(prompts)} prompts x 64 tokens each)")

        def ms_per_token(e, p, seed):
            hard_sync("cuda")
            t0 = time.perf_counter()
            e.generate_fast(p, max_new_tokens=FULL["gen"], seed=seed)
            hard_sync("cuda")
            return (time.perf_counter() - t0) * 1e3 / e.num_decoding_steps

        build.reset_launches()                 # phase 11 (a)'s main path
        times = {"mesh-less": [], "mesh": []}
        for i, p in enumerate(prompts):        # mesh-less, mesh, mesh, mesh-less
            times["mesh-less"].append(ms_per_token(plain, p, SEED + i))
            times["mesh"].append(ms_per_token(meshed, p, SEED + i))
            times["mesh"].append(ms_per_token(meshed, p, SEED + i))
            times["mesh-less"].append(ms_per_token(plain, p, SEED + i))
        counts = dict(build.launches)
        for k in ("tree_attention", "top_p_threshold_from_logits"):   # Sequoia's kernels
            if counts.get(k, 0) == 0:
                fail(f"[11] {k} never launched on the mesh path")
        a, b = (statistics.median(times[k]) for k in ("mesh-less", "mesh"))
        pre = [prefill_ms(torch, e, prompts[0]) for e in (plain, meshed, meshed, plain)]
        rep = [replay_ms(torch, e._graphs, ("grow", "verify", "finalize"))
               for e in (plain, meshed, meshed, plain)]
        rep0 = [statistics.median(r[i] for r in (rep[0], rep[3])) for i in range(3)]
        rep1 = [statistics.median(r[i] for r in (rep[1], rep[2])) for i in range(3)]
        log(f"  Sequoia ms/token ({FULL['gen']} tokens, {len(prompts)} prompts, median of "
            f"{len(times['mesh'])}): mesh-less {a:.3f}, (1, 1) NCCL mesh {b:.3f} ({b - a:+.3f}); "
            f"replay ms grow / verify / finalize: mesh-less "
            + " / ".join(f"{x:.3f}" for x in rep0) + ", mesh "
            + " / ".join(f"{x:.3f}" for x in rep1)
            + f"; eager prefill wall ms: mesh-less {pre[0]:.2f} / {pre[3]:.2f}, mesh "
            f"{pre[1]:.2f} / {pre[2]:.2f}")
        del engines, plain, meshed, target, starget, draft
        torch.cuda.empty_cache()
        return counts
    finally:
        dist.destroy_process_group()


def tp_verify_logits(torch, params, cfg, gm, tp=None, tp_size=1):
    """The logits of a verify over the planned tree (Q = its nodes) after a
    prefill of TP_CHECK["prefix"] seeded tokens, on this rank's caches."""
    from sequoia_torch.core.model import forward
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks
    from sequoia_torch.parallel.sharding import shard_config

    n, M, dt = TP_CHECK["prefix"], TP_CHECK["max_length"], params.embed.dtype
    kcfg = shard_config(cfg, tp_size) if tp is not None else cfg
    kv = KVCache.init(kcfg, M, dt, "cuda")
    scratch = KVCache.init(kcfg, gm.size, dt, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    toks = torch.randint(3, cfg.vocab_size, (n + gm.size,), generator=g, device="cuda")
    forward(params, cfg, toks[:n], torch.arange(n, device="cuda"), kv, 0,
            masks.causal_mask(n, M, 0, "cuda"), tp=tp)
    ts = n - 1
    tree = toks[n:].clone()
    tree[0] = toks[ts]
    main, scr = masks.split_tree_masks(torch.as_tensor(gm.ancestors, device="cuda"), ts, M,
                                       root_in_main=False)
    logits, _ = forward(params, cfg, tree, ts + torch.as_tensor(gm.depth, device="cuda"), kv,
                        ts, main, scratch=scratch, scratch_offset=0, scratch_mask=scr, tp=tp)
    return logits


def tp_row_layer(torch, group, tp: int, rank: int) -> dict:
    """`core/model.py::_row_parallel` of one w4a8 layer on this rank: the
    w_down shard (K 11008 / tp rows of the packed int4 weight, re-packed)
    on the same f32 rows of x as the whole layer, against the whole
    layer's `matmul` (relative to its largest |value|); with the shards'
    own row maxima beside it."""
    from sequoia_torch.core import model as model_mod
    from sequoia_torch.parallel.sharding import ROW, shard_weight
    from sequoia_torch.quant import qtensor

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    K, N = 11008, 4096
    x = torch.randn(64, K, generator=g, device="cuda")
    w = qtensor.quantize_int4(torch.randn(K, N, generator=g, device="cuda") * 0.02)
    cols = slice(rank * K // tp, (rank + 1) * K // tp)
    xs, ws = x[:, cols].contiguous(), shard_weight(w, ROW, tp, rank, K)
    qtensor.set_w4a8("on")
    ref = qtensor.matmul(x, w)
    got = model_mod._row_parallel(xs, ws, group)
    own = model_mod.all_reduce_max
    model_mod.all_reduce_max = lambda a, grp: a
    try:
        per_shard = model_mod._row_parallel(xs, ws, group)
    finally:
        model_mod.all_reduce_max = own
        qtensor.set_w4a8("off")
    top = ref.abs().max().item()
    return dict(err=(got - ref).abs().max().item() / top,
                per_shard=(per_shard - ref).abs().max().item() / top)


def tp_rank_worker(torch, rank: int, port: int, out_path: str) -> None:
    """One of phase 11 (b)'s two ranks, both on cuda:0, over gloo: each
    weight format's sharded verify forward against the unsharded one in
    this process, then a greedy generate; writes its results as JSON."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from sequoia_torch.cli.testbed import build_params, load_growmap, load_prompts
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.core.model import forward
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks
    from sequoia_torch.parallel.sharding import make_mesh, mesh_axes, shard_params
    from sequoia_torch.quant import qtensor
    from sequoia_torch.quant.quantize import random_quantized_model

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=TP_CHECK["tp"])
    out = {"rank": rank}
    probe = torch.full((4,), float(rank + 1), dtype=torch.bfloat16, device="cuda")
    try:   # the forward's collectives are f32; is bf16 taken too?
        dist.all_reduce(probe)
        out["gloo_bf16"] = bool((probe == 3).all())
    except (RuntimeError, ValueError) as e:
        out["gloo_bf16"], out["gloo_bf16_error"] = False, str(e).splitlines()[0][:200]
    mesh = make_mesh(tp=TP_CHECK["tp"])
    ax = mesh_axes(mesh)
    gm = load_growmap("planned")
    cfg = dataclasses.replace(get_config(FULL["target"]), num_layers=TP_CHECK["layers"])
    out["formats"], t_start = {}, time.perf_counter()
    for fmt in TP_FORMATS:
        qtensor.set_w4a8("on" if fmt == "w4a8" else "off")
        if fmt == "bf16":
            params = random_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
        else:   # tiled int4 and w4a8: the same int4 weights
            params = random_quantized_model(cfg, SEED, bits=8 if fmt == "int8" else 4,
                                            device="cuda")
            if fmt == "tiled int4":
                params = tile_model(params)
        ref = tp_verify_logits(torch, params, cfg, gm)
        shard = shard_params(params, mesh)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        got = tp_verify_logits(torch, shard, cfg, gm, ax.tp_group, ax.tp)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        out["formats"][fmt] = dict(
            err=(got - ref).abs().max().item(), scale=ref.abs().max().item(),
            finite=bool(torch.isfinite(got).all()), counts=dict(build.launches),
            shape=list(got.shape), wall_ms=wall)
        if fmt in TP_LOGGED:   # the route's own distance from weight-only int4
            qtensor.set_w4a8("off")
            out["formats"][fmt]["route_err"] = (
                tp_verify_logits(torch, params, cfg, gm) - ref).abs().max().item()
        del params, shard, ref, got
        torch.cuda.empty_cache()
    qtensor.set_w4a8("off")
    out["row_layer"] = tp_row_layer(torch, ax.tp_group, ax.tp, ax.tp_rank)
    out["forwards_s"] = time.perf_counter() - t_start
    t_start = time.perf_counter()
    # The greedy generate: the bf16 target (cut) sharded, the 68m draft whole.
    target = random_params(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    draft, dcfg = build_params(FULL["draft"], "random", "bf16", SEED + 1, "cuda")
    prompt = load_prompts(FULL["prompts"], cfg.vocab_size, SEED)[0]
    kw = dict(algorithm="greedy", max_length=TP_CHECK["max_length"], device="cuda")
    want = SpecEngine(draft, dcfg, target, cfg, gm, **kw).generate(
        prompt, max_new_tokens=TP_CHECK["gen"])
    build.reset_launches()
    got = SpecEngine(draft, dcfg, shard_params(target, mesh), cfg, gm, mesh=mesh, **kw).generate(
        prompt, max_new_tokens=TP_CHECK["gen"])
    out["generate_counts"] = dict(build.launches)
    n = len(want)
    kv = KVCache.init(cfg, TP_CHECK["max_length"], torch.bfloat16, "cuda")
    logits, _ = forward(target, cfg, torch.as_tensor(want, device="cuda"),
                        torch.arange(n, device="cuda"), kv, 0,
                        masks.causal_mask(n, TP_CHECK["max_length"], 0, "cuda"))
    top2 = logits.float().topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()      # row j - 1 picks token j
    out["generate"] = dict(want=np.asarray(want).tolist(), got=np.asarray(got).tolist(),
                           plen=len(prompt), gaps=gaps)
    out["generate_s"] = time.perf_counter() - t_start
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def tp_two_ranks(torch):
    """Phase 11 (b): two spawned processes on the one card, a gloo tp = 2
    group. Fails if either rank fails. Returns both ranks' launches."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    port, tp = free_port(), TP_CHECK["tp"]
    procs = []
    try:
        for r in range(tp):
            log_f = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r), str(port),
                 os.path.join(tmp, f"rank{r}.json")], stdout=log_f, stderr=subprocess.STDOUT,
                cwd=ROOT), log_f))
        deadline = time.time() + 420
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        for p, log_f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_f.close()
        for r, (p, _) in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    fail(f"[11] tp rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
        res = []
        for r in range(tp):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return tp_report(res)


def tp_report(res):
    """Phase 11 (b)'s checks and lines from the ranks' results; fails after
    printing them all if any check failed. Returns the ranks' launches."""
    r0, tp = res[0], len(res)
    log(f"  gloo takes CUDA bf16 tensors: {r0['gloo_bf16']}"
        + ("" if r0["gloo_bf16"] else f" ({r0.get('gloo_bf16_error', 'wrong sum')})")
        + "; the forward's collectives are f32 (partial sums, row maxima, logits)")
    counts, tol, problems = {}, TP_CHECK["tol"], []
    for fmt, need in TP_FORMATS.items():
        for r, out in enumerate(res):
            e = out["formats"][fmt]
            if not e["finite"] or fmt not in TP_LOGGED and e["err"] > tol * e["scale"]:
                problems.append(f"{fmt}: rank {r}'s tp={tp} verify logits {e['err']:.4g} from "
                                f"the unsharded ones (max |logit| {e['scale']:.4g}, tol {tol} "
                                "of it)")
            problems += [f"{fmt}: {k} never launched on rank {r}'s sharded forward"
                         for k in need if e["counts"].get(k, 0) == 0]
            for k, v in e["counts"].items():
                counts[k] = counts.get(k, 0) + v
        e = r0["formats"][fmt]
        held = (f"logged, not held; the route's own distance from int4 weight-only on the "
                f"same weights {e['route_err']:.4g}" if fmt in TP_LOGGED
                else f"tol {tol * e['scale']:.4g}")
        log(f"  {fmt}: tp={tp} verify logits {e['shape']} max|Δ| {e['err']:.4g} "
            f"(rank 1 {res[1]['formats'][fmt]['err']:.4g}) of max|logit| {e['scale']:.4g} "
            f"({held}); wall {e['wall_ms']:.1f} ms (gloo through the host on one card: not "
            "TP speed)")
    rows = [out["row_layer"] for out in res]
    log(f"  w4a8 row-parallel layer (w_down, K 11008 / {tp} a rank, f32 x): whole-row maxima "
        f"{max(r['err'] for r in rows):.3g} of max|y| from the unsharded layer (tol "
        f"{TP_ROW_TOL}), the shards' own maxima {min(r['per_shard'] for r in rows):.3g}")
    problems += [f"rank {r}'s w4a8 row-parallel layer {e['err']:.3g} from the unsharded one"
                 for r, e in enumerate(rows) if not e["err"] <= TP_ROW_TOL]
    g = r0["generate"]
    want, got, plen = g["want"], g["got"], g["plen"]
    if any(out["generate"]["got"] != got for out in res[1:]):
        problems.append("the two ranks committed different greedy tokens")
    limit = tol * r0["formats"]["bf16"]["scale"]
    small = next((j for j in range(plen, len(want)) if g["gaps"][j - 1] < limit), len(want))
    diff = next((j for j in range(min(len(want), len(got))) if want[j] != got[j]),
                min(len(want), len(got)))
    if diff < small and (diff < len(want) or len(got) < len(want)):
        problems.append(f"greedy tp={tp} tokens part from the unsharded ones at {diff}, "
                        f"before the first top-2 gap under {limit:.4g} (at {small})")
    log(f"  greedy generate ({TP_CHECK['gen']} tokens, tp={tp} target, whole draft): tokens "
        f"equal to the unsharded run's through position {diff} of {len(want)} (first top-2 "
        f"gap under {limit:.4g}: {'none' if small == len(want) else small}); rank 0: forwards "
        f"{r0['forwards_s']:.1f} s, generate {r0['generate_s']:.1f} s")
    if problems:
        fail("[11] " + "; ".join(problems))
    for out in res:
        for k, v in out["generate_counts"].items():
            counts[k] = counts.get(k, 0) + v
    return counts


def check_shard_qmm(torch, tp, results):
    """The quant-matmul kernels on phase 11's path at llama-2-7b's shard
    shapes under tp (TP_SHAPES) and the verify's 64 rows, against their
    plain versions, timed as phase 3 times them (weights cycled past the L2)
    beside cuBLAS on a bf16 weight of the shape; w4a8's row shards
    quantized by the whole rows' maxima, as the forward does. Then the
    quantizer alone on a row shard with those maxima."""
    from sequoia_torch.kernels import quant_matmul as qm
    from sequoia_torch.quant import qtensor

    R = 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for name in ("quant_matmul_int8_wgmma", "quant_matmul_int4_wgmma",
                 "quant_matmul_tiled_wgmma", "quant_matmul_w4a8"):
        bits, _, replaces, source, a8 = QMM_KERNELS[name]
        call, plain_call = qmm_calls(qm, name)
        for label, shape in TP_SHAPES.items():
            K, N = shape(tp)
            out_dt = torch.float32 if "lm_head" in label else torch.bfloat16
            n = max(2, -(-120_000_000 // (K * N * bits // 8)))
            ws = [torch.randn(K, N, generator=gen, device="cuda") * 0.02 for _ in range(n)]
            qts = [qtensor.quantize_int8(w) if bits == 8 else qtensor.quantize_int4(w)
                   for w in ws]
            dense = [w.to(torch.bfloat16) for w in ws[:3]]   # cuBLAS's operand
            del ws
            if "tiled" in name:
                qts = [qtensor.tile_int4(w) for w in qts]
            qs, ss = [w.q for w in qts], [w.scale for w in qts]
            x_full = torch.randn(R, K * tp, generator=gen, device="cuda").to(torch.bfloat16)
            x = x_full[:, :K].contiguous()
            amax = None
            if a8 and label.startswith("row"):
                amax = x_full.float().abs().amax(dim=-1, keepdim=True)
                kern = lambda i: qm.quant_matmul(x, qs[i], ss[i], bits=4, unpack="w4a8",  # noqa: E731
                                                 out_dtype=out_dt, amax=amax)
                plain = lambda i: qm.quant_matmul_plain(x, qs[i], ss[i], bits=4,  # noqa: E731
                                                        unpack="w4a8", out_dtype=out_dt,
                                                        amax=amax)
            else:
                kern = lambda i: call(x, qs[i], ss[i], out_dt)  # noqa: E731
                plain = lambda i: plain_call(x, qs[i], ss[i], out_dt)  # noqa: E731
            got, want = kern(0), plain(0)
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            tol = 0.0 if a8 else (2e-2 if out_dt == torch.bfloat16 else 1e-4) * peak
            if not torch.isfinite(got).all() or err > tol:
                fail(f"{name} at the tp={tp} shard {label} R={R} K={K} N={N}: max|err| "
                     f"{err:.4g} > {tol:.4g}")
            ms = device_ms([lambda i=i: kern(i) for i in range(n)])
            plain_ms = device_ms([lambda i=i: plain(i) for i in range(min(n, 3))], replays=5)
            lib_ms = device_ms([lambda i=i: torch.matmul(x, dense[i]) for i in range(len(dense))])
            bound, by = qmm_bound(R, K, N, bits, 2, got.element_size(), a8)
            whole = " (whole-row maxima)" if amax is not None else ""
            log(f"  {name} tp={tp} shard {label}: R={R} K={K} N={N}{whole} max|err| {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  cuBLAS bf16 weight {lib_ms:.4f} ms  bound "
                f"{bound:.5f} ms ({by}, {ms / bound:.2f}x)  [{n} weights cycled]")
            if label in TP_REPORT:
                results.append(dict(
                    name=name, route="cuda", source=source, replaces=replaces,
                    shape=f"tp={tp} shard {label}: R={R} K={K} N={N} x bf16 out "
                          f"{'f32' if out_dt == torch.float32 else 'bf16'}"
                          + (", whole-row maxima" if amax is not None else ""),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=lib_ms))
            del qs, ss, qts, dense
        torch.cuda.empty_cache()
    K = TP_SHAPES["row w_down"](tp)[0]
    xs = [torch.randn(R, K * tp, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(QUANT_CALLS)]
    parts = [x[:, :K].contiguous() for x in xs]
    amaxes = [x.float().abs().amax(dim=-1, keepdim=True) for x in xs]
    got, want = qm.quantize_activations(parts[0], amaxes[0]), \
        qm.quantize_activations_plain(parts[0], amaxes[0])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"quantize_activations with whole-row maxima disagrees with its plain version "
             f"at R={R} K={K}")
    ms = device_ms([lambda i=i: qm.quantize_activations(parts[i], amaxes[i])
                    for i in range(QUANT_CALLS)])
    plain_ms = device_ms([lambda i=i: qm.quantize_activations_plain(parts[i], amaxes[i])
                          for i in range(8)], replays=5)
    bound = (R * K * 3 + R * 8) / HBM_BYTES_PER_S * 1e3
    log(f"  quantize_activations tp={tp} shard R={R} K={K}, whole-row maxima: equal bits; "
        f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.5f} ms (bytes)")
    results.append(dict(
        name="quantize_activations", route="cuda", source=QMM_A8_SOURCE,
        replaces="sequoia_tpu/kernels/quant_matmul.py:361",
        shape=f"tp={tp} shard R={R} K={K} bf16, whole-row maxima", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None))


def tensor_parallel(torch, gm, results):
    """Phase 11: the kernels at (b)'s shard shapes against their plain
    versions; (a) the NCCL (1, 1) mesh in this process; (b) two gloo ranks
    on the card at tp = 2. Returns the launches of (a) and (b)."""
    tp = TP_CHECK["tp"]
    t0 = time.perf_counter()
    log(f"[11] the kernels at the tp = {tp} shard shapes against their plain versions")
    H = 32 // tp
    check_tree_attention(torch, gm, results, cases=[(
        "verify", dict(Q_rows=gm.size, layers=32, H=H, Hkv=H, D=128, M=256, S=gm.size,
                       ts=191, dtype=torch.bfloat16,
                       scratch_rows=torch.as_tensor(gm.ancestors, device="cuda")), 2e-2)],
        note=f"tp={tp} shard: ")
    check_shard_qmm(torch, tp, results)
    torch.cuda.empty_cache()
    log(f"  kernels {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    log("[11] (a) NCCL, world size 1: the bf16 7B path through SpecEngine(mesh=...)")
    counts = tp_world1(torch, gm)
    log(f"  (a) {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    log(f"[11] (b) two ranks on the one card over gloo, tp = {tp}: llama-2-7b width, "
        f"{TP_CHECK['layers']} layers")
    for k, v in tp_two_ranks(torch).items():
        counts[k] = counts.get(k, 0) + v
    log(f"  (b) {time.perf_counter() - t2:.1f} s; phase 11 {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the tools (distill and perplexity)
# ---------------------------------------------------------------------------

# bench.py's trained pair (`_bench_trained_pair`): an 8L-256h target, a
# 2L-128h draft distilled for twice the steps, on the bundled corpus at
# vocab 512; measured as bench.py measures it.
TOOLS = dict(steps=300, draft_steps=600, target_shape=(8, 256), draft_shape=(2, 128),
             seq_len=64, B=8, width=8, accept_steps=40, accept_len=192, prompts=6,
             prompt_len=24, T=0.6, P=0.9, gen=128, serve_len=256, wide_steps=20)
PPL = dict(rows=4, seq_len=256, chunk=128, small_seq_len=64, small_chunk=32)
GRAD_TOL = 1e-4      # kernel vs plain attention: each leaf within this of its max |grad|
PPL_TOL = 1e-3       # card vs CPU perplexity of the trained target: relative NLL
RANDOM_RATE = 1.928  # tokens per target step of the 7B path at random weights (PERF.md §5)
TOOLS_KERNELS = ("tree_attention_f32", "tree_attention_kv8_f32",
                 "tree_attention_kv4_head_f32", "top_p_threshold_from_logits", "tree_attention",
                 "tree_attention_kv8", "tree_attention_kv4_head", "quant_matmul_int8_wgmma",
                 "quant_matmul_int4_wgmma", "quant_matmul_int8", "quant_matmul_int4",
                 "split_bf16x3", "quant_matmul_w8a8_wgmma", "quantize_activations")


def training_counter(torch, tcfg):
    """The counter of the slot-axis attention that a training batch (B 8,
    T 64) of `tcfg` ticks: the route `sm90_route` picks (on an H100, with
    8 heads, the slot grid: 64 work items would leave half the SMs idle)."""
    from sequoia_torch.kernels import tree_attention as ta

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ta.counter("float", torch.float32, batched=True, sm90=ta.sm90_route(
        TOOLS["B"], TOOLS["seq_len"], tcfg.num_heads, tcfg.num_kv_heads, sms))


def tools_grads(torch, tcfg, data):
    """(a) One f32 batch (B = 8, T = 64) of the 8L-256h target: the loss
    and every leaf's gradient through the batched f32 kernel under autograd
    (`TreeAttentionFunction`), then with the plain attention on the card
    (the model's attention swapped for `tree_attention_batched_plain`,
    whose backward is PyTorch's autograd). Each leaf within GRAD_TOL of its
    largest |grad|; the kernel's counter must rise. Then a grad-requiring
    input to the other kernel wrappers must raise."""
    import sequoia_torch.core.model as model
    from sequoia_torch.core.init import random_params
    from sequoia_torch.kernels import build
    from sequoia_torch.kernels.quant_matmul import quant_matmul, quantize_activations
    from sequoia_torch.kernels.top_p import top_p_threshold_from_logits
    from sequoia_torch.kernels.tree_attention import tree_attention_batched_plain
    from sequoia_torch.quant.qtensor import quantize_int8
    from sequoia_torch.quant.quantize import tensors
    from sequoia_torch.tools.distill import lm_loss

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the f32 gradients must be checked in f32")
    batch = torch.as_tensor(data[:TOOLS["B"]], dtype=torch.long, device="cuda")
    res, swapped = {}, model.tree_attention_batched
    for route in ("kernel", "plain"):
        params = random_params(tcfg, SEED + 7, dtype=torch.float32, device="cuda")
        leaves = [t.requires_grad_(True) for t in tensors(params)]
        if route == "plain":
            model.tree_attention_batched = tree_attention_batched_plain
        try:
            times = []
            for _ in range(3):          # the last of three, each from zero grads
                for t in leaves:
                    t.grad = None
                build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = lm_loss(params, tcfg, batch)
                loss.backward()
                loss = loss.detach()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            model.tree_attention_batched = swapped
        res[route] = (loss.item(), [t.grad for t in leaves], times[-1],
                      build.launches[training_counter(torch, tcfg)])
        if route == "kernel":
            for t in leaves:
                t.grad = None
            traced = profile_kernels(torch, lambda: lm_loss(params, tcfg, batch).backward(),
                                     "(a) loss + backward, kernel", top=4)
            if traced is not None:
                log(f"  (a) kernel ms {traced[0]:.3f} of {times[-1] * 1e3:.2f} wall ms "
                    f"(busy share {traced[0] / (times[-1] * 1e3):.3f})")
    (lk, gk, tk, nk), (lp, gp, tp_, np_) = res["kernel"], res["plain"]
    if nk != tcfg.num_layers or np_ != 0:
        fail(f"(a) batched f32 kernel launches: {nk} with the Function (want "
             f"{tcfg.num_layers}), {np_} with the plain attention (want 0)")
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk, gp)]
    if any(g is None for g in gk + gp) or max(errs) > GRAD_TOL:
        fail(f"(a) kernel-Function gradients differ from the plain ones: {errs}")
    log(f"  (a) loss {lk:.6f} (kernel) / {lp:.6f} (plain); every leaf's gradient within "
        f"{max(errs):.2e} of its max |grad| (tolerance {GRAD_TOL:g}, {len(errs)} leaves); "
        f"loss + backward {tk * 1e3:.2f} ms (kernel, {nk} launches) / {tp_ * 1e3:.2f} ms (plain)")
    x = torch.randn(4, 256, device="cuda", requires_grad=True)
    w = quantize_int8(torch.randn(256, 128, device="cuda"))
    for name, call in (("quant_matmul", lambda: quant_matmul(x, w.q, w.scale, bits=8)),
                       ("quantize_activations", lambda: quantize_activations(x)),
                       ("top_p_threshold_from_logits",
                        lambda: top_p_threshold_from_logits(x, 0.9, 0.6))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"(a) {name} on a grad-requiring CUDA input did not raise")
    log("  (a) quant_matmul, quantize_activations and top_p on a grad-requiring CUDA input "
        "raise")


def tools_perplexity(torch, target, tcfg, target7, tcfg7):
    """(e) `evaluate` on the card: the trained f32 target against the same
    params on the CPU (f32, int8 and int4 weights, each with the float,
    int8 and int4 KV cache), then llama-2-7b (random, seeded) in bf16, int8
    (w8a8 "auto", which quantizes the activations of a 128-row chunk, and
    weight-only), int4 weights and bf16 with int8 / int4 KV on 4 c4_small
    rows."""
    import numpy as np

    from sequoia_torch.data.datasets import C4_SMALL, load_pretokenized_jsonl
    from sequoia_torch.quant import qtensor
    from sequoia_torch.quant.quantize import quantize_model
    from sequoia_torch.tools.perplexity import evaluate
    from sequoia_torch.utils import hard_sync

    ds = load_pretokenized_jsonl(C4_SMALL, seq_len=PPL["small_seq_len"], limit=PPL["rows"])
    ids = ds.ids % tcfg.vocab_size
    lines, worst, base, scored = [], 0.0, None, 0
    for bits in (None, 8, 4):
        params = target if bits is None else quantize_model(target, bits=bits)
        cpu = tree_to(params, "cpu")
        for kv in (None, "int8", "int4"):
            card = evaluate(params, tcfg, ids, ds.lengths, chunk=PPL["small_chunk"], kv_quant=kv)
            ref = evaluate(cpu, tcfg, ids, ds.lengths, chunk=PPL["small_chunk"], kv_quant=kv)
            rel = abs(card.nll - ref.nll) / ref.nll
            worst = max(worst, rel)
            if card.tokens != ref.tokens or not np.isfinite(card.nll) or rel > PPL_TOL:
                fail(f"(e) trained target, {bits or 32}-bit weights, {kv or 'float'} KV: card "
                     f"NLL {card.nll} ({card.tokens} tokens) vs CPU {ref.nll} ({ref.tokens})")
            base = card.nll if base is None else base
            scored = card.tokens
            lines.append(f"w{bits or 'f32'}/{kv or 'f32'} KV {card.nll:.5f} "
                         f"({card.nll - base:+.5f})")
    log(f"  (e) trained target NLL on the card ({scored} tokens, chunk "
        f"{PPL['small_chunk']}; delta from f32): " + ", ".join(lines)
        + f"; card vs CPU within {worst:.2e} relative (tolerance {PPL_TOL:g})")

    ds = load_pretokenized_jsonl(C4_SMALL, seq_len=PPL["seq_len"], limit=PPL["rows"])
    chunks = sum(-(-PPL["seq_len"] // PPL["chunk"]) for n in ds.lengths if n >= 2)
    evaluate(target7, tcfg7, ds.ids, ds.lengths, chunk=PPL["chunk"], limit=1)   # warm-up
    out, quantized = {}, {}
    for label, bits, kv, w8a8 in (
            ("bf16", None, None, "auto"), ("int8 (w8a8 auto)", 8, None, "auto"),
            ("int8 weight-only", 8, None, "off"), ("int4", 4, None, "auto"),
            ("bf16, int8 KV", None, "int8", "auto"), ("bf16, int4 KV", None, "int4", "auto")):
        if bits is not None and bits not in quantized:
            quantized.clear()
            torch.cuda.empty_cache()
            quantized[bits] = quantize_model(target7, bits=bits)
        params = target7 if bits is None else quantized[bits]
        qtensor.set_w8a8(w8a8)
        try:
            hard_sync("cuda")
            t0 = time.perf_counter()
            res = evaluate(params, tcfg7, ds.ids, ds.lengths, chunk=PPL["chunk"], kv_quant=kv)
            out[label] = (res, (time.perf_counter() - t0) / chunks)
        finally:
            qtensor.set_w8a8("auto")
        if not np.isfinite(res.nll):
            fail(f"(e) llama-2-7b {label}: NLL {res.nll}")
    del params
    quantized.clear()
    torch.cuda.empty_cache()
    b = out["bf16"][0].nll
    for label in ("int8 (w8a8 auto)", "int8 weight-only"):
        if abs(out[label][0].nll - b) >= 0.05 * max(b, 1.0):
            fail(f"(e) llama-2-7b {label} moved the NLL from {b} to {out[label][0].nll}")
    log(f"  (e) llama-2-7b (random weights), {out['bf16'][0].tokens} tokens of "
        f"{PPL['rows']} c4_small rows at seq_len {PPL['seq_len']}, chunk {PPL['chunk']}: "
        + ", ".join(f"{k} NLL {r.nll:.5f} ({r.nll - b:+.5f}, {(r.nll - b) / b * 100:+.3f}%), "
                    f"{ms * 1e3:.2f} ms/chunk" for k, (r, ms) in out.items()))


def tools(torch, curve=None, draft_time=None):
    """Phase 12: distill a correlated pair on the card, serve it through
    measure -> plan -> serve, and score perplexity (module doc, phase 12).
    `curve` / `draft_time`: phase 7's bf16 7B curve at PLAN_WIDTHS and the
    68m draft's forward at width 8 (None: measure a short curve at
    PHASE8_CURVE_WIDTHS and the draft here). Returns the launches of
    (b)-(e), the main paths; (a) is a comparison and not counted."""
    import numpy as np

    from sequoia_torch.cli.testbed import build_params
    from sequoia_torch.core.config import get_config
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.planner.acceptance import dynamic_acceptance
    from sequoia_torch.planner.dp import plan
    from sequoia_torch.planner.profile import time_forward_widths
    from sequoia_torch.quant.quantize import tensors
    from sequoia_torch.tools.distill import (_shape_cfg, corpus_from_reference,
                                             make_correlated_pair, train_lm)
    from sequoia_torch.utils import hard_sync

    t_phase = time.perf_counter()
    T, P, S = TOOLS["T"], TOOLS["P"], TOOLS["steps"]
    data = corpus_from_reference(vocab_size=512, seq_len=TOOLS["seq_len"])
    log("  [12] (a) gradients through the tree-attention kernel under autograd")
    tools_grads(torch, _shape_cfg(get_config("test-small"), *TOOLS["target_shape"]), data)

    build.reset_launches()     # the paths start here
    log("  [12] (b) distill the pair (make_correlated_pair)")
    report = {}
    draft, dcfg, target, tcfg = make_correlated_pair(
        steps=S, seq_len=TOOLS["seq_len"], distill_draft=True,
        target_shape=TOOLS["target_shape"], draft_shape=TOOLS["draft_shape"],
        draft_steps=TOOLS["draft_steps"], device="cuda", report=report)
    if any(t.requires_grad for t in list(tensors(target)) + list(tensors(draft))):
        fail("(b) train_lm returned params that require grad")
    for name, cfg in (("target", tcfg), ("draft", dcfg)):
        r = report[name]
        first, last = np.mean(r["losses"][:10]), np.mean(r["losses"][-10:])
        if not last < first:
            fail(f"(b) the {name}'s loss did not fall: {r['losses'][:3]} ... {r['losses'][-3:]}")
        log(f"  {name} {cfg.num_layers}L-{cfg.hidden_size}h V {cfg.vocab_size}: "
            f"{len(r['losses'])} steps, {r['seconds'] / len(r['losses']) * 1e3:.2f} ms/step, "
            f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} (mean of the first / last 10: "
            f"{first:.4f} / {last:.4f})")

    log("  [12] (c) train_lm at llama-68m's width (768, 12 heads of 64, V 32000)")
    wcfg = get_config("llama-68m")
    losses = []
    hard_sync("cuda")
    t0 = time.perf_counter()
    wide = train_lm(wcfg, corpus_from_reference(vocab_size=wcfg.vocab_size,
                                                seq_len=TOOLS["seq_len"]),
                    steps=TOOLS["wide_steps"], batch_size=TOOLS["B"], seed=SEED, device="cuda",
                    losses=losses)
    losses = torch.stack(losses).tolist()
    took = time.perf_counter() - t0
    if not np.mean(losses[-3:]) < np.mean(losses[:3]) or any(t.requires_grad
                                                              for t in tensors(wide)):
        fail(f"(c) llama-68m width: the loss did not fall or params require grad: {losses}")
    log(f"  {wcfg.num_layers}L-{wcfg.hidden_size}h: {len(losses)} steps, "
        f"{took / len(losses) * 1e3:.2f} ms/step, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    del wide

    log("  [12] (d) measure -> plan -> serve the trained pair")
    target7, tcfg7 = build_params(FULL["target"], "random", "bf16", SEED, "cuda")
    widths = PLAN_WIDTHS
    if curve is None:
        widths = PHASE8_CURVE_WIDTHS
        curve = time_forward_widths(target7, tcfg7, widths, max_length=FULL["max_length"],
                                    kv_len=128, reps=10, dtype=torch.bfloat16)
        draft0, dcfg0 = build_params(FULL["draft"], "random", "bf16", SEED + 1, "cuda")
        draft_time = time_forward_widths(draft0, dcfg0, [8], max_length=FULL["max_length"],
                                         kv_len=128, reps=20)[0]
        del draft0
        log("  bf16 7B forward: " + ", ".join(f"w{w} {t * 1e3:.3f} ms"
                                              for w, t in zip(widths, curve))
            + f"; 68m draft w8 {draft_time * 1e3:.4f} ms")
    prompts = [np.asarray(r[:TOOLS["prompt_len"]], np.int32) for r in data[:TOOLS["prompts"]]]
    t0 = time.perf_counter()
    vec = dynamic_acceptance(draft, dcfg, target, tcfg, prompts, width=TOOLS["width"],
                             steps_per_prompt=TOOLS["accept_steps"],
                             max_length=TOOLS["accept_len"], temperature=T, top_p=P)
    t_vec = time.perf_counter() - t0
    if not vec[1] > 0.15:
        fail(f"(d) the distilled draft's rank-1 child is accepted at {vec[1]} (want > 0.15)")
    pvec = np.maximum(vec, 1e-4)
    pvec[0] = 0.0
    gm, info = plan(pvec, widths, list(curve[:len(widths)]), draft_time, max_depth=8)
    eng = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia",
                     max_length=TOOLS["serve_len"], temperature=T, top_p=P, device="cuda")
    eng.generate_fast(prompts[0], max_new_tokens=4)     # warm up and capture
    hard_sync("cuda")
    tokens = steps = 0
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        out = eng.generate_fast(p, max_new_tokens=TOOLS["gen"], seed=SEED + i)
        if len(out) <= len(p) or out.min() < 0 or out.max() >= tcfg.vocab_size:
            fail(f"(d) the trained pair produced invalid tokens {out[len(p):]}")
        tokens += eng.num_decoding_steps
        steps += eng.num_large_model_steps
    hard_sync("cuda")
    wall = time.perf_counter() - t0
    rate = tokens / max(steps, 1)
    log(f"  dynamic acceptance (width {TOOLS['width']}, {TOOLS['accept_steps']} steps x "
        f"{len(prompts)} prompts of {TOOLS['prompt_len']}, T {T}) in {t_vec:.1f} s: "
        f"{np.round(vec, 4).tolist()}")
    log(f"  plan on the bf16 7B curve: {gm.size} nodes, depth {info['depth']}, level widths "
        f"{gm.level_widths}, planned E {info['expected_accepted']:.3f} tokens a step; served "
        f"(generate_fast, {len(prompts)} prompts x {TOOLS['gen']} tokens): {rate:.3f} tokens a "
        f"target step ({tokens} tokens, {steps} steps; random 7B weights {RANDOM_RATE}), "
        f"{wall / tokens * 1e3:.3f} ms/token, graphs {graph_lines(torch, eng, 'pair')}")
    if not rate > 1.15:
        fail(f"(d) the trained pair emits {rate} tokens a target step (want > 1.15)")
    del eng

    log("  [12] (e) perplexity (tools/perplexity.py::evaluate)")
    tools_perplexity(torch, target, tcfg, target7, tcfg7)
    hard_sync("cuda")
    launches = dict(build.launches)     # ... and end here
    del target7
    torch.cuda.empty_cache()
    missing = [k for k in TOOLS_KERNELS + (training_counter(torch, tcfg),)
               if launches.get(k, 0) == 0]
    if missing:
        fail(f"phase 12: {missing} never launched: {launches}")
    log(f"  phase 12 launches {({k: v for k, v in launches.items() if v})}; "
        f"{time.perf_counter() - t_phase:.1f} s")
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
    if sys.argv[1:2] == ["--tp-rank"]:   # one of phase 11 (b)'s ranks
        tp_rank_worker(torch, int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
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
    if "--tp" in sys.argv[1:]:
        counts = tensor_parallel(torch, gm, kernels)
        for e in kernels:
            e["launches"] = counts.get(e["name"], 0)
        log(f"  --tp: phase 11 only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return
    if "--tools" in sys.argv[1:]:
        log("[12] the tools: distill, measure -> plan -> serve the trained pair, perplexity")
        tools(torch)
        log(f"  --tools: phase 12 only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return
    if "--offload" in sys.argv[1:]:
        log("[10] host offload: llama-2-7b and llama-2-70b (8 layers) streamed from pinned memory")
        host_offload(torch, gm)
        log(f"  --offload: phase 10 only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return
    if "--batched" in sys.argv[1:]:
        log("[9] batched serving: llama-68m -> llama-2-7b bf16, B = 8")
        counts, batched_kernels = batched_serving(torch, gm)
        for e in batched_kernels:
            e["launches"] = counts.get(e["name"], 0)
            if e["launches"] == 0:
                fail(f"{e['name']} never launched in phase 9")
        log(f"  --batched: phase 9 only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": batched_kernels}), flush=True)
        return
    if "--plan" in sys.argv[1:]:
        log("[8] measure -> plan -> serve: llama-68m -> llama-2-7b bf16")
        measure_plan_serve(torch)
        log(f"  --plan: phase 8 only, {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        return
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
        log("[9] the batched kernels against their plain versions")
        check_batched_attention(torch, gm, kernels)
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
    log("[6] int4 weights, every projection through unpack=\"w4a8\" (qtensor.set_w4a8)")
    qtensor.set_w4a8("on")
    try:
        need = ("quant_matmul_w4a8", "quantize_activations")
        curves["int4 w4a8"], counts = width_curve(torch, models, "int4 w4a8", need=need)
    finally:
        qtensor.set_w4a8("off")
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

    log("[7] latency curves (H100, device time of one split-mode forward at kv_len 128)")
    plan_from_curves(curves, draft_time)

    log("[8] measure -> plan -> serve: llama-68m -> llama-2-7b bf16")
    add(measure_plan_serve(torch, curves["bf16"][:len(PLAN_WIDTHS)], draft_time))

    log("[9] batched serving: llama-68m -> llama-2-7b bf16, B = 8")
    counts, batched_kernels = batched_serving(torch, gm)
    add(counts)
    kernels += batched_kernels
    torch.cuda.empty_cache()

    log("[10] host offload: llama-2-7b and llama-2-70b (8 layers) streamed from pinned memory")
    add(host_offload(torch, gm, draft_time))
    torch.cuda.empty_cache()

    log("[11] tensor parallelism: the tp collectives in the decode graphs, and tp = 2")
    add(tensor_parallel(torch, gm, kernels))
    torch.cuda.empty_cache()

    log("[12] the tools: distill, measure -> plan -> serve the trained pair, perplexity")
    add(tools(torch, curves["bf16"][:len(PLAN_WIDTHS)], draft_time))

    for e in kernels:
        e["launches"] = launches.get(e["name"], 0)
        if e["launches"] == 0:
            fail(f"{e['name']} never launched on any main path")

    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
