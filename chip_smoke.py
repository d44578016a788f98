#!/usr/bin/env python3
"""Chip smoke test of sequoia_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from sequoia_torch/csrc (nvcc);
  3. kernels: each kernel against its plain PyTorch version at the shapes
     of the main path, with device times (CUDA graphs of many launches,
     timed with CUDA events), the least time the card could take, and the
     time of one PyTorch library call where one computes the same function;
  4. small parity: test-small, f32, on the card: greedy speculative
     decoding equals greedy AR token for token, the kernel forward equals
     the CPU forward, and all four algorithms run;
  5. full width: llama-68m -> llama-2-7b, bf16, random weights (seeded),
     the planned 64-node growmap, max_length 256, 4 synthetic 128-token
     prompts, T=0.6, P=0.9: the stochastic AR baseline and Sequoia through
     the testbed's entry points, with launch counts of every kernel.

Prints the kernels JSON line and the card line before the last line, and
ends with one JSON line {"ok": true, "device": {...}}. Exits non-zero,
printing no result, when there is no CUDA card or no sequoia_torch beside
this file.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

SEED = 1234
FULL = dict(draft="llama-68m", target="llama-2-7b", max_length=256,
            prompts="synthetic:4,128", gen=128, T=0.6, P=0.9)


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


def device_ms(fns, replays: int = 25) -> float:
    """Device time of one call, in ms: the calls in `fns` are captured once
    into a CUDA graph (no host gaps between launches), the graph is
    replayed `replays` times under CUDA events, and the median replay is
    divided by len(fns)."""
    import torch

    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
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


def attention_bound(q, main, scr, D, H, Hkv, itemsize):
    """Least time for the data: the K/V rows some query attends, q, the
    masks and the output move once; 4*D flops per live (query head, key)."""
    main_rows = int(main.any(dim=0).sum())
    scr_rows = int(scr.any(dim=0).sum())
    nbytes = (2 * q.numel() * itemsize
              + 2 * (main_rows + scr_rows) * Hkv * D * itemsize
              + main.numel() + scr.numel())
    flops = 4 * D * H * (int(main.sum()) + int(scr.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bf16" if itemsize == 2 else "f32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_tree_attention(torch, gm, results):
    from sequoia_torch.kernels.tree_attention import tree_attention, tree_attention_plain

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
    for lvl, (w, m) in enumerate(draft_scr):
        cases.append((f"grow_68m_l{lvl}", dict(Q_rows=w, layers=2, H=12, Hkv=12, D=64,
                                               M=256, S=gm.size, ts=ts + 1,
                                               dtype=torch.bfloat16, scratch_rows=m), 2e-2))
    entry = None
    for name, kw, tol in cases:
        q, k, v, main, sk, sv, scr = attention_case(torch, gen=gen, **kw)
        L, D, H, Hkv = kw["layers"], kw["D"], kw["H"], kw["Hkv"]
        scale = D ** -0.5
        got = tree_attention(q, k[0], v[0], main, sk[0], sv[0], scr, scale=scale)
        want = tree_attention_plain(q, k[0], v[0], main, sk[0], sv[0], scr, scale=scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        if not ok or not torch.isfinite(got).all():
            fail(f"tree_attention[{name}] disagrees with its plain version: "
                 f"max |err| {err} (tol {tol})")
        kern = [lambda i=i: tree_attention(q, k[i], v[i], main, sk[i], sv[i], scr, scale=scale)
                for i in range(L)]
        plain = [lambda i=i: tree_attention_plain(q, k[i], v[i], main, sk[i], sv[i], scr,
                                                  scale=scale) for i in range(L)]
        if H == Hkv:
            qb = q.transpose(0, 1)[None]                       # [1, H, Q, D]
            kk = [torch.cat([k[i], sk[i]]).transpose(0, 1)[None] for i in range(L)]
            vv = [torch.cat([v[i], sv[i]]).transpose(0, 1)[None] for i in range(L)]
            full_mask = torch.cat([main, scr], dim=1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = [lambda i=i: sdpa(qb, kk[i], vv[i], attn_mask=full_mask, scale=scale)
                   for i in range(L)]
            lib_ms = device_ms(lib)
        else:
            lib_ms = None
        ms, plain_ms = device_ms(kern), device_ms(plain)
        itemsize = 2 if kw["dtype"] == torch.bfloat16 else 4
        bound, by = attention_bound(q, main, scr, D, H, Hkv, itemsize)
        log(f"  tree_attention[{name}] Q={q.shape[0]} H={H} Hkv={Hkv} D={D} M={main.shape[1]} "
            f"S={scr.shape[1]} {str(kw['dtype'])[6:]}: max|err| {err:.3g} (tol {tol}) "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
            f"  bound {bound:.5f} ms ({by})")
        if name == "verify":
            entry = dict(name="tree_attention", route="cuda",
                         source="sequoia_torch/csrc/tree_attention.cu",
                         replaces="sequoia_tpu/kernels/tree_attention.py:111",
                         shape=f"verify Q={q.shape[0]} H={H} D={D} M={main.shape[1]} "
                               f"S={scr.shape[1]} bf16",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=lib_ms)
    results.append(entry)


def top_p_bound(R, V, from_logits):
    nbytes = R * V * 4 + R * 4
    # per element: softmax ~4 ops (from logits), 32 bisection passes of
    # compare+add, 4 resolution passes of ~2 ops
    ops = R * V * ((4 if from_logits else 0) + 32 * 2 + 4 * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["f32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_top_p(torch, gm, results):
    from sequoia_torch.kernels import top_p as tp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    V, T = 32000, FULL["T"]
    specs = [("top_p_threshold_from_logits", gm.size, True,
              "sequoia_tpu/kernels/top_p.py:99"),
             ("top_p_threshold_fused", 1, False, "sequoia_tpu/kernels/top_p.py:140"),
             ("top_p_threshold_fused", gm.size, False, "sequoia_tpu/kernels/top_p.py:140")]
    for name, R, from_logits, replaces in specs:
        worst, flips = 0.0, 0
        for top_p in (0.5, 0.9, 0.99):
            logits = torch.randn(R, V, generator=gen, device="cuda") * 4
            probs = torch.softmax(logits / T, dim=-1)
            if from_logits:
                got = tp.top_p_threshold_from_logits(logits, top_p, T)
                want = tp.top_p_threshold_from_logits_plain(logits, top_p, T)
            else:
                got = tp.top_p_threshold_fused(probs, top_p)
                want = tp.top_p_threshold_plain(probs, top_p)
            torch.cuda.synchronize()
            try:
                flips += tp.boundary_disagreements(probs, got, want, top_p)
            except ValueError as e:
                fail(f"{name} R={R} top_p={top_p}: nuclei differ: {e}")
            same = ((probs >= got[:, None]) == (probs >= want[:, None])).all(dim=1)
            dt = torch.where(same, (got - want).abs(), 0.0).max().item()
            if dt > 1e-6:
                fail(f"{name} R={R} top_p={top_p}: |dt| {dt} on a row with the same nucleus")
            worst = max(worst, dt)
        top_p = FULL["P"]
        xs = [torch.randn(R, V, generator=gen, device="cuda") * 4 for _ in range(16)]
        if from_logits:
            kern = [lambda x=x: tp.top_p_threshold_from_logits(x, top_p, T) for x in xs]
            plain = [lambda x=x: tp.top_p_threshold_from_logits_plain(x, top_p, T) for x in xs]
        else:
            xs = [torch.softmax(x / T, dim=-1) for x in xs]
            kern = [lambda x=x: tp.top_p_threshold_fused(x, top_p) for x in xs]
            plain = [lambda x=x: tp.top_p_threshold_plain(x, top_p) for x in xs]
        ms, plain_ms = device_ms(kern), device_ms(plain)
        bound, by = top_p_bound(R, V, from_logits)
        log(f"  {name} R={R} V={V}: max|dt| {worst:.3g} on rows with the same nucleus, "
            f"{flips} of {3 * R} rows differ only at an ill-conditioned boundary token; "
            f"kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  bound {bound:.5f} ms ({by})")
        if not any(e["name"] == name for e in results):
            results.append(dict(name=name, route="cuda", source="sequoia_torch/csrc/top_p.cu",
                                replaces=replaces, shape=f"R={R} V={V} f32",
                                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by, library_ms=None))


# ---------------------------------------------------------------------------
# Phase 4: small parity on the card
# ---------------------------------------------------------------------------

def small_parity(torch):
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.core.model import LayerParams, LlamaParams, forward
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks
    from sequoia_torch.trees.growmap import uniform_tree
    import numpy as np

    cfg = get_config("test-small")
    draft = random_params(cfg, 7, dtype=torch.float32, device="cuda")
    target = random_params(cfg, 8, dtype=torch.float32, device="cuda")

    # Kernel forward (card) == plain forward (CPU), prefill then verify.
    to_cpu = lambda p: LlamaParams(p.embed.cpu(), LayerParams(*(x.cpu() for x in p.layers)),
                                   p.final_norm.cpu(), p.lm_head.cpu())
    target_cpu = to_cpu(target)
    worst = 0.0
    for dev, params in (("cuda", target), ("cpu", target_cpu)):
        kv = KVCache.init(cfg, 64, torch.float32, dev)
        toks = torch.arange(10, 42, device=dev)
        pos = torch.arange(32, device=dev)
        lg1, _ = forward(params, cfg, toks, pos, kv, 0, masks.causal_mask(32, 64, 0, dev))
        anc = torch.as_tensor(uniform_tree(2, 2).ancestors, device=dev)
        main, scr = masks.split_tree_masks(anc, 32, 64, root_in_main=False)
        scratch = KVCache.init(cfg, anc.shape[0], torch.float32, dev)
        lg2, _ = forward(params, cfg, toks[:anc.shape[0]], 32 + torch.as_tensor(
            uniform_tree(2, 2).depth, device=dev), kv, 32, main, scratch=scratch,
            scratch_offset=0, scratch_mask=scr)
        if dev == "cuda":
            ref = (lg1.cpu(), lg2.cpu())
        else:
            for a, b in zip(ref, (lg1, lg2)):
                worst = max(worst, (a - b).abs().max().item())
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                    fail(f"test-small forward on the card differs from the CPU: {worst}")
    log(f"  forward card vs CPU (test-small f32, prefill + verify): max|err| {worst:.3g}")

    gm = uniform_tree(3, 2)
    rng = np.random.default_rng(3)
    for trial in range(3):
        prompt = rng.integers(3, cfg.vocab_size, size=9 + trial)
        ar = ARBaseline(target, cfg, max_length=128, greedy=True, prefill_chunk=16,
                        device="cuda")
        exp = ar.generate(prompt, max_new_tokens=40)
        eng = SpecEngine(draft, cfg, target, cfg, gm, algorithm="greedy",
                         max_length=128, prefill_chunk=16, device="cuda")
        got = eng.generate(prompt, max_new_tokens=40, seed=trial)
        n = min(len(exp), len(got))
        if n <= len(prompt) or not np.array_equal(exp[:n], got[:n]):
            fail(f"greedy spec != greedy AR on the card (trial {trial}):\n{exp}\n{got}")
    log("  greedy spec == greedy AR, token for token (test-small f32, 3 prompts x 40 tokens)")
    for algo in ("sequoia", "specinfer", "greedy", "greedys"):
        eng = SpecEngine(draft, cfg, target, cfg, gm, algorithm=algo, max_length=128,
                         temperature=0.7, top_p=0.9, prefill_chunk=16, device="cuda")
        out = eng.generate(np.arange(5, 14), max_new_tokens=30, seed=1)
        if len(out) <= 9 or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{algo} produced invalid output {out}")
        log(f"  {algo}: {len(out) - 9} tokens in {eng.num_large_model_steps} target steps")


# ---------------------------------------------------------------------------
# Phase 5: full width through the testbed's entry points
# ---------------------------------------------------------------------------

def profile_kernels(torch, fn, label, top=8):
    """Device kernel time (ms) of `fn` from a torch.profiler trace, with
    the largest kernels printed; None when the trace holds no device time
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
    total_ms = sum(r[1] for r in rows) / 1e3
    if not rows:
        log(f"  {label}: the profiler trace holds no device time (busy share not measured)")
        return None
    log(f"  {label} trace: {total_ms:.3f} kernel ms in {sum(r[2] for r in rows)} kernels; top: "
        + "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{n}" for k, t, n in rows[:top]))
    return total_ms


def full_width(torch, gm):
    from sequoia_torch.cli.testbed import build_params, load_prompts
    from sequoia_torch.core.model import forward
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kernels import build
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks
    from sequoia_torch.utils import hard_sync

    t0 = time.perf_counter()
    target, tcfg = build_params(FULL["target"], "random", "bf16", SEED, "cuda")
    draft, dcfg = build_params(FULL["draft"], "random", "bf16", SEED + 1, "cuda")
    hard_sync("cuda")
    log(f"  random weights on the card: {time.perf_counter() - t0:.1f} s")
    prompts = load_prompts(FULL["prompts"], tcfg.vocab_size, SEED)
    M, gen, T, P = FULL["max_length"], FULL["gen"], FULL["T"], FULL["P"]
    ar = ARBaseline(target, tcfg, max_length=M, temperature=T, top_p=P, device="cuda")
    eng = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia", max_length=M,
                     temperature=T, top_p=P, device="cuda")

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
            fail(f"non-finite {name}")
    ar.generate(prompts[0], max_new_tokens=4)            # warm up
    eng.generate(prompts[0], max_new_tokens=4)

    build.reset_launches()                               # the main path starts here
    ar_tokens, t_ar = 0, 0.0
    for i, p in enumerate(prompts):
        hard_sync("cuda")
        t0 = time.perf_counter()
        out = ar.generate(p, max_new_tokens=gen, seed=SEED + i)
        hard_sync("cuda")
        t_ar += time.perf_counter() - t0
        ar_tokens += len(out) - len(p)
        if out.min() < 0 or out.max() >= tcfg.vocab_size:
            fail("AR produced out-of-range tokens")
    ar_launches = dict(build.launches)
    sq_tokens, sq_steps, t_sq = 0, 0, 0.0
    for i, p in enumerate(prompts):
        hard_sync("cuda")
        t0 = time.perf_counter()
        out = eng.generate(p, max_new_tokens=gen, seed=SEED + i)
        hard_sync("cuda")
        t_sq += time.perf_counter() - t0
        sq_tokens += eng.num_decoding_steps
        sq_steps += eng.num_large_model_steps
        if len(out) <= len(p) or out.min() < 0 or out.max() >= tcfg.vocab_size:
            fail("sequoia produced no or out-of-range tokens")
    launches = dict(build.launches)                      # ... and ends here
    sq_launches = {k: launches[k] - ar_launches[k] for k in launches}

    phases, b_steps = {}, 0
    for i, p in enumerate(prompts):
        _, tot = eng.generate_benchmark(p, max_new_tokens=gen, seed=SEED + i)
        b_steps += eng.num_large_model_steps
        for k, v in tot.items():
            phases[k] = phases.get(k, 0.0) + v

    # Device busy share: kernel time from a torch.profiler trace of one
    # more run (the profiler does not change device times) over the wall
    # time of the unprofiled runs above.
    n_ar = []
    ar_dev = profile_kernels(torch, lambda: n_ar.append(
        len(ar.generate(prompts[0], 32, seed=SEED)) - len(prompts[0])), "AR")
    sq_dev = profile_kernels(torch, lambda: eng.generate(prompts[0], 32, seed=SEED), "sequoia")
    if ar_dev is not None and sq_dev is not None:
        log(f"  device busy share: AR {ar_dev / n_ar[0] / (t_ar / ar_tokens * 1e3):.3f}, "
            f"sequoia {sq_dev / eng.num_large_model_steps / (t_sq / sq_steps * 1e3):.3f} "
            f"(kernel ms per token / iteration over wall ms)")

    # One forward reads every weight once, but only Q rows of the embedding.
    weight_bytes = sum(x.numel() * x.element_size() for x in
                       (target.final_norm, target.lm_head, *target.layers))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    ar_ms = t_ar / ar_tokens * 1e3
    sq_ms = t_sq / sq_tokens * 1e3
    log(f"  AR (stochastic, T={T} P={P}): {ar_tokens} tokens, {ar_ms:.3f} ms/token "
        f"(bf16 weight stream bound {bound_ms:.3f} ms/forward, {weight_bytes / 1e9:.2f} GB)")
    log(f"  sequoia: {sq_tokens} tokens in {sq_steps} iterations, {sq_ms:.3f} ms/token, "
        f"iteration {t_sq / sq_steps * 1e3:.3f} ms, accepted tokens per target step "
        f"{sq_tokens / sq_steps:.3f}, speedup vs AR {ar_ms / sq_ms:.3f}x")
    log("  generate_benchmark phases (device ms per iteration, CUDA events): " + ", ".join(
        f"{k} {v / b_steps * 1e3:.3f}" for k, v in phases.items()))
    log(f"  launches: AR {ar_launches}; sequoia {sq_launches} "
        f"(per iteration: " + ", ".join(f"{k} {v / sq_steps:.1f}" for k, v in
                                        sq_launches.items()) + ")")
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
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
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line and "0 bytes spill" not in line:
            log("  ptxas: " + line.split(":", 1)[-1].strip())

    gm = load_growmap("planned")
    log(f"  planned growmap: {gm.size} nodes, depth {int(gm.depth.max())}, "
        f"max branch {gm.max_branch}, level widths {gm.level_widths}")

    log("[3] kernels vs plain versions")
    kernels = []
    check_tree_attention(torch, gm, kernels)
    check_top_p(torch, gm, kernels)

    log("[4] small parity on the card")
    small_parity(torch)

    log("[5] full width: llama-68m -> llama-2-7b bf16")
    launches = full_width(torch, gm)
    for e in kernels:
        e["launches"] = launches[e["name"]]

    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
