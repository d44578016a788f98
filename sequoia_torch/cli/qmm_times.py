"""Device times of the quantized matmuls at the 7B projection shapes (and
of the f32 and the batched tree attention), for comparing two checkouts of
the port on one card.

    python3 sequoia_torch/cli/qmm_times.py [--root DIR] [--rows 1,16,64,128,256]
        [--kernels int8,w8a8,w8a8_mm,int4,tiled,w4a8,quantize,cublas_bf16,
                   int8_f32,int4_f32,tiled_f32,cublas_f32,top_p_logits,top_p_fused,
                   tree_attention_f32,sdpa_f32,tree_attention_batched,sdpa_batched]
        [--label NAME] [--reps 3]

Imports `sequoia_torch` from DIR (default: the checkout that holds this
file) and builds its kernels there, so the same script times an older
checkout: run it as parent, change, change, parent within one call to the
card, and compare only within that call. For each kernel of `--kernels`
(bf16 x but for the f32 kernels), each (K, N) of llama-2-7b's projections and lm_head
and each row count R, prints one JSON line with the device ms of one call:
the median of `--reps` runs, each a CUDA graph of calls cycling through
enough weights to exceed the 50 MB L2, replayed under CUDA events. The
kernels:
- int8: int8 weight-only, `quant_matmul(bits=8)`;
- w8a8 (or w8a8_route, the same): the quantizer and the int8-weight
  matmul as one unit, `quant_matmul_w8a8`, as `quant/qtensor.py`'s w8a8
  mode calls it;
- w8a8_mm: that matmul alone on x8 and sx quantized beforehand
  (`_launch_int8_sm90(x8, q, scale, out, sx=sx)`);
- quantize: the activation quantizer alone, `quantize_activations` (at
  (R, K), once per K; 64 calls a graph, so that its few µs, not the events
  around a replay, dominate);
- int4: packed int4, `quant_matmul(bits=4)`; tiled: `quant_matmul_tiled`;
- w4a8: the quantizer and the int4 x int8 matmul, `quant_matmul(bits=4,
  unpack="w4a8")`;
- cublas_bf16: the yardstick, torch.matmul on a dequantized bf16 weight;
- int8_f32, int4_f32, tiled_f32: the same three weight formats with f32 x
  (whatever route the checkout takes for f32 x; f32 out); cublas_f32:
  torch.matmul on a dequantized f32 weight, TF32 off;
- top_p_logits, top_p_fused: the nucleus cutoffs,
  `top_p_threshold_from_logits` and `top_p_threshold_fused` (on the
  softmax) at top_p = 0.9, at each R of `--rows` among 1 and 64 (the
  others are reported and skipped) and V in {32000, 128256}, on each kind
  of row of `TOP_P_KINDS` (16 inputs cycled; JSON lines with "V" and
  "rows" in place of K and N);
- tree_attention_f32: `tree_attention` with f32 q and a float cache
  (whatever route the checkout takes for f32), at each case of
  `ATTENTION_CASES` (H = 32, D = 128, M = 256; 8 layers cycled, past the
  L2; JSON lines with "case", "Q" and "S" in place of R, K and N);
  sdpa_f32: the yardstick, scaled_dot_product_attention in f32 over the
  concatenated main and scratch rows under the same mask (its line also
  names the device kernels of one call, from a torch.profiler trace);
- tree_attention_batched: `tree_attention_batched` (whatever route the
  checkout takes) at chip_smoke.py phase 9's batched verify (B = 8 slots,
  Q = 64 tree rows, H = 32, D = 128, M = 512, S = 64, prefixes of 40-380
  keys; 2 layers cycled, each past the L2) in bf16 and f32, every main-cache
  format (JSON lines with "case", "dtype" and "format"); sdpa_batched: the
  yardstick, scaled_dot_product_attention with a [B, 1, Q, M + S] mask over
  the float rows, per dtype.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
KERNELS = ("int8", "w8a8", "w8a8_mm", "int4", "tiled", "w4a8", "quantize", "cublas_bf16",
           "int8_f32", "int4_f32", "tiled_f32", "cublas_f32", "top_p_logits", "top_p_fused",
           "tree_attention_f32", "sdpa_f32", "tree_attention_batched", "sdpa_batched")
TOP_P = ("top_p_logits", "top_p_fused")
ATTENTION = ("tree_attention_f32", "sdpa_f32")
BATCHED = ("tree_attention_batched", "sdpa_batched")
# The 7B verify of chip_smoke.py phase 3 (the planned tree over a 191-key
# prefix), then phase 7's f32 curve at Q queries (a 128-key prefix, a causal
# scratch of Q rows).
ATTENTION_CASES = ("verify", "q1", "q16", "q64")
TOP_P_VOCABS = (32000, 128256)
# Kinds of top-p rows: logits from x ~ N(0, 1), and the temperature they are
# taken at. A random-weight model's logits have a std of about 1 ("flat":
# most of a row lies above the kernel's floor); "peaked" rows hold few
# values above it; "uniform" and "tied" rows put many values in one bin.
TOP_P_KINDS = {
    "peaked": (lambda x: x * 4, 0.6),
    "flat": (lambda x: x, 0.6),
    "flat_t1": (lambda x: x, 1.0),
    "uniform": (lambda x: x * 0, 0.6),
    "tied": (lambda x: (x * 2).round(), 0.6),
}


def top_p_logits(torch, kind, R, V, gen):
    """(logits [R, V] f32 on the card, temperature) of one kind of row."""
    make, T = TOP_P_KINDS[kind]
    return make(torch.randn(R, V, generator=gen, device="cuda")), T


def device_ms(torch, fns, replays: int = 10) -> float:
    """One call's device ms: `fns` captured once into a CUDA graph, the
    graph replayed under CUDA events, the median replay over len(fns)."""
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


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here, help="checkout whose sequoia_torch is timed")
    ap.add_argument("--rows", default="1,16,64,128,256")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("qmm_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # cublas_f32 in full f32
    sys.path.insert(0, os.path.abspath(args.root))
    from sequoia_torch.kernels import build
    from sequoia_torch.kernels import quant_matmul as qm
    from sequoia_torch.quant.qtensor import QuantizedTensor, tile_int4

    kernels = args.kernels.split(",")
    if set(kernels) - set(KERNELS) - {"w8a8_route"}:
        sys.exit(f"qmm_times: unknown kernels {set(kernels) - set(KERNELS) - {'w8a8_route'}}")
    rows = list(map(int, args.rows.split(",")))
    top_p_rows = [R for R in rows if R in (1, 64)] if set(kernels) & set(TOP_P) else []
    if set(kernels) & set(TOP_P) and len(top_p_rows) < len(rows):
        print(f"qmm_times: the top-p kernels are timed at R in {top_p_rows} only",
              file=sys.stderr)
    build.load()
    label = args.label or os.path.abspath(args.root)
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def weights(rows, N, n):
        return ([torch.randint(-128, 128, (rows, N), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(n)],
                [torch.rand(1, N, generator=gen, device="cuda") * 0.02 + 0.001
                 for _ in range(n)])

    for K, N in SHAPES if set(kernels) - set(TOP_P) - set(ATTENTION) - set(BATCHED) else ():
        # enough weights per kernel that one pass exceeds the L2
        n8, n4 = (max(2, -(-150_000_000 // nbytes)) for nbytes in (K * N, K * N // 2))
        want8 = {"int8", "w8a8", "w8a8_mm", "w8a8_route", "cublas_bf16", "int8_f32",
                 "cublas_f32"}
        want4 = {"int4", "tiled", "w4a8", "int4_f32", "tiled_f32"}
        q8, s8 = weights(K, N, n8) if want8 & set(kernels) else ([], [])
        q4, s4 = weights(K // 2, N, n4) if want4 & set(kernels) else ([], [])
        t4 = [tile_int4(QuantizedTensor(q, s)).q for q, s in zip(q4, s4)] \
            if {"tiled", "tiled_f32"} & set(kernels) else []
        deq = [(q.float() * s).to(torch.bfloat16) for q, s in zip(q8, s8)] \
            if "cublas_bf16" in kernels else []
        # f32 weights (4 B an element): fewer, still past the L2
        nf = max(2, -(-150_000_000 // (4 * K * N)))
        deq32 = [q.float() * s for q, s in zip(q8[:nf], s8)] if "cublas_f32" in kernels else []
        out = torch.float32 if N == 32000 else torch.bfloat16
        for R in rows:
            xf = torch.randn(R, K, generator=gen, device="cuda")
            x = xf.to(torch.bfloat16)
            x8, sx = qm.quantize_activations(x)
            xs = [torch.randn(R, K, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(8)]
            calls = {
                "int8": (n8, lambda i: qm.quant_matmul(x, q8[i], s8[i], bits=8, out_dtype=out)),
                "w8a8": (n8, lambda i: qm.quant_matmul_w8a8(x, q8[i], s8[i], out_dtype=out)),
                "w8a8_mm": (n8, lambda i: qm._launch_int8_sm90(x8, q8[i], s8[i], out, sx=sx)),
                "quantize": (64, lambda i: qm.quantize_activations(xs[i % len(xs)])),
                "int4": (n4, lambda i: qm.quant_matmul(x, q4[i], s4[i], bits=4, out_dtype=out)),
                "tiled": (n4, lambda i: qm.quant_matmul_tiled(x, t4[i], s4[i], out_dtype=out)),
                "w4a8": (n4, lambda i: qm.quant_matmul(x, q4[i], s4[i], bits=4, unpack="w4a8",
                                                        out_dtype=out)),
                "cublas_bf16": (n8, lambda i: torch.matmul(x, deq[i])),
                "int8_f32": (n8, lambda i: qm.quant_matmul(xf, q8[i], s8[i], bits=8)),
                "int4_f32": (n4, lambda i: qm.quant_matmul(xf, q4[i], s4[i], bits=4)),
                "tiled_f32": (n4, lambda i: qm.quant_matmul_tiled(xf, t4[i], s4[i])),
                "cublas_f32": (len(deq32), lambda i: torch.matmul(xf, deq32[i])),
            }
            calls["w8a8_route"] = calls["w8a8"]
            for name in kernels:
                if name == "quantize" and N != 4096:
                    continue   # once per K: at (4096, 4096) and (11008, 4096)
                n, call = calls[name]
                ms = statistics.median(
                    device_ms(torch, [lambda i=i: call(i) for i in range(n)])
                    for _ in range(args.reps))
                print(json.dumps({"label": label, "kernel": name, "R": R, "K": K, "N": N,
                                  "ms": round(ms, 5),
                                  "card": torch.cuda.get_device_name(0)}), flush=True)
        del q8, s8, q4, s4, t4, deq, deq32
        torch.cuda.empty_cache()
    from sequoia_torch.kernels import top_p as tp

    for V in TOP_P_VOCABS if top_p_rows else ():
        for R, kind in ((r, k) for r in top_p_rows for k in TOP_P_KINDS):
            logits, T = zip(*(top_p_logits(torch, kind, R, V, gen) for _ in range(16)))
            probs = [torch.softmax(x / T[0], dim=-1) for x in logits]
            calls = {"top_p_logits": lambda i: tp.top_p_threshold_from_logits(logits[i], 0.9,
                                                                                 T[0]),
                     "top_p_fused": lambda i: tp.top_p_threshold_fused(probs[i], 0.9)}
            for name in (k for k in kernels if k in TOP_P):
                ms = statistics.median(
                    device_ms(torch, [lambda i=i: calls[name](i) for i in range(16)])
                    for _ in range(args.reps))
                print(json.dumps({"label": label, "kernel": name, "R": R, "V": V, "rows": kind,
                                  "ms": ms, "card": torch.cuda.get_device_name(0)}), flush=True)
            del logits, probs
    for case in ATTENTION_CASES if set(kernels) & set(ATTENTION) else ():
        attention_times(torch, [k for k in kernels if k in ATTENTION], case, gen, label,
                        args.reps)
    if set(kernels) & set(BATCHED):
        batched_times(torch, [k for k in kernels if k in BATCHED], gen, label, args.reps)


def attention_times(torch, kernels, case, gen, label, reps):
    """One JSON line per kernel of `kernels` at attention case `case`."""
    from sequoia_torch.cli.testbed import load_growmap
    from sequoia_torch.kernels.tree_attention import tree_attention

    H, D, M, L = 32, 128, 256, 8
    if case == "verify":
        scr = torch.as_tensor(load_growmap("planned").ancestors, device="cuda")
        Q, ts = scr.shape[0], 191
    else:
        Q, ts = int(case[1:]), 128
        scr = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device="cuda"))
    S = scr.shape[1]
    q = torch.randn(Q, H, D, generator=gen, device="cuda")
    k, v = (torch.randn(L, M, H, D, generator=gen, device="cuda") for _ in range(2))
    sk, sv = (torch.randn(L, S, H, D, generator=gen, device="cuda") for _ in range(2))
    main = (torch.arange(M, device="cuda") < ts)[None].expand(Q, M).contiguous()
    full = torch.cat([main, scr], dim=1)
    kk = [torch.cat([k[i], sk[i]]).transpose(0, 1)[None] for i in range(L)]
    vv = [torch.cat([v[i], sv[i]]).transpose(0, 1)[None] for i in range(L)]
    qb = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {"tree_attention_f32": lambda i: tree_attention(q, k[i], v[i], main, sk[i], sv[i],
                                                            scr, scale=D ** -0.5),
             "sdpa_f32": lambda i: sdpa(qb, kk[i], vv[i], attn_mask=full, scale=D ** -0.5)}
    for name in kernels:
        ms = statistics.median(device_ms(torch, [lambda i=i: calls[name](i) for i in range(L)])
                               for _ in range(reps))
        line = {"label": label, "kernel": name, "case": case, "Q": Q, "S": S, "ms": ms,
                "card": torch.cuda.get_device_name(0)}
        if name == "sdpa_f32":
            line["device_kernels"] = device_kernels(torch, lambda: calls[name](0))
        print(json.dumps(line), flush=True)


def batched_times(torch, kernels, gen, label, reps):
    """JSON lines of the batched verify (see the module doc)."""
    from sequoia_torch.cli.testbed import load_growmap
    from sequoia_torch.kernels import tree_attention as ta
    from sequoia_torch.kvcache.cache import quantize_kv_rows, quantize_kv_rows4

    B, H, D, M, L = 8, 32, 128, 512, 2
    scr = torch.as_tensor(load_growmap("planned").ancestors, device="cuda")
    Q = S = scr.shape[0]
    ts = torch.tensor([40, 95, 150, 200, 260, 300, 330, 380], device="cuda")
    main = (torch.arange(M, device="cuda")[None, None, :] < ts[:, None, None]).expand(
        B, Q, M).contiguous()
    scr = scr.expand(B, Q, S).contiguous()
    full = torch.cat([main, scr], dim=2)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    card = torch.cuda.get_device_name(0)

    def line(**kw):
        print(json.dumps(dict(label=label, case="batched_verify", card=card, **kw)), flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, Q, H, D, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(L, B, M, H, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        sk, sv = (torch.randn(L, B, S, H, D, generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        name = str(dtype)[6:]
        if "sdpa_batched" in kernels:
            qb = q.transpose(1, 2)
            kk = [torch.cat([k[i], sk[i]], dim=1).transpose(1, 2) for i in range(L)]
            vv = [torch.cat([v[i], sv[i]], dim=1).transpose(1, 2) for i in range(L)]
            ms = statistics.median(device_ms(torch, [
                lambda i=i: sdpa(qb, kk[i], vv[i], attn_mask=full, scale=D ** -0.5)
                for i in range(L)]) for _ in range(reps))
            line(kernel="sdpa_batched", dtype=name, ms=ms)
            del kk, vv
        for fmt in ("float", "int8", "int4_head", "int4_dsplit") \
                if "tree_attention_batched" in kernels else ():
            if fmt == "float":
                km, vm, ks, vs = k, v, [None] * L, [None] * L
            else:
                quant = quantize_kv_rows if fmt == "int8" else (
                    lambda x, f=fmt: quantize_kv_rows4(x, packing=f[5:]))
                (km, ks), (vm, vs) = quant(k), quant(v)
            call = lambda i: ta.tree_attention_batched(  # noqa: E731
                q, km[i], vm[i], main, sk[i], sv[i], scr, scale=D ** -0.5, ks=ks[i], vs=vs[i])
            ms = statistics.median(device_ms(torch, [lambda i=i: call(i) for i in range(L)])
                                   for _ in range(reps))
            line(kernel="tree_attention_batched", dtype=name, format=fmt, ms=ms)
            del km, vm


def device_kernels(torch, fn):
    """Names of the device kernels one call of `fn` runs (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0})


if __name__ == "__main__":
    main()
