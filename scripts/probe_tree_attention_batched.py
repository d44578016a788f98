#!/usr/bin/env python3
"""Where the time of the slot-axis tree attention goes on one CUDA card:
the Hopper kernel (`_launch_sm90`) beside tree_attention.cu's slot-grid route
(`_launch`) on the same inputs, at 7B widths (H = Hkv = 32, D = 128, Q = 64
rows a slot, no scratch), every slot attending a prefix of M - 1 keys, for
B in {1, 2, 4, 8} slots (32 work items a slot) and M in {64, 512, 1024,
4096}: where the two routes cross as the work items fill the card (the
route `sm90_route` picks is on each line), and past the mask bits a block
keeps whole (M = 4096: each tile's scanned by the producers). bf16 and
f32, float and int8 caches. Device ms of one call:
the median of 3 CUDA-graph replays of 4 calls each (cycled layers), CUDA
events; each line also gives the kernel's max |error| against
`tree_attention_batched_plain`.

    python3 scripts/probe_tree_attention_batched.py
"""

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from sequoia_torch.cli.qmm_times import device_ms  # noqa: E402
from sequoia_torch.kernels import tree_attention as ta  # noqa: E402
from sequoia_torch.kvcache.cache import quantize_kv_rows  # noqa: E402

H, D, L, Q = 32, 128, 4, 64


def run(gen, dtype, fmt, B, M):
    q = torch.randn(B, Q, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(L, B, M, H, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(L, B, M, H, D, generator=gen, device="cuda").to(dtype)
    sk = torch.zeros(L, B, 0, H, D, device="cuda", dtype=dtype)
    ks = vs = [None] * L
    if fmt == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    main = (torch.arange(M, device="cuda")[None, None, :] < M - 1).expand(B, Q, M).contiguous()
    scr = torch.ones(B, Q, 0, dtype=torch.bool, device="cuda")
    name = ta.counter(fmt, dtype, batched=True, sm90=True)
    sm90 = lambda i: ta._launch_sm90(q, k[i], v[i], main, sk[i], sk[i], scr, ks[i], vs[i],  # noqa: E731
                                     fmt, D ** -0.5, B, Q, H, H, D, M, 0, name)
    grid = lambda i: ta._launch(q, k[i], v[i], main, sk[i], sk[i], scr, ks[i], vs[i], fmt,  # noqa: E731
                                D ** -0.5, B, Q, H, H, D, M, 0, ta.counter(fmt, dtype, True))
    t = [statistics.median(device_ms(torch, [lambda i=i: f(i) for i in range(L)])
                           for _ in range(3)) for f in (sm90, grid)]
    want = ta.tree_attention_batched_plain(q, k[0], v[0], main, sk[0], sk[0], scr,
                                           scale=D ** -0.5, ks=ks[0], vs=vs[0])
    err = (sm90(0).float() - want.float()).abs().max().item()
    route = "sm90" if ta.sm90_route(B, Q, H, H, ta._sm_count(0)) else "slot grid"
    print(f"{str(dtype)[6:]} {fmt} B={B} M={M}: sm90 {t[0]:.4f} ms, "
          f"slot grid {t[1]:.4f} ms, max|err| {err:.2g}; rule: {route}", flush=True)
    del q, k, v, ks, vs
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_tree_attention_batched: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip() or torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, fmt in ((torch.bfloat16, "float"), (torch.bfloat16, "int8"),
                       (torch.float32, "float"), (torch.float32, "int8")):
        for B in (1, 2, 4, 8):
            for M in (64, 512, 1024, 4096):
                run(gen, dtype, fmt, B, M)


if __name__ == "__main__":
    main()
