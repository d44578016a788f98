"""The plain reference of the Llama family: its forward in float32.

It follows the published architecture of the benchmark's models (Llama:
RMSNorm, rotary position embedding in the rotate-half convention, grouped
query attention with a causal mask, a SwiGLU MLP, a final norm and the
head), over whole sequences: no cache, no tree, no kernel, no batching. TF32
is off, so every product is a float32 product.

The weights are the benchmark's (`perfbench/gen.py`), drawn again here one
layer at a time from the run's seed and brought to the precision the
configuration serves by this file's own rule (`quant.py`). The reference
takes nothing that the program made. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from perfbench import gen
from perfbench.families.llama import PROJECTIONS, Dims
from perfbench.reference.quant import as_served


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x `[T, H, D]` at positions 0..T-1."""
    T, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, None, :]
    half = D // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention: q `[T, H, D]`, k, v `[T, Hkv, D]`."""
    T, H, D = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, 8):   # a few heads at a time keeps the scores small
        s = torch.einsum("qhd,khd->hqk", q[:, h0:h0 + 8], k[:, h0:h0 + 8]) / math.sqrt(D)
        s = s.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        out[:, h0:h0 + 8] = torch.einsum("hqk,khd->qhd", s, v[:, h0:h0 + 8])
    return out


def layer(h: torch.Tensor, w: Dict[str, torch.Tensor], dims: Dims) -> torch.Tensor:
    """One decoder layer over one sequence's hidden states `[T, E]`; norm
    weights are one."""
    T = h.shape[0]
    D = dims.head_dim
    x = rms_norm(h, dims.eps)
    q = rope((x @ w["wq"]).view(T, dims.heads, D), dims.rope_theta)
    k = rope((x @ w["wk"]).view(T, dims.kv_heads, D), dims.rope_theta)
    v = (x @ w["wv"]).view(T, dims.kv_heads, D)
    h = h + attention(q, k, v).reshape(T, dims.heads * D) @ w["wo"]
    y = rms_norm(h, dims.eps)
    return h + (torch.nn.functional.silu(y @ w["w_gate"]) * (y @ w["w_up"])) @ w["w_down"]


def logits(dims: Dims, seed: int, role: str, formats: Sequence[str],
           sequences: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
           device, controls_over: Optional[int] = None) -> List[List[torch.Tensor]]:
    """The head's logits `[len(rows[i]), V]` f32 at positions `rows[i]` of each
    token sequence, for the first weight format of `formats` (the served one)
    over every sequence and for the others (controls) over the first
    `controls_over` (default: all), computed layer by layer: each layer's
    weights are drawn once and serve every format's stream.

    Returns `out[f][i]`."""
    no_tf32()
    embed = gen.embedding(dims, seed, role, device).float()
    n_ctl = len(sequences) if controls_over is None else controls_over
    streams = [[embed[s.to(device)] for s in (sequences if f == 0 else sequences[:n_ctl])]
               for f in range(len(formats))]
    del embed
    for i in range(dims.layers):
        raw = {n: gen.projection(dims, seed, role, n, i, device) for n in PROJECTIONS}
        for f, fmt in enumerate(formats):
            w = {n: as_served(t, fmt) for n, t in raw.items()}
            streams[f] = [layer(h, w, dims) for h in streams[f]]
            del w
        del raw
    head = gen.head(dims, seed, role, device)
    out = []
    for f, fmt in enumerate(formats):
        wh = as_served(head, fmt)
        out.append([rms_norm(h[r.to(device)], dims.eps) @ wh
                    for h, r in zip(streams[f], rows)])
    return out

