"""Llama forward pass for speculative decoding.

Port of `sequoia_tpu/core/model.py::forward`. One implementation for draft
and target models.

- Layer weights are stacked with a leading `[L]` axis and stored for
  `x @ W` (`wq [L, E, H*D]`), the JAX layout, not `nn.Linear`'s transpose.
- Queries of one forward occupy a contiguous KV slot window; RoPE uses the
  logical positions while rows are stored by physical slot.
- Every float-cache attention goes through `kernels.tree_attention` (the
  CUDA kernel on the card, its plain version on the CPU), with a main mask
  and a scratch mask; write mode passes an empty scratch (S = 0).
- Norms, attention softmax and final logits are f32; projections run in the
  params dtype on `torch.matmul`.
- The caches are updated IN PLACE (JAX returned new buffers); `forward`
  still returns the cache it wrote, for the same call shape as JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .config import LlamaConfig
from ..kernels.tree_attention import tree_attention
from ..kvcache.cache import KVCache


class LayerParams(NamedTuple):
    """Per-layer weights, each with a leading `[num_layers]` axis."""

    attn_norm: torch.Tensor  # [L, E]
    wq: torch.Tensor         # [L, E, H*D]
    wk: torch.Tensor         # [L, E, Hkv*D]
    wv: torch.Tensor         # [L, E, Hkv*D]
    wo: torch.Tensor         # [L, H*D, E]
    mlp_norm: torch.Tensor   # [L, E]
    w_gate: torch.Tensor     # [L, E, F]
    w_up: torch.Tensor       # [L, E, F]
    w_down: torch.Tensor     # [L, F, E]


class LlamaParams(NamedTuple):
    embed: torch.Tensor       # [V, E]
    layers: LayerParams
    final_norm: torch.Tensor  # [E]
    lm_head: torch.Tensor     # [E, V]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_inv_freq(cfg: LlamaConfig, device="cpu") -> torch.Tensor:
    """Per-frequency-pair inverse frequencies `[D/2]` f32, with the
    Llama-3.1/3.2 "llama3" scaling when configured (HF
    `_compute_llama3_parameters` semantics)."""
    D = cfg.head_dim_
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=device) / D))
    if cfg.rope_scaling_factor is None:
        return inv_freq
    factor = cfg.rope_scaling_factor
    low = cfg.rope_scaling_low_freq_factor
    high = cfg.rope_scaling_high_freq_factor
    orig = cfg.rope_scaling_original_max_position
    wavelen = 2.0 * math.pi / inv_freq
    smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
    return (1.0 - smooth) * inv_freq / factor + smooth * inv_freq


def rope_cos_sin(position_ids: torch.Tensor, cfg: LlamaConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin `[Q, D]` (half-duplicated, llama rotate-half convention)."""
    inv_freq = rope_inv_freq(cfg, position_ids.device)
    freqs = position_ids.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [Q, H, D]; cos/sin: [Q, D]."""
    cos = cos[:, None, :].to(x.dtype)
    sin = sin[:, None, :].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


def _logits_f32(hidden: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """`hidden @ lm_head` with f32 output (JAX: preferred_element_type=f32)."""
    if hidden.dtype == torch.float32:
        return hidden @ lm_head.float()
    if hidden.device.type == "cuda":
        return torch.mm(hidden, lm_head, out_dtype=torch.float32)
    return hidden.float() @ lm_head.float()


def _window(offset, n: int, device) -> torch.Tensor:
    """Slot indices `[offset, offset + n)`; `offset` may be a device
    tensor, so the write needs no host sync."""
    return offset + torch.arange(n, device=device)


def forward(
    params: LlamaParams,
    cfg: LlamaConfig,
    tokens: torch.Tensor,         # int [Q]
    position_ids: torch.Tensor,   # int [Q]
    kv: KVCache,
    cache_offset,                 # int or 0-d tensor: slots [offset, offset+Q)
    attn_mask: torch.Tensor,      # bool [Q, max_length]; True = attend
    scratch: Optional[KVCache] = None,   # [L, S, Hkv, D] tree scratch
    scratch_offset: Optional[int] = None,  # queries' slots within the scratch
    scratch_mask: Optional[torch.Tensor] = None,  # bool [Q, S]
):
    """Returns (`logits` f32 `[Q, vocab]`, the cache-or-scratch written).

    Two write modes, as in JAX:
    - `scratch is None` (prefill / AR / bonus re-draft): new K/V rows go
      into the MAIN cache at `[cache_offset, cache_offset+Q)`.
    - `scratch` given (tree grow / verify / AR step): the main cache is
      READ-ONLY; new rows go into the scratch at `[scratch_offset, +Q)`
      and attention runs over main ∪ scratch with the pair of masks.
    """
    if not isinstance(kv, KVCache) or not isinstance(params.layers, LayerParams):
        raise NotImplementedError(
            "only float KV caches and device-resident LayerParams are ported")
    Q = tokens.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    scale = D ** -0.5
    split = scratch is not None
    dev = tokens.device
    lp = params.layers

    hidden = params.embed[tokens]  # [Q, E]
    cos, sin = rope_cos_sin(position_ids, cfg)
    attn_mask = attn_mask.contiguous()
    if split:
        scr_mask = scratch_mask.contiguous()
        rows = _window(scratch_offset, Q, dev)
    else:
        rows = _window(cache_offset, Q, dev)
        # Write mode: an empty scratch region.
        empty = kv.k.new_zeros((0, Hkv, D))
        scr_mask = torch.zeros((Q, 0), dtype=torch.bool, device=dev)

    for i in range(cfg.num_layers):
        x = rms_norm(hidden, lp.attn_norm[i], cfg.rms_norm_eps)
        q = (x @ lp.wq[i]).reshape(Q, H, D)
        k = (x @ lp.wk[i]).reshape(Q, Hkv, D)
        v = (x @ lp.wv[i]).reshape(Q, Hkv, D)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_cache, v_cache = kv.k[i], kv.v[i]  # [M, Hkv, D] views
        if split:
            sk, sv = scratch.k[i], scratch.v[i]
            sk.index_copy_(0, rows, k.to(sk.dtype))  # in place
            sv.index_copy_(0, rows, v.to(sv.dtype))
        else:
            k_cache.index_copy_(0, rows, k.to(k_cache.dtype))  # in place
            v_cache.index_copy_(0, rows, v.to(v_cache.dtype))
            sk = sv = empty
        attn = tree_attention(q.contiguous(), k_cache, v_cache, attn_mask,
                              sk, sv, scr_mask, scale=scale)
        hidden = hidden + attn.reshape(Q, H * D) @ lp.wo[i]

        y = rms_norm(hidden, lp.mlp_norm[i], cfg.rms_norm_eps)
        mlp = (torch.nn.functional.silu(y @ lp.w_gate[i]) * (y @ lp.w_up[i])) @ lp.w_down[i]
        hidden = hidden + mlp

    hidden = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    logits = _logits_f32(hidden, params.lm_head)
    return logits, (scratch if split else kv)
