"""Llama forward pass for speculative decoding.

Port of `sequoia_tpu/core/model.py::forward`. One implementation for draft
and target models.

- Layer weights are stacked with a leading `[L]` axis and stored for
  `x @ W` (`wq [L, E, H*D]`), the JAX layout, not `nn.Linear`'s transpose.
- Queries of one forward occupy a contiguous KV slot window; RoPE uses the
  logical positions while rows are stored by physical slot.
- Every attention goes through `kernels.tree_attention` (the CUDA kernel on
  the card, its plain version on the CPU), with a main mask and a scratch
  mask; write mode passes an empty scratch (S = 0). The main cache is a
  float `KVCache`, or an int8 `KVCache8` / int4 `KVCache4` whose rows the
  kernel reads as integers with their per-row scales; write mode quantizes
  the new rows into the cache before attention, split mode leaves it
  read-only. The scratch is always float.
- Norms, attention softmax and final logits are f32. Every projection and
  the lm_head go through `quant.qtensor.matmul`: a float weight runs in the
  params dtype on `torch.matmul`, an int8 / packed-int4 `QuantizedTensor`
  through the fused dequant-matmul kernel (`kernels.quant_matmul`).
- The caches are updated IN PLACE (JAX returned new buffers); `forward`
  still returns the cache it wrote, for the same call shape as JAX.

`forward_batched` is the same forward over a slot axis (JAX vmaps
`forward` in `sequoia_tpu/engine/batched.py`): B independent requests,
each with its own cache (the batched caches of `kvcache/cache.py`), its
own offsets and masks. The projections and the head run once on the B x Q
rows, one weight stream for every slot; attention is one launch of the
batched tree-attention kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .config import LlamaConfig
from ..kernels.tree_attention import tree_attention, tree_attention_batched
from ..quant.qtensor import WeightLike, layer, matmul
from ..kvcache.cache import KVCache, KVCache4, KVCache8, slot_rows


class LayerParams(NamedTuple):
    """Per-layer weights, each with a leading `[num_layers]` axis."""

    attn_norm: torch.Tensor  # [L, E]
    wq: WeightLike           # [L, E, H*D]
    wk: WeightLike           # [L, E, Hkv*D]
    wv: WeightLike           # [L, E, Hkv*D]
    wo: WeightLike           # [L, H*D, E]
    mlp_norm: torch.Tensor   # [L, E]
    w_gate: WeightLike       # [L, E, F]
    w_up: WeightLike         # [L, E, F]
    w_down: WeightLike       # [L, F, E]


class LlamaParams(NamedTuple):
    embed: torch.Tensor       # [V, E]
    layers: LayerParams
    final_norm: torch.Tensor  # [E]
    lm_head: WeightLike       # [E, V]


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
    if not isinstance(kv, (KVCache, KVCache8, KVCache4)):
        raise TypeError(f"forward: unknown KV cache {type(kv).__name__}")
    if not isinstance(params.layers, LayerParams):
        raise NotImplementedError("only device-resident LayerParams are ported")
    quantized_kv = not isinstance(kv, KVCache)
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
        # Write mode: an empty scratch region, in the compute dtype.
        empty = hidden.new_zeros((0, Hkv, D))
        scr_mask = torch.zeros((Q, 0), dtype=torch.bool, device=dev)

    for i in range(cfg.num_layers):
        x = rms_norm(hidden, lp.attn_norm[i], cfg.rms_norm_eps)
        q = matmul(x, layer(lp.wq, i)).reshape(Q, H, D)
        k = matmul(x, layer(lp.wk, i)).reshape(Q, Hkv, D)
        v = matmul(x, layer(lp.wv, i)).reshape(Q, Hkv, D)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_cache, v_cache = kv.k[i], kv.v[i]  # one layer's rows, views
        if split:
            sk, sv = scratch.k[i], scratch.v[i]
            sk.index_copy_(0, rows, k.to(sk.dtype))  # in place
            sv.index_copy_(0, rows, v.to(sv.dtype))
        else:
            if quantized_kv:
                kv.write_rows(i, rows, k, v)  # quantized, in place
            else:
                k_cache.index_copy_(0, rows, k.to(k_cache.dtype))  # in place
                v_cache.index_copy_(0, rows, v.to(v_cache.dtype))
            sk = sv = empty
        attn = tree_attention(q.contiguous(), k_cache, v_cache, attn_mask,
                              sk, sv, scr_mask, scale=scale,
                              ks=kv.ks[i] if quantized_kv else None,
                              vs=kv.vs[i] if quantized_kv else None)
        hidden = hidden + matmul(attn.reshape(Q, H * D), layer(lp.wo, i))

        y = rms_norm(hidden, lp.mlp_norm[i], cfg.rms_norm_eps)
        gate = torch.nn.functional.silu(matmul(y, layer(lp.w_gate, i)))
        mlp = matmul(gate * matmul(y, layer(lp.w_up, i)), layer(lp.w_down, i))
        hidden = hidden + mlp

    hidden = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    logits = matmul(hidden, params.lm_head, out_dtype=torch.float32)
    return logits, (scratch if split else kv)


def forward_batched(
    params: LlamaParams,
    cfg: LlamaConfig,
    tokens: torch.Tensor,         # int [B, Q]
    position_ids: torch.Tensor,   # int [B, Q]
    kv,                           # batched cache [L, B, M, ...]
    cache_offset: torch.Tensor,   # int [B]: slot b writes [offset_b, offset_b + Q)
    attn_mask: torch.Tensor,      # bool [B, Q, M]
    scratch: Optional[KVCache] = None,      # batched [L, B, S, Hkv, D]
    scratch_offset: Optional[int] = None,   # queries' rows within each slot's scratch
    scratch_mask: Optional[torch.Tensor] = None,  # bool [B, Q, S]
):
    """`forward` of B slots at once: returns (`logits` f32 `[B, Q, vocab]`,
    the cache-or-scratch written). The two write modes of `forward`, per
    slot; a write-mode window past a slot's end is cut to its last row
    (`kvcache.cache.slot_rows`: a predicated no-op slot of the batched
    engine may sit at the end of its buffer)."""
    if not isinstance(kv, (KVCache, KVCache8, KVCache4)) or kv.batch is None:
        raise TypeError("forward_batched: needs a batched KV cache")
    if not isinstance(params.layers, LayerParams):
        raise NotImplementedError("only device-resident LayerParams are ported")
    quantized_kv = not isinstance(kv, KVCache)
    B, Q = tokens.shape
    R = B * Q
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    scale = D ** -0.5
    split = scratch is not None
    dev = tokens.device
    lp = params.layers

    hidden = params.embed[tokens.reshape(-1)]  # [B*Q, E]
    cos, sin = rope_cos_sin(position_ids.reshape(-1), cfg)
    attn_mask = attn_mask.contiguous()
    window = torch.arange(Q, device=dev)
    if split:
        scr_mask = scratch_mask.contiguous()
        rows = slot_rows((scratch_offset + window).expand(B, Q), scratch.max_length)
    else:
        rows = slot_rows(cache_offset[:, None] + window, kv.max_length)
        empty = hidden.new_zeros((B, 0, Hkv, D))
        scr_mask = torch.zeros((B, Q, 0), dtype=torch.bool, device=dev)

    for i in range(cfg.num_layers):
        x = rms_norm(hidden, lp.attn_norm[i], cfg.rms_norm_eps)
        q = matmul(x, layer(lp.wq, i)).reshape(R, H, D)
        k = matmul(x, layer(lp.wk, i)).reshape(R, Hkv, D)
        v = matmul(x, layer(lp.wv, i)).reshape(R, Hkv, D)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_cache, v_cache = kv.k[i], kv.v[i]  # [B, M, ...] views
        if split:
            sk, sv = scratch.k[i], scratch.v[i]
            sk.flatten(0, 1).index_copy_(0, rows, k.to(sk.dtype))  # in place
            sv.flatten(0, 1).index_copy_(0, rows, v.to(sv.dtype))
        else:
            if quantized_kv:
                kv.write_rows(i, rows, k, v)
            else:
                k_cache.flatten(0, 1).index_copy_(0, rows, k.to(k_cache.dtype))
                v_cache.flatten(0, 1).index_copy_(0, rows, v.to(v_cache.dtype))
            sk = sv = empty
        attn = tree_attention_batched(q.reshape(B, Q, H, D), k_cache, v_cache, attn_mask,
                                      sk, sv, scr_mask, scale=scale,
                                      ks=kv.ks[i] if quantized_kv else None,
                                      vs=kv.vs[i] if quantized_kv else None)
        hidden = hidden + matmul(attn.reshape(R, H * D), layer(lp.wo, i))

        y = rms_norm(hidden, lp.mlp_norm[i], cfg.rms_norm_eps)
        gate = torch.nn.functional.silu(matmul(y, layer(lp.w_gate, i)))
        mlp = matmul(gate * matmul(y, layer(lp.w_up, i)), layer(lp.w_down, i))
        hidden = hidden + mlp

    hidden = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    logits = matmul(hidden, params.lm_head, out_dtype=torch.float32)
    return logits.reshape(B, Q, -1), (scratch if split else kv)
