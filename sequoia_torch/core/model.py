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
  still returns the cache it wrote, for the same call shape as JAX. Under
  autograd (training, `tools/distill.py`) a float cache is still written
  in place, but attention reads an out-of-place copy of the layer's rows
  that carries the new rows' history (`_write_rows`): an in-place write
  into the shared `[L, ...]` stack would bump the version of every
  layer's saved view, and backward would refuse them.

`forward_batched` is the same forward over a slot axis (JAX vmaps
`forward` in `sequoia_tpu/engine/batched.py`): B independent requests,
each with its own cache (the batched caches of `kvcache/cache.py`), its
own offsets and masks. The projections and the head run once on the B x Q
rows, one weight stream for every slot; attention is one launch of the
batched tree-attention kernel.

Both take the layers as a device-resident `LayerParams` or as
`OffloadLayers` (host offload, `engine/offload.py`), through one helper,
`_layer_weights`, which hands each loop one layer's weights at a time.

Tensor parallelism (`tp=`, a process group; JAX shards with GSPMD): the
params are this rank's shard (`parallel/sharding.py`), so the rank runs
`H/tp` query and `Hkv/tp` KV heads over its own caches, and three
collectives join the ranks (`parallel/collectives.py`): the partial
products of the row-parallel `wo` and `w_down`, in f32, are all-reduced
(SUM) and rounded once before the residual add, and the vocab-parallel
logits are all-gathered to `[Q, V]` in rank order. A row-parallel matmul
that quantizes its activations per row (w8a8, w4a8) scales them by the
maxima of the WHOLE rows, an all-reduce (MAX) of the shards' row maxima,
so that its int8 rows are those of the unsharded model. With a group the
collectives run at every size, one included; without one nothing changes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from .config import LlamaConfig
from ..kernels.tree_attention import tree_attention, tree_attention_batched
from ..parallel.collectives import all_gather_last, all_reduce_max, all_reduce_sum, group_size
from ..quant.qtensor import QuantizedTensor, WeightLike, layer, matmul, quantizes_activations
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


class OffloadLayers(NamedTuple):
    """Layer stacks split by residency for host-offloaded serving (JAX's
    `OffloadLayers`, `sequoia_tpu/core/model.py:61-80`).

    `resident` holds the first `stay_layers` layers on the device (None
    when there are none). `streamed` holds the rest: each >= 3-D leaf (a
    float weight stack, or a quantized stack's `q` and `scale`) lies in
    pinned host memory on the card (plain host memory on the CPU) with
    contiguous per-layer slices, and the `[L, E]` norm stacks stay on the
    device. `engine/offload.py` builds it; the forward streams the host
    leaves into device staging buffers one layer ahead of the compute
    (`_layer_weights`)."""

    resident: Optional[LayerParams]
    streamed: LayerParams


class LlamaParams(NamedTuple):
    embed: torch.Tensor       # [V, E]
    layers: LayerParams       # or OffloadLayers (host-offloaded serving)
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


def _write_rows(block: torch.Tensor, rows: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write `new` (`[n, Hkv, D]`) into rows `rows` of one layer's float
    cache block (`[M, Hkv, D]`, or `[B, M, Hkv, D]` with `rows` into the
    slots' rows laid end to end), in place; returns the block attention
    reads. With grad mode on and `new` requiring grad that is an
    out-of-place copy carrying `new`'s history (module doc); otherwise the
    block itself, so the engines and their graphs run as before."""
    flat = block.flatten(0, -3)
    if torch.is_grad_enabled() and new.requires_grad:
        read = flat.index_copy(0, rows, new.to(flat.dtype)).view_as(block)
        with torch.no_grad():
            flat.index_copy_(0, rows, new.to(flat.dtype))
        return read
    flat.index_copy_(0, rows, new.to(flat.dtype))
    return block


def layer_leaves(lp: LayerParams) -> List[torch.Tensor]:
    """The tensors of a layer stack in field order (a quantized weight
    gives its `q`, then its `scale`)."""
    out = []
    for w in lp:
        out.extend(w if isinstance(w, QuantizedTensor) else (w,))
    return out


def from_leaves(template: LayerParams, leaves) -> LayerParams:
    """`template`'s structure over `leaves`: the inverse of `layer_leaves`."""
    it = iter(leaves)
    return LayerParams(*(QuantizedTensor(next(it), next(it)) if isinstance(w, QuantizedTensor)
                         else next(it) for w in template))


def is_streamed(a: torch.Tensor) -> bool:
    """JAX's placement rule (`sequoia_tpu/engine/offload.py:53-67`): a
    leaf of the streamed layers with >= 3 dims lies in host memory; the
    `[L, E]` norm stacks stay on the device."""
    return a.dim() >= 3


class _Staging:
    """Two device buffers per streamed host leaf, each one layer of it
    (`[2, ...]`; layer j goes to buffer j % 2), and on the card the copy
    stream and the events that order the copies against the compute. Made
    once per device and layer shapes (`staging`) and reused by every
    forward and every graph captured over them: a graph holds the buffers'
    addresses."""

    def __init__(self, host: List[torch.Tensor], device: torch.device):
        self.bufs = [torch.empty((2, *a.shape[1:]), dtype=a.dtype, device=device)
                     for a in host]
        self.cuda = device.type == "cuda"
        if self.cuda:
            # Ordering events only (no timing): legal inside a capture.
            self.stream = torch.cuda.Stream(device)
            self.landed = [torch.cuda.Event(), torch.cuda.Event()]  # copy into buffer b done
            self.freed = [torch.cuda.Event(), torch.cuda.Event()]   # last read of buffer b done

    def fill(self, host: List[torch.Tensor], j: int) -> None:
        """Copy layer j of each host leaf into buffer j % 2. On the card:
        `cudaMemcpyAsync` from pinned memory on the copy stream (a copy
        engine, no kernel), after the event of the buffer's last reader
        when there was one in this forward, then the buffer's landed
        event. On the CPU: plain copies."""
        b = j % 2
        if not self.cuda:
            for buf, a in zip(self.bufs, host):
                buf[b].copy_(a[j])
            return
        with torch.cuda.stream(self.stream):
            if j >= 2:
                self.stream.wait_event(self.freed[b])
            for buf, a in zip(self.bufs, host):
                buf[b].copy_(a[j], non_blocking=True)
            self.landed[b].record(self.stream)


_STAGING: Dict[tuple, _Staging] = {}


def staging(streamed: LayerParams, device) -> _Staging:
    """The staging buffers (and copy stream) of `streamed`'s layer shapes
    on `device`, made on first use."""
    host = [a for a in layer_leaves(streamed) if is_streamed(a)]
    key = (torch.device(device), tuple((tuple(a.shape[1:]), a.dtype) for a in host))
    if key not in _STAGING:
        _STAGING[key] = _Staging(host, key[0])
    return _STAGING[key]


def _layer_weights(layers, num_layers: int, device) -> Iterator[LayerParams]:
    """Each layer's weights in order, as a one-layer `LayerParams`: the
    helper both layer loops take their weights from.

    Resident layers are views into their stacks. For `OffloadLayers`, the
    streamed layer j (after the resident ones) is copied from host memory
    into staging buffer j % 2. The copies of the first two streamed layers
    are enqueued here, as the forward starts, so they overlap the embedding
    and the resident layers; layer j + 2's copy is enqueued when the loop
    comes back after layer j, the buffer's last reader. On the card the
    copies run on the staging copy stream, which forks from the current
    (compute) stream here and joins it after the last layer, so a captured
    forward holds its copies in the same graph; layer j waits for its own
    copy's event, and the copy into a buffer waits for an event recorded
    after the buffer's last reader. On the CPU the same buffers are filled
    in the same order with plain copies."""
    if isinstance(layers, LayerParams):
        return (LayerParams(*(layer(w, i) for w in layers)) for i in range(num_layers))
    if not isinstance(layers, OffloadLayers):
        raise TypeError(f"unknown layer stack {type(layers).__name__}")
    n_res = 0 if layers.resident is None else layers.resident.attn_norm.shape[0]
    n_str = layers.streamed.attn_norm.shape[0]
    if n_res + n_str != num_layers:
        raise ValueError(f"{n_res} resident + {n_str} streamed layers, config has {num_layers}")
    flat = layer_leaves(layers.streamed)
    host = [a for a in flat if is_streamed(a)]
    st = staging(layers.streamed, device)
    compute = None
    if st.cuda:
        # A pageable copy neither overlaps nor captures: refuse it (a
        # capture refuses it on its own).
        if not torch.cuda.is_current_stream_capturing() and not all(a.is_pinned() for a in host):
            raise RuntimeError("streamed layers must lie in pinned host memory "
                               "(engine/offload.py::offload_params)")
        compute = torch.cuda.current_stream(st.bufs[0].device)
        st.stream.wait_stream(compute)   # fork; also orders after earlier readers
    for j in range(min(2, n_str)):
        st.fill(host, j)
    return _streamed_layers(layers, n_res, n_str, flat, host, st, compute)


def _streamed_layers(layers: OffloadLayers, n_res: int, n_str: int, flat, host,
                     st: _Staging, compute) -> Iterator[LayerParams]:
    for i in range(n_res):
        yield LayerParams(*(layer(w, i) for w in layers.resident))
    for j in range(n_str):
        b = j % 2
        if st.cuda:
            compute.wait_event(st.landed[b])
        bufs = iter(st.bufs)
        yield from_leaves(layers.streamed,
                          [next(bufs)[b] if is_streamed(a) else a[j] for a in flat])
        if j + 2 < n_str:
            if st.cuda:
                st.freed[b].record(compute)
            st.fill(host, j + 2)
    if st.cuda:
        compute.wait_stream(st.stream)   # join


def _row_parallel(x: torch.Tensor, w: WeightLike, tp) -> torch.Tensor:
    """`x @ w` of a row-parallel weight: with a tp group, this rank's
    partial product, in f32, summed over the group and then rounded to x's
    dtype once, as the unsharded product is (a bf16 partial rounded before
    the sum would differ from it by a rounding a rank); an
    activation-quantizing route scales by the whole rows' maxima."""
    if tp is None:
        return matmul(x, w)
    amax = None
    if quantizes_activations(x, w):
        amax = all_reduce_max(x.float().abs().amax(dim=-1, keepdim=True), tp)
    return all_reduce_sum(matmul(x, w, amax=amax, out_dtype=torch.float32), tp).to(x.dtype)


def _head_counts(cfg: LlamaConfig, tp) -> Tuple[int, int, int]:
    """(query heads, KV heads, head dim) of one rank's shard."""
    n = group_size(tp)
    return cfg.num_heads // n, cfg.num_kv_heads // n, cfg.head_dim_


def _logits(hidden: torch.Tensor, params: LlamaParams, tp) -> torch.Tensor:
    logits = matmul(hidden, params.lm_head, out_dtype=torch.float32)
    return logits if tp is None else all_gather_last(logits, tp)


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
    tp=None,                      # tensor-parallel process group (module doc)
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
    quantized_kv = not isinstance(kv, KVCache)
    Q = tokens.shape[0]
    H, Hkv, D = _head_counts(cfg, tp)
    scale = D ** -0.5
    split = scratch is not None
    dev = tokens.device
    weights = _layer_weights(params.layers, cfg.num_layers, dev)

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

    for i, w in enumerate(weights):
        x = rms_norm(hidden, w.attn_norm, cfg.rms_norm_eps)
        q = matmul(x, w.wq).reshape(Q, H, D)
        k = matmul(x, w.wk).reshape(Q, Hkv, D)
        v = matmul(x, w.wv).reshape(Q, Hkv, D)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_cache, v_cache = kv.k[i], kv.v[i]  # one layer's rows, views
        if split:
            sk = _write_rows(scratch.k[i], rows, k)  # in place
            sv = _write_rows(scratch.v[i], rows, v)
        else:
            if quantized_kv:
                kv.write_rows(i, rows, k, v)  # quantized, in place
            else:
                k_cache = _write_rows(k_cache, rows, k)  # in place
                v_cache = _write_rows(v_cache, rows, v)
            sk = sv = empty
        attn = tree_attention(q.contiguous(), k_cache, v_cache, attn_mask,
                              sk, sv, scr_mask, scale=scale,
                              ks=kv.ks[i] if quantized_kv else None,
                              vs=kv.vs[i] if quantized_kv else None)
        hidden = hidden + _row_parallel(attn.reshape(Q, H * D), w.wo, tp)

        y = rms_norm(hidden, w.mlp_norm, cfg.rms_norm_eps)
        gate = torch.nn.functional.silu(matmul(y, w.w_gate))
        mlp = _row_parallel(gate * matmul(y, w.w_up), w.w_down, tp)
        hidden = hidden + mlp

    hidden = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    return _logits(hidden, params, tp), (scratch if split else kv)


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
    tp=None,                      # tensor-parallel process group (module doc)
):
    """`forward` of B slots at once: returns (`logits` f32 `[B, Q, vocab]`,
    the cache-or-scratch written). The two write modes of `forward`, per
    slot; a write-mode window past a slot's end is cut to its last row
    (`kvcache.cache.slot_rows`: a predicated no-op slot of the batched
    engine may sit at the end of its buffer)."""
    if not isinstance(kv, (KVCache, KVCache8, KVCache4)) or kv.batch is None:
        raise TypeError("forward_batched: needs a batched KV cache")
    quantized_kv = not isinstance(kv, KVCache)
    B, Q = tokens.shape
    R = B * Q
    H, Hkv, D = _head_counts(cfg, tp)
    scale = D ** -0.5
    split = scratch is not None
    dev = tokens.device
    weights = _layer_weights(params.layers, cfg.num_layers, dev)

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

    for i, w in enumerate(weights):
        x = rms_norm(hidden, w.attn_norm, cfg.rms_norm_eps)
        q = matmul(x, w.wq).reshape(R, H, D)
        k = matmul(x, w.wk).reshape(R, Hkv, D)
        v = matmul(x, w.wv).reshape(R, Hkv, D)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_cache, v_cache = kv.k[i], kv.v[i]  # [B, M, ...] views
        if split:
            sk = _write_rows(scratch.k[i], rows, k)  # in place
            sv = _write_rows(scratch.v[i], rows, v)
        else:
            if quantized_kv:
                kv.write_rows(i, rows, k, v)
            else:
                k_cache = _write_rows(k_cache, rows, k)
                v_cache = _write_rows(v_cache, rows, v)
            sk = sv = empty
        attn = tree_attention_batched(q.reshape(B, Q, H, D), k_cache, v_cache, attn_mask,
                                      sk, sv, scr_mask, scale=scale,
                                      ks=kv.ks[i] if quantized_kv else None,
                                      vs=kv.vs[i] if quantized_kv else None)
        hidden = hidden + _row_parallel(attn.reshape(R, H * D), w.wo, tp)

        y = rms_norm(hidden, w.mlp_norm, cfg.rms_norm_eps)
        gate = torch.nn.functional.silu(matmul(y, w.w_gate))
        mlp = _row_parallel(gate * matmul(y, w.w_up), w.w_down, tp)
        hidden = hidden + mlp

    hidden = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    return _logits(hidden, params, tp).reshape(B, Q, -1), (scratch if split else kv)
