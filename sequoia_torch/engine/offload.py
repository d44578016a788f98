"""Host-offloaded target serving: layer weights streamed from pinned host
memory.

Port of `sequoia_tpu/engine/offload.py`, the reference's offload engine
(`Engine/offload_engine.py`: per-layer weights pinned in host memory, the
first `stay_layers` kept on the GPU, PCIe copies double-buffered against
compute on a `load_stream`). `offload_params` splits a model's layer stacks
into `OffloadLayers(resident, streamed)` (`core/model.py`): the streamed
stacks' >= 3-D leaves go to pinned host tensors `[L', ...]` whose
per-layer slices are contiguous, the `[L, E]` norm stacks stay on the
device, as JAX places them. The forward streams one layer at a time into
two device staging buffers on a copy stream
(`core/model.py::_layer_weights`), in eager runs and inside the engines'
CUDA graphs alike, so the engines take an offloaded target with no code of
their own, as JAX's do.

On the card a streamed leaf that cannot be pinned raises: a copy from
pageable memory neither overlaps the compute nor can be captured, so there
is no pageable fallback. On the CPU (tests) the streamed leaves are plain
host tensors and the forward fills the same staging buffers with plain
copies.

Quantized layers stream as they are (`q` and `scale`): int8 / int4 cut the
bytes over the host link 2x / 4x, as they cut the device-memory stream.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.model import (LayerParams, LlamaParams, OffloadLayers, from_leaves, is_streamed,
                          layer_leaves, staging)
from ..quant.qtensor import QuantizedTensor
from ..quant.quantize import tensors
from ..utils import make_generator, resolve_device


def _host(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous host copy of `a`, in pinned memory when `device` is a
    card (copied straight from wherever `a` lies; raises if it cannot be
    pinned)."""
    if device.type != "cuda":
        return a.detach().to("cpu", copy=True).contiguous()
    out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    if not out.is_pinned():
        raise RuntimeError(f"could not pin {out.numel() * out.element_size()} bytes of host memory")
    out.copy_(a)
    return out


def place_layers(resident: Optional[LayerParams], streamed: LayerParams,
                 device) -> OffloadLayers:
    """`OffloadLayers` on `device`: the resident stacks and the streamed
    sub-3-D leaves copied to the device, the streamed >= 3-D leaves to
    (pinned) host memory."""
    dev = resolve_device(device)
    on_dev = lambda a: a.detach().to(dev, copy=True).contiguous()  # noqa: E731
    return OffloadLayers(
        resident=None if resident is None
        else from_leaves(resident, map(on_dev, layer_leaves(resident))),
        streamed=from_leaves(streamed, [_host(a, dev) if is_streamed(a) else on_dev(a)
                                        for a in layer_leaves(streamed)]),
    )


def offload_params(params: LlamaParams, stay_layers: int = 0, device=None) -> LlamaParams:
    """Split `params.layers` into `stay_layers` device-resident layers and a
    host-resident streamed remainder (the reference's `--staylayer`,
    `tests/run_sequoia.py:247`). The embedding, final norm and lm_head stay
    on the device. Float or quantized layer stacks, on any device; the
    result lives on `device` (default: where `params.embed` lies). Its
    layers are copies, so the caller may drop `params`' stacks."""
    if isinstance(params.layers, OffloadLayers):
        raise ValueError("already offloaded")
    dev = resolve_device(device if device is not None else params.embed.device)
    num_layers = params.layers.attn_norm.shape[0]
    if not 0 <= stay_layers < num_layers:
        raise ValueError(f"stay_layers must be in [0, {num_layers}), got {stay_layers}")
    leaves = layer_leaves(params.layers)
    head = from_leaves(params.layers, [a[:stay_layers] for a in leaves])
    tail = from_leaves(params.layers, [a[stay_layers:] for a in leaves])
    on_dev = lambda a: a.to(dev)  # noqa: E731
    return LlamaParams(
        embed=on_dev(params.embed),
        layers=place_layers(head if stay_layers else None, tail, dev),
        final_norm=on_dev(params.final_norm),
        lm_head=QuantizedTensor(*map(on_dev, params.lm_head))
        if isinstance(params.lm_head, QuantizedTensor) else on_dev(params.lm_head),
    )


def resident_params(params: LlamaParams) -> LlamaParams:
    """Inverse of `offload_params`: every layer back on the device as one
    stacked `LayerParams` (where it fits)."""
    layers = params.layers
    if not isinstance(layers, OffloadLayers):
        return params
    dev = params.embed.device
    streamed = [a.to(dev) for a in layer_leaves(layers.streamed)]
    if layers.resident is not None:
        streamed = [torch.cat([a, b]) for a, b in zip(layer_leaves(layers.resident), streamed)]
    return params._replace(layers=from_leaves(layers.streamed, streamed))


def offloaded_bytes(params: LlamaParams) -> Tuple[int, int]:
    """(host bytes, device bytes) of an offloaded (or resident) model: the
    host holds the streamed >= 3-D leaves, the device everything else."""
    nbytes = lambda a: a.numel() * a.element_size()  # noqa: E731
    layers = params.layers
    if not isinstance(layers, OffloadLayers):
        return 0, sum(map(nbytes, tensors(params)))
    streamed = layer_leaves(layers.streamed)
    host = sum(nbytes(a) for a in streamed if is_streamed(a))
    dev = (list(tensors(layers.resident)) + [a for a in streamed if not is_streamed(a)]
           + [params.embed, params.final_norm] + list(tensors(params.lm_head)))
    return host, sum(map(nbytes, dev))


def staging_buffers(params: LlamaParams):
    """The two device staging buffers of each streamed leaf that the
    forward of `params` copies into (`[2, ...]` each), for checks that
    poison them."""
    return staging(params.layers.streamed, params.embed.device).bufs


def random_offloaded_params(cfg: LlamaConfig, seed: int = 0, *, bits: Optional[int] = None,
                            dtype=torch.bfloat16, stay_layers: int = 0,
                            device=None) -> LlamaParams:
    """Random init of an offloaded model that never holds a whole layer
    stack on the device: each stack is built in host memory (pinned on the
    card) by JAX's block tiling (`sequoia_tpu/engine/offload.py:185-217`:
    one `default_rng(seed)` block of at most 512 x 512 normals per matrix,
    scaled by min(0.02, 1/sqrt(fan_in)) and tiled over it, the same block
    in every layer), so a model larger than the card's memory (llama-2-70b
    bf16: 137 GB of layers) runs on one card. The layer stacks equal JAX's
    element for element at f32; the bf16 values are those f32 values
    rounded to bf16. `bits` 8 / 4 gives int8 / packed-int4 stacks with
    per-column scales, as JAX's. The embedding and lm_head are random from
    a `torch.Generator` on the device (JAX draws them from a PRNG key, so
    they differ)."""
    dev = resolve_device(device)
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if not 0 <= stay_layers < L:
        raise ValueError(f"stay_layers must be in [0, {L}), got {stay_layers}")
    if bits not in (None, 8, 4):
        raise ValueError(f"bits must be None, 8 or 4, got {bits}")
    rng = np.random.default_rng(seed)

    def tiled(tile: np.ndarray, K: int, N: int) -> np.ndarray:
        """`tile` repeated over a [K, N] matrix, cut at its edges."""
        reps = (-(-K // tile.shape[0]), -(-N // tile.shape[1]))
        return np.tile(tile, reps)[:K, :N]

    def stacks(layer_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(resident [stay, ...] on the device, streamed [L - stay, ...] in
        host memory), every layer `layer_mat`."""
        res = layer_mat.to(dev).expand(stay_layers, *layer_mat.shape).contiguous()
        host = torch.empty((L - stay_layers, *layer_mat.shape), dtype=layer_mat.dtype,
                           pin_memory=dev.type == "cuda")
        if dev.type == "cuda" and not host.is_pinned():
            raise RuntimeError("could not pin the streamed layer stacks")
        host.copy_(layer_mat.expand_as(host))
        return res, host

    def mat(K: int, N: int, fan_in: int):
        scl = min(0.02, 1.0 / math.sqrt(fan_in))
        block = rng.standard_normal((min(K, 512), min(N, 512))) * scl
        if bits is None:
            # f64 -> f32 exactly as numpy rounds it, then f32 -> bf16 (RNE).
            return stacks(torch.from_numpy(tiled(block.astype(np.float32), K, N)).to(dtype))
        qmax = 127 if bits == 8 else 7
        qblock = np.clip(np.round(block / (np.abs(block).max() / qmax)), -qmax, qmax
                         ).astype(np.int8)
        Kq = K if bits == 8 else K // 2
        tile = qblock if bits == 8 else (
            (qblock[: qblock.shape[0] // 2] & 0x0F) | ((qblock[qblock.shape[0] // 2:] & 0x0F) << 4)
        ).astype(np.int8)
        q = stacks(torch.from_numpy(np.ascontiguousarray(tiled(tile, Kq, N))))
        scale = stacks(torch.full((1, N), scl / qmax, dtype=torch.float32))
        return tuple(QuantizedTensor(q[k], scale[k]) for k in (0, 1))

    norms = torch.ones((L, E), dtype=dtype, device=dev)
    fields = dict(
        wq=mat(E, H * D, E), wk=mat(E, Hkv * D, E), wv=mat(E, Hkv * D, E),
        wo=mat(H * D, E, H * D), w_gate=mat(E, F, E), w_up=mat(E, F, E),
        w_down=mat(F, E, F))
    resident = LayerParams(attn_norm=norms[:stay_layers].clone(),
                           mlp_norm=norms[:stay_layers].clone(),
                           **{k: v[0] for k, v in fields.items()})
    streamed = LayerParams(attn_norm=norms[stay_layers:].clone(),
                           mlp_norm=norms[stay_layers:].clone(),
                           **{k: v[1] for k, v in fields.items()})

    gen = make_generator(seed, dev)
    scl = min(0.02, 1.0 / math.sqrt(E))
    embed = (torch.randn((V, E), generator=gen, device=dev) * scl).to(dtype)
    lm_head = (embed.T.contiguous() if cfg.tie_word_embeddings
               else (torch.randn((E, V), generator=gen, device=dev) * scl).to(dtype))
    return LlamaParams(
        embed=embed,
        layers=OffloadLayers(resident=resident if stay_layers else None, streamed=streamed),
        final_norm=torch.ones((E,), dtype=dtype, device=dev),
        lm_head=lm_head,
    )
