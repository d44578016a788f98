"""Parameter initialization and weight transfer.

Port of `sequoia_tpu/core/init.py::random_params`, plus
`params_from_numpy`, which carries weights across from the JAX package
(or any numpy source) in the same stacked `x @ W` layout. The HF
checkpoint loader is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import LlamaConfig
from .model import LayerParams, LlamaParams
from ..quant.qtensor import QuantizedTensor
from ..utils import make_generator, resolve_device

_LAYER_FIELDS = LayerParams._fields


def random_params(cfg: LlamaConfig, seed: int, dtype=torch.bfloat16,
                  device=None, scale: float = 0.02) -> LlamaParams:
    """Random weights with the real shapes, generated ON the device from a
    seeded `torch.Generator` (6.7 B host-side normals for llama-2-7b would
    take minutes). Normals scaled by min(scale, 1/sqrt(fan_in)), norms one,
    as the JAX init; the values differ from JAX's (different generator)."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def init(shape, fan_in):
        s = min(scale, 1.0 / math.sqrt(fan_in))
        out = torch.empty(shape, dtype=dtype, device=dev)
        # Layer by layer, so the f32 transient is one layer, not the stack.
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev) * s)
        return out

    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)  # noqa: E731
    layers = LayerParams(
        attn_norm=ones(L, E),
        wq=init((L, E, H * D), E),
        wk=init((L, E, Hkv * D), E),
        wv=init((L, E, Hkv * D), E),
        wo=init((L, H * D, E), H * D),
        mlp_norm=ones(L, E),
        w_gate=init((L, E, F), E),
        w_up=init((L, E, F), E),
        w_down=init((L, F, E), F),
    )
    embed = init((V, E), E)
    lm_head = embed.T.contiguous() if cfg.tie_word_embeddings else init((E, V), E)
    return LlamaParams(embed=embed, layers=layers, final_norm=ones(E),
                       lm_head=lm_head)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def params_from_numpy(tree, device=None, dtype=None) -> LlamaParams:
    """Weights from numpy arrays in the JAX layout: the JAX `LlamaParams`
    after `jax.tree.map(np.asarray, ...)`, or any object or dict with the
    fields `embed`, `layers.{attn_norm, wq, wk, wv, wo, mlp_norm, w_gate,
    w_up, w_down}`, `final_norm`, `lm_head`. `dtype=None` keeps each
    array's float type (bf16 arrays from `ml_dtypes` go through f32). A
    quantized leaf (the JAX `QuantizedTensor`, or a dict with `q` and
    `scale`) becomes a `QuantizedTensor` with its int8 `q` and f32 `scale`
    as they are, whatever q's layout: a panel-tiled int4 leaf (`tile_int4`:
    q has one more axis than its scale) crosses with its panels unchanged;
    `dtype` applies to float leaves only."""
    dev = resolve_device(device)

    def arr(a, dt=None):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            out = torch.from_numpy(np.array(a))  # a writable copy
        return out.to(device=dev, dtype=dt or out.dtype)

    def t(a):
        if isinstance(a, dict) or (isinstance(a, tuple) and hasattr(a, "scale")):
            return QuantizedTensor(q=arr(_field(a, "q")), scale=arr(_field(a, "scale")))
        return arr(a, dtype)

    layers = _field(tree, "layers")
    return LlamaParams(
        embed=t(_field(tree, "embed")),
        layers=LayerParams(*(t(_field(layers, f)) for f in _LAYER_FIELDS)),
        final_norm=t(_field(tree, "final_norm")),
        lm_head=t(_field(tree, "lm_head")),
    )

