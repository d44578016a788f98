"""Whole-model weight-only quantization (port of
`sequoia_tpu/quant/quantize.py`)."""

from __future__ import annotations

import math

import torch

from ..core.model import LayerParams, LlamaParams
from ..utils import make_generator, resolve_device
from .qtensor import QuantizedTensor, quantize_int4, quantize_int8

_QUANTIZERS = {8: quantize_int8, 4: quantize_int4}


def quantize_model(params: LlamaParams, bits: int = 8) -> LlamaParams:
    """Quantize every projection matrix (and the lm_head) to int8 / int4
    with per-output-channel scales. Norms and the embedding table keep
    their dtype (the embedding is a gather, not a matmul)."""
    qfn = _QUANTIZERS[bits]
    lp = params.layers
    layers = LayerParams(
        attn_norm=lp.attn_norm, wq=qfn(lp.wq), wk=qfn(lp.wk), wv=qfn(lp.wv),
        wo=qfn(lp.wo), mlp_norm=lp.mlp_norm, w_gate=qfn(lp.w_gate),
        w_up=qfn(lp.w_up), w_down=qfn(lp.w_down),
    )
    return LlamaParams(
        embed=params.embed, layers=layers, final_norm=params.final_norm,
        lm_head=qfn(params.lm_head),
    )


def tensors(tree):
    """Every tensor of a params tree (quantized leaves: `q` and `scale`)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):   # LlamaParams, LayerParams, QuantizedTensor
        for x in tree:
            yield from tensors(x)


def model_bytes(params: LlamaParams) -> int:
    return sum(x.numel() * x.element_size() for x in tensors(params))


def random_quantized_model(cfg, seed: int, bits: int = 8, dtype=torch.bfloat16,
                           device=None) -> LlamaParams:
    """Random init straight into quantized layers, on the device, from a
    seeded `torch.Generator`. Each stacked weight is filled one layer at a
    time: the f32 transient is one `[in, out]` layer, never the `[L, in,
    out]` stack (a bf16 7B tree plus its quantized copy would need both in
    memory at once). Normals scaled by min(0.02, 1/sqrt(fan_in)), as the JAX
    init; the values differ from JAX's (different generator)."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    qfn = _QUANTIZERS[bits]
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * min(0.02, 1.0 / math.sqrt(fan_in))

    def qinit(shape, fan_in):
        if len(shape) == 2:   # the lm_head: one matrix
            return qfn(normal(shape, fan_in))
        L_, K_, N_ = shape
        q = torch.empty((L_, K_ if bits == 8 else K_ // 2, N_), dtype=torch.int8, device=dev)
        scale = torch.empty((L_, 1, N_), dtype=torch.float32, device=dev)
        for i in range(L_):
            qt = qfn(normal((K_, N_), fan_in))
            q[i].copy_(qt.q)
            scale[i].copy_(qt.scale)
        return QuantizedTensor(q=q, scale=scale)

    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)  # noqa: E731
    layers = LayerParams(
        attn_norm=ones(L, E),
        wq=qinit((L, E, H * D), E),
        wk=qinit((L, E, Hkv * D), E),
        wv=qinit((L, E, Hkv * D), E),
        wo=qinit((L, H * D, E), H * D),
        mlp_norm=ones(L, E),
        w_gate=qinit((L, E, F), E),
        w_up=qinit((L, E, F), E),
        w_down=qinit((L, F, E), F),
    )
    return LlamaParams(embed=normal((V, E), E).to(dtype), layers=layers,
                       final_norm=ones(E), lm_head=qinit((E, V), E))
