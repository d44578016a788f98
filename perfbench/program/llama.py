"""The Llama family in the program: the port's config of a block, and its
weights, made on the device from the run's seed.

Each tensor comes from `gen.py`, layer by layer, and goes into the port's
stacked `LlamaParams` as it is served: bf16 as drawn, or int8 weight-only
through the port's own quantizer (`quant/qtensor.py::quantize_int8`), one
layer at a time, so no bf16 copy of a whole quantized model is ever held.
`fill` draws a seed's weights into params made before, in place: a
captured graph keeps the addresses it read.
"""

from __future__ import annotations

import dataclasses

import torch

from sequoia_torch.core.config import LlamaConfig
from sequoia_torch.core.model import LayerParams, LlamaParams
from sequoia_torch.quant.qtensor import QuantizedTensor, quantize_int8

from perfbench import gen
from perfbench.families.llama import PROJECTIONS, Dims


def config(hf: dict, stop_tokens) -> LlamaConfig:
    """The port's config of one model, read through its HF reader."""
    return dataclasses.replace(LlamaConfig.from_hf_dict(hf), stop_tokens=tuple(stop_tokens))


def _empty(dims: Dims, fmt: str, device) -> LlamaParams:
    L, E, V = dims.layers, dims.hidden, dims.vocab

    def stack(leaf):
        K, N = dims.shape(leaf)
        if fmt == "int8":
            return QuantizedTensor(q=torch.empty((L, K, N), dtype=torch.int8, device=device),
                                   scale=torch.empty((L, 1, N), dtype=torch.float32,
                                                     device=device))
        return torch.empty((L, K, N), dtype=torch.bfloat16, device=device)

    ones = lambda *shape: torch.ones(shape, dtype=torch.bfloat16, device=device)  # noqa: E731
    if fmt == "int8":
        head = QuantizedTensor(q=torch.empty((E, V), dtype=torch.int8, device=device),
                               scale=torch.empty((1, V), dtype=torch.float32, device=device))
    else:
        head = torch.empty((E, V), dtype=torch.bfloat16, device=device)
    layers = LayerParams(
        attn_norm=ones(L, E), wq=stack("wq"), wk=stack("wk"), wv=stack("wv"), wo=stack("wo"),
        mlp_norm=ones(L, E), w_gate=stack("w_gate"), w_up=stack("w_up"),
        w_down=stack("w_down"))
    return LlamaParams(embed=torch.empty((V, E), dtype=torch.bfloat16, device=device),
                       layers=layers, final_norm=ones(E), lm_head=head)


def _put(dst, w: torch.Tensor) -> None:
    if isinstance(dst, QuantizedTensor):
        qt = quantize_int8(w)
        dst.q.copy_(qt.q)
        dst.scale.copy_(qt.scale)
    else:
        dst.copy_(w)


def fill(params: LlamaParams, dims: Dims, seed: int, role: str) -> None:
    """Draw seed `seed`'s weights of model `role` into `params`, in place."""
    dev = params.embed.device
    for leaf in PROJECTIONS:
        stack = getattr(params.layers, leaf)
        for i in range(dims.layers):
            w = gen.projection(dims, seed, role, leaf, i, dev)
            _put(QuantizedTensor(stack.q[i], stack.scale[i])
                 if isinstance(stack, QuantizedTensor) else stack[i], w)
    params.embed.copy_(gen.embedding(dims, seed, role, dev))
    _put(params.lm_head, gen.head(dims, seed, role, dev))


def make(dims: Dims, fmt: str, seed: int, role: str, device) -> LlamaParams:
    """Model `role`'s params in format `fmt` ("bf16" or "int8")."""
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"weight format {fmt!r}: the benchmark serves bf16 or int8")
    params = _empty(dims, fmt, torch.device(device))
    fill(params, dims, seed, role)
    return params
