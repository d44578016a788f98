"""Parameter initialization and weight transfer.

Port of `sequoia_tpu/core/init.py`: `random_params`, the HuggingFace
checkpoint loader (`params_from_hf_state_dict`, `load_hf_checkpoint`) and
exporter (`export_hf_checkpoint`), and `param_count`; plus
`params_from_numpy`, which carries weights across from the JAX package (or
any numpy source) in the same stacked `x @ W` layout.

Checkpoints are read from their files (`model.safetensors` or
`pytorch_model.bin`, single or sharded): no module is built. `torch` alone
reads and writes the `.bin` format; `safetensors` is imported only when a
`.safetensors` file is read or written, and nothing here imports
`transformers`.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from .config import LlamaConfig
from .model import LayerParams, LlamaParams
from ..quant.qtensor import QuantizedTensor
from ..quant.quantize import tensors
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
    `dtype` applies to float leaves only.

    Offloaded layers (JAX's `OffloadLayers`, or an object or dict with the
    fields `resident`, which may be None, and `streamed`) come back as the
    port's `OffloadLayers` with the same split: the streamed >= 3-D leaves
    in host memory (pinned on the card), the rest on `device`
    (`engine/offload.py::place_layers`)."""
    dev = resolve_device(device)

    def arr(a, dt=None, on=dev):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            out = torch.from_numpy(np.array(a))  # a writable copy
        return out.to(device=on, dtype=dt or out.dtype)

    def t(a, on=dev):
        if isinstance(a, dict) or (isinstance(a, tuple) and hasattr(a, "scale")):
            return QuantizedTensor(q=arr(_field(a, "q"), on=on),
                                   scale=arr(_field(a, "scale"), on=on))
        return arr(a, dtype, on)

    def stack(lp, on=dev):
        return LayerParams(*(t(_field(lp, f), on) for f in _LAYER_FIELDS))

    layers = _field(tree, "layers")
    if isinstance(layers, dict) and "streamed" in layers or hasattr(layers, "streamed"):
        from ..engine.offload import place_layers

        resident = _field(layers, "resident")
        layers = place_layers(None if resident is None else stack(resident, "cpu"),
                              stack(_field(layers, "streamed"), "cpu"), dev)
    else:
        layers = stack(layers)
    return LlamaParams(
        embed=t(_field(tree, "embed")),
        layers=layers,
        final_norm=t(_field(tree, "final_norm")),
        lm_head=t(_field(tree, "lm_head")),
    )



def _hf_tensor(t) -> torch.Tensor:
    """A state-dict entry (torch tensor or numpy array) as a CPU tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu")
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":   # ml_dtypes: torch has no numpy bf16
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def params_from_hf_state_dict(cfg: LlamaConfig, state_dict, dtype=torch.bfloat16,
                              device=None) -> LlamaParams:
    """A HuggingFace Llama `state_dict` (torch tensors or numpy arrays) in
    the stacked-layer `x @ W` layout, on `device`. HF stores projections as
    `nn.Linear` weights `[out, in]`, hence the transposes. Each stack is
    filled one layer at a time on the device, so the host holds no second
    copy of the model. Values go through f32 to `dtype`, as JAX's."""
    dev = resolve_device(device)

    def conv(t, transpose=False):
        t = _hf_tensor(t).float()
        return (t.T if transpose else t).to(device=dev, dtype=dtype)

    def stack(fmt: str, transpose: bool):
        first = conv(state_dict[fmt.format(i=0)], transpose)
        out = torch.empty((cfg.num_layers, *first.shape), dtype=dtype, device=dev)
        out[0] = first
        for i in range(1, cfg.num_layers):
            out[i] = conv(state_dict[fmt.format(i=i)], transpose)
        return out

    p = "model.layers.{i}."
    layers = LayerParams(
        attn_norm=stack(p + "input_layernorm.weight", False),
        wq=stack(p + "self_attn.q_proj.weight", True),
        wk=stack(p + "self_attn.k_proj.weight", True),
        wv=stack(p + "self_attn.v_proj.weight", True),
        wo=stack(p + "self_attn.o_proj.weight", True),
        mlp_norm=stack(p + "post_attention_layernorm.weight", False),
        w_gate=stack(p + "mlp.gate_proj.weight", True),
        w_up=stack(p + "mlp.up_proj.weight", True),
        w_down=stack(p + "mlp.down_proj.weight", True),
    )
    embed = conv(state_dict["model.embed_tokens.weight"])
    if cfg.tie_word_embeddings or "lm_head.weight" not in state_dict:
        lm_head = embed.T.contiguous()
    else:
        lm_head = conv(state_dict["lm_head.weight"], transpose=True).contiguous()
    return LlamaParams(embed=embed, layers=layers,
                       final_norm=conv(state_dict["model.norm.weight"]), lm_head=lm_head)


def _read_checkpoint_dir(path: str) -> dict:
    """The full state dict of a HF checkpoint directory: single-file or
    sharded (through its `*.index.json`), safetensors or torch `.bin`. The
    files are read directly; no module is built (the reference loads
    through `from_pretrained`, `Engine/Engine.py:18`)."""

    def load_shard(fname: str) -> dict:
        fp = os.path.join(path, fname)
        if fname.endswith(".safetensors"):
            # Through torch, not numpy: numpy has no bfloat16, and HF
            # checkpoints are typically bf16 / fp16.
            from safetensors.torch import load_file

            return load_file(fp)
        return torch.load(fp, map_location="cpu", weights_only=True)

    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = os.path.join(path, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            sd: dict = {}
            for shard in sorted(set(weight_map.values())):
                sd.update(load_shard(shard))
            return sd
    for single in ("model.safetensors", "pytorch_model.bin"):
        if os.path.exists(os.path.join(path, single)):
            return load_shard(single)
    raise FileNotFoundError(f"no model weights found under {path}")


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None):
    """A HuggingFace Llama checkpoint directory (`config.json` and
    safetensors or torch weights, sharded or not) as `(LlamaParams,
    LlamaConfig)`, the weights on `device` (default: the CUDA card)."""
    cfg = LlamaConfig.from_json(os.path.join(path, "config.json"))
    return params_from_hf_state_dict(cfg, _read_checkpoint_dir(path), dtype=dtype,
                                     device=device), cfg


def hf_state_dict(params: LlamaParams, cfg: LlamaConfig) -> dict:
    """The state dict of `params` in HuggingFace Llama naming and
    orientation (Linear weights `[out, in]`, the transposes of
    `params_from_hf_state_dict`), as contiguous f32 CPU tensors. Float
    params only (dequantize first)."""
    lp = params.layers
    if not all(isinstance(x, torch.Tensor) for x in (*lp, params.embed, params.lm_head)):
        raise TypeError("export needs float LayerParams (dequantize first)")

    def t(x, transpose=False):
        x = x.detach().to("cpu", torch.float32)
        return (x.T if transpose else x).contiguous()

    sd = {"model.embed_tokens.weight": t(params.embed),
          "model.norm.weight": t(params.final_norm)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = t(lp.attn_norm[i])
        sd[f"{p}.self_attn.q_proj.weight"] = t(lp.wq[i], transpose=True)
        sd[f"{p}.self_attn.k_proj.weight"] = t(lp.wk[i], transpose=True)
        sd[f"{p}.self_attn.v_proj.weight"] = t(lp.wv[i], transpose=True)
        sd[f"{p}.self_attn.o_proj.weight"] = t(lp.wo[i], transpose=True)
        sd[f"{p}.post_attention_layernorm.weight"] = t(lp.mlp_norm[i])
        sd[f"{p}.mlp.gate_proj.weight"] = t(lp.w_gate[i], transpose=True)
        sd[f"{p}.mlp.up_proj.weight"] = t(lp.w_up[i], transpose=True)
        sd[f"{p}.mlp.down_proj.weight"] = t(lp.w_down[i], transpose=True)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = t(params.lm_head, transpose=True)
    return sd


def export_hf_checkpoint(params: LlamaParams, cfg: LlamaConfig, path: str,
                         weights: str = "safetensors") -> None:
    """Inverse of `load_hf_checkpoint`: `config.json` and the weights in
    f32, as `model.safetensors` (JAX's format; `weights="safetensors"`) or
    as `pytorch_model.bin` (`weights="bin"`, which needs only torch).
    Either loads back here and in HF `LlamaForCausalLM`."""
    if weights not in ("safetensors", "bin"):
        raise ValueError(f"weights must be 'safetensors' or 'bin', got {weights!r}")
    sd = hf_state_dict(params, cfg)
    os.makedirs(path, exist_ok=True)
    if weights == "safetensors":
        from safetensors.torch import save_file

        save_file(sd, os.path.join(path, "model.safetensors"))
    else:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    d = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": "float32",
    }
    if cfg.rope_scaling_factor is not None:
        d["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": cfg.rope_scaling_factor,
            "low_freq_factor": cfg.rope_scaling_low_freq_factor,
            "high_freq_factor": cfg.rope_scaling_high_freq_factor,
            "original_max_position_embeddings": cfg.rope_scaling_original_max_position,
        }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f, indent=1)


def param_count(params: LlamaParams) -> int:
    """Elements of every tensor of `params` (a quantized weight's `q` and
    `scale` both count; a tied head counts again, as JAX's leaves do)."""
    return sum(x.numel() for x in tensors(params))
