"""Model configuration for the Llama family.

The port's own copy of `sequoia_tpu/core/config.py` (`LlamaConfig`,
`PRESETS`, `get_config`): the port imports nothing of `sequoia_tpu`. One
config drives both draft and target models; they differ only by config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # Llama-3.1/3.2 "llama3" RoPE frequency scaling (HF `rope_scaling` with
    # rope_type="llama3"): low/mid/high-frequency bands of inv_freq are kept /
    # smoothly interpolated / divided by `factor`. `rope_scaling_factor=None`
    # disables scaling (Llama 1/2/3.0 behavior).
    rope_scaling_factor: Optional[float] = None
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_position: int = 8192
    # Tokens that terminate generation. The reference hard-codes {0, 2}
    # (Tree/SpecTree.py:208: `tokens[pos] == 0 or tokens[pos] == 2`); chat
    # runners override for Llama-3 (tests/greedy_run.py:129).
    stop_tokens: Tuple[int, ...] = (0, 2)

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    @staticmethod
    def from_hf_dict(d: dict) -> "LlamaConfig":
        """Build from a HuggingFace `config.json`-style dict."""
        rs = d.get("rope_scaling") or {}
        rs_kwargs = {}
        if rs.get("rope_type", rs.get("type")) == "llama3":
            rs_kwargs = dict(
                rope_scaling_factor=float(rs["factor"]),
                rope_scaling_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
                rope_scaling_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
                rope_scaling_original_max_position=int(
                    rs.get("original_max_position_embeddings", 8192)),
            )
        elif rs:
            raise NotImplementedError(
                f"unsupported rope_scaling type {rs.get('rope_type', rs.get('type'))!r}")
        return LlamaConfig(
            **rs_kwargs,
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
        )

    @staticmethod
    def from_json(path: str) -> "LlamaConfig":
        with open(path) as f:
            return LlamaConfig.from_hf_dict(json.load(f))


# ---------------------------------------------------------------------------
# Presets for the model families exercised by the reference benchmarks
# (README.md:22-34, tests/run_A100.sh, tests/run_L40.sh): draft models
# {llama-68m, llama-160m, Sheared-LLaMA-1.3B, llama-2-7b} and target models
# {llama-2-7b, 13b, vicuna-33b, llama-2-70b}.
# ---------------------------------------------------------------------------

PRESETS = {
    # JackFram/llama-68m
    "llama-68m": LlamaConfig(
        hidden_size=768, intermediate_size=3072, num_layers=2,
        num_heads=12, num_kv_heads=12, max_position_embeddings=2048,
    ),
    # JackFram/llama-160m
    "llama-160m": LlamaConfig(
        hidden_size=768, intermediate_size=3072, num_layers=12,
        num_heads=12, num_kv_heads=12, max_position_embeddings=2048,
    ),
    # princeton-nlp/Sheared-LLaMA-1.3B
    "sheared-llama-1.3b": LlamaConfig(
        hidden_size=2048, intermediate_size=5504, num_layers=24,
        num_heads=16, num_kv_heads=16,
    ),
    "llama-2-7b": LlamaConfig(
        hidden_size=4096, intermediate_size=11008, num_layers=32,
        num_heads=32, num_kv_heads=32,
    ),
    "llama-2-13b": LlamaConfig(
        hidden_size=5120, intermediate_size=13824, num_layers=40,
        num_heads=40, num_kv_heads=40,
    ),
    # lmsys/vicuna-33b-v1.3 (llama-30b shape)
    "vicuna-33b": LlamaConfig(
        hidden_size=6656, intermediate_size=17920, num_layers=60,
        num_heads=52, num_kv_heads=52, vocab_size=32032,
    ),
    "llama-2-70b": LlamaConfig(
        hidden_size=8192, intermediate_size=28672, num_layers=80,
        num_heads=64, num_kv_heads=8,
    ),
    # Llama-3 family (chat runners support its tokenizer/EOS ids,
    # tests/greedy_run.py:129: stop tokens 128009/128001).
    "llama-3-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        max_position_embeddings=8192, stop_tokens=(128009, 128001),
    ),
    "llama-3-70b": LlamaConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, rope_theta=500000.0,
        max_position_embeddings=8192, stop_tokens=(128009, 128001),
    ),
    # Llama-3.1/3.2 family ("llama3" rope scaling; 3.2-1b/3b are the natural
    # GQA draft models for a llama-3.1-8b/70b target — 8 KV heads shrink the
    # KV stream 4x vs the llama-2 MHA drafts).
    "llama-3.1-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        max_position_embeddings=131072, stop_tokens=(128009, 128001),
        rope_scaling_factor=8.0,
    ),
    "llama-3.1-70b": LlamaConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, rope_theta=500000.0,
        max_position_embeddings=131072, stop_tokens=(128009, 128001),
        rope_scaling_factor=8.0,
    ),
    "llama-3.2-1b": LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        rope_theta=500000.0, max_position_embeddings=131072,
        stop_tokens=(128009, 128001), tie_word_embeddings=True,
        rope_scaling_factor=32.0,
    ),
    "llama-3.2-3b": LlamaConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, max_position_embeddings=131072,
        stop_tokens=(128009, 128001), tie_word_embeddings=True,
        rope_scaling_factor=32.0,
    ),
    # Tiny configs for CPU tests.
    "test-tiny": LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, max_position_embeddings=512,
    ),
    "test-small": LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=4,
        num_heads=4, num_kv_heads=4, max_position_embeddings=512,
    ),
}


def get_config(name: str) -> LlamaConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")
