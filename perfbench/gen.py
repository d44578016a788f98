"""Seeded weights of a Llama-architecture model, one tensor at a time.

Both sides of a run draw their weights from here: the harness hands them to
the program, and the plain reference draws them again, layer by layer, when
it needs them. Every tensor has a generator of its own, seeded from the
run's seed, the model's role, the leaf and the layer, so one layer can be
drawn without the others. Values are normals times min(0.02, 1/sqrt(fan_in))
(the port's `random_params` rule), drawn in f32 on `device` and rounded to
bf16, the type a checkpoint of these models ships in. Norm weights are one.

Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

# The projections of one layer, in the order the port's `LayerParams` has them.
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class Dims:
    """The widths of one model, read from its published config."""

    vocab: int
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float
    tied: bool

    @staticmethod
    def from_hf(d: dict) -> "Dims":
        heads = d["num_attention_heads"]
        return Dims(vocab=d["vocab_size"], hidden=d["hidden_size"],
                    intermediate=d["intermediate_size"], layers=d["num_hidden_layers"],
                    heads=heads, kv_heads=d.get("num_key_value_heads", heads),
                    head_dim=d.get("head_dim") or d["hidden_size"] // heads,
                    rope_theta=float(d.get("rope_theta", 10000.0)),
                    eps=float(d.get("rms_norm_eps", 1e-5)),
                    tied=bool(d.get("tie_word_embeddings", False)))

    def shape(self, leaf: str) -> tuple:
        """`[in, out]` of a projection (the `x @ W` layout)."""
        E, F, D = self.hidden, self.intermediate, self.head_dim
        return {"wq": (E, self.heads * D), "wk": (E, self.kv_heads * D),
                "wv": (E, self.kv_heads * D), "wo": (self.heads * D, E),
                "w_gate": (E, F), "w_up": (E, F), "w_down": (F, E)}[leaf]

    def projection_params(self) -> int:
        """Weights of the matrix products of one token: every layer's
        projections and the head."""
        per_layer = sum(math.prod(self.shape(n)) for n in PROJECTIONS)
        return self.layers * per_layer + self.hidden * self.vocab


def tensor_seed(seed: int, role: str, leaf: str, layer: int = -1) -> int:
    """A 63-bit seed of its own for one tensor."""
    h = hashlib.sha256(f"{int(seed)}/{role}/{leaf}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def normal(shape, fan_in: int, seed: int, role: str, leaf: str, layer: int = -1,
           device="cpu") -> torch.Tensor:
    """One weight tensor in bf16, drawn on `device`."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(tensor_seed(seed, role, leaf, layer))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(min(0.02, 1.0 / math.sqrt(fan_in))).to(torch.bfloat16)


def projection(dims: Dims, seed: int, role: str, leaf: str, layer: int,
               device="cpu") -> torch.Tensor:
    shape = dims.shape(leaf)
    return normal(shape, shape[0], seed, role, leaf, layer, device)


def embedding(dims: Dims, seed: int, role: str, device="cpu") -> torch.Tensor:
    """`[V, E]`."""
    return normal((dims.vocab, dims.hidden), dims.hidden, seed, role, "embed", -1, device)


def head(dims: Dims, seed: int, role: str, device="cpu") -> torch.Tensor:
    """The output head `[E, V]`: the embedding's transpose when tied."""
    if dims.tied:
        return embedding(dims, seed, role, device).T
    return normal((dims.hidden, dims.vocab), dims.hidden, seed, role, "lm_head", -1, device)
