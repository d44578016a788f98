"""Seeded weights of a model of any family, one tensor at a time.

Both sides of a run draw their weights from here: the harness hands them to
the program, and the plain reference draws them again, layer by layer, when
it needs them. Every tensor has a generator of its own, seeded from the
run's seed, the model's role, the leaf and the layer, so one layer can be
drawn without the others. Values are normals times min(0.02, 1/sqrt(fan_in))
(the port's `random_params` rule), drawn in f32 on `device` and rounded to
bf16, the type a checkpoint of these models ships in. Norm weights are one.
`dims` is a family's widths (`families/<model_type>.py::dims`): `vocab`,
`hidden`, `tied` and `shape(leaf)`, a matrix's `[in, out]`.

Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import math

import torch


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


def projection(dims, seed: int, role: str, leaf: str, layer: int,
               device="cpu") -> torch.Tensor:
    """Layer `layer`'s matrix `leaf`, `dims.shape(leaf)`, its fan-in the rows."""
    shape = dims.shape(leaf)
    return normal(shape, shape[0], seed, role, leaf, layer, device)


def embedding(dims, seed: int, role: str, device="cpu") -> torch.Tensor:
    """`[V, E]`."""
    return normal((dims.vocab, dims.hidden), dims.hidden, seed, role, "embed", -1, device)


def head(dims, seed: int, role: str, device="cpu") -> torch.Tensor:
    """The output head `[E, V]`: the embedding's transpose when tied."""
    if dims.tied:
        return embedding(dims, seed, role, device).T
    return normal((dims.hidden, dims.vocab), dims.hidden, seed, role, "lm_head", -1, device)
