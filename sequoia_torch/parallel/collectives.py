"""The collectives of the tensor-parallel forward (`core/model.py`, `tp=`).

A tp group is a `torch.distributed` process group: NCCL across cards, where
the collectives are kernels on the current stream and capture into the
engines' CUDA graphs, or gloo on the CPU (and, for checks only, several
ranks sharing one card). Each helper runs its collective whatever the
group's size, so a world of one still exercises them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# `all_gather_into_tensor` is deprecated in newer PyTorch in favour of
# `all_gather_single`, with the same arguments.
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of `x`, in place (the row-parallel
    partial products, f32)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum over the group's ranks of `x`, in place (the row maxima
    of a row-parallel layer's activation quantizer)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """`[..., n]` on each rank -> `[..., n * size]`, the ranks' pieces in
    rank order along the last axis (the vocab-parallel logits). Every rank
    receives the same bits."""
    n = group_size(group)
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    out = torch.empty((n * flat.shape[0], flat.shape[1]), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, flat, group=group)   # the ranks' pieces one after another
    out = out.view(n, flat.shape[0], flat.shape[1]).transpose(0, 1)
    return out.reshape(*x.shape[:-1], n * x.shape[-1])
