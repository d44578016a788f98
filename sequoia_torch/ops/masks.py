"""Attention-mask construction.

Port of `sequoia_tpu/ops/masks.py`. Masks are small bool `[Q, M]` tensors
built on the device from (prefix length, static tree topology); the prefix
length may be a Python int or a 0-d device tensor.

Slot layout invariant (mirrors the reference, `Tree/SpecTree.py:62,138`):
  - buffer slots `[0, gtl)` hold the committed prefix; slot `gtl - 1` is both
    the last committed token and tree node 0 (the root);
  - tree node `i` lives at slot `ts + i` where `ts = gtl - 1`;
  - a tree-node query attends: all committed slots `< ts`, plus its tree
    ancestors (including the root) via the static growmap ancestor matrix.

On the engine's path the main-cache mask is always a per-row prefix
(`k < ts` or `k <= ts`); only the scratch mask carries tree topology.
"""

from __future__ import annotations

import torch

from ..utils import resolve_device


def causal_mask(num_queries: int, max_length: int, query_offset=0,
                device=None) -> torch.Tensor:
    """bool `[Q, M]`: query at slot `query_offset + q` attends slots
    `<= query_offset + q`. Used for prefill (logical position == slot).
    `device` None is the CUDA card (`utils.resolve_device`)."""
    device = resolve_device(device)
    q_idx = torch.arange(num_queries, device=device)[:, None]
    k_idx = torch.arange(max_length, device=device)[None, :]
    return k_idx <= (q_idx + query_offset)


def tree_mask_rows(ancestor_rows: torch.Tensor, tree_start: int,
                   max_length: int) -> torch.Tensor:
    """bool `[Q, M]` for tree-node queries: committed prefix (`k < ts`) OR
    ancestor inside the tree block `[ts, ts + size)`. `tree_start` is a
    Python int here (a window write)."""
    num_queries, size = ancestor_rows.shape
    k_idx = torch.arange(max_length, device=ancestor_rows.device)
    mask = (k_idx < tree_start)[None, :].expand(num_queries, -1).clone()
    mask[:, tree_start:tree_start + size] = ancestor_rows
    return mask


def split_tree_masks(ancestor_rows: torch.Tensor, tree_start, max_length: int,
                     root_in_main: bool):
    """Masks for the split-cache layout (`core/model.py::forward` with
    `scratch=`): tree-node K/V rows live in a small scratch (slot i = tree
    node i), committed rows in the main cache.

    Returns `(main_mask [Q, M], scratch_mask [Q, S])`:
    - draft grow (`root_in_main=True`): the root's draft K/V is in the main
      cache at `ts` (written by the bonus re-draft), so main covers `k <= ts`
      and scratch column 0 is dropped;
    - target verify (`root_in_main=False`): this forward computes the root's
      target K/V into scratch slot 0, so main covers `k < ts` and scratch
      keeps column 0.
    """
    num_queries = ancestor_rows.shape[0]
    k_idx = torch.arange(max_length, device=ancestor_rows.device)[None, :]
    main = (k_idx <= tree_start) if root_in_main else (k_idx < tree_start)
    main = main.expand(num_queries, -1).contiguous()
    scratch = ancestor_rows.clone()
    if root_in_main:
        scratch[:, 0] = False
    return main, scratch.contiguous()


def ancestor_matrix_to_bool(mask_01) -> torch.Tensor:
    """Growmap `mask` field (`[size, size]` 0/1, row i = ancestors of i
    including itself — `tree_search.py:95-98`) -> bool tensor."""
    return torch.as_tensor(mask_01) != 0
