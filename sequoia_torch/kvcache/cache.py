"""Static-shape KV cache for tree speculative decoding.

Port of `sequoia_tpu/kvcache/cache.py::KVCache`. Layout
`[num_layers, max_length, num_kv_heads, head_dim]`, so one layer's cache
`k[l]` is a contiguous `[M, Hkv, D]` block, which is what the tree-attention
kernel reads. Where JAX returned new buffers, this cache is updated IN
PLACE (`commit_rows`, and the model's window writes).

Quantized caches (`KVCache8`, `KVCache4`) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.config import LlamaConfig
from ..utils import resolve_device


@dataclass
class KVCache:
    """K/V buffers: each `[num_layers, max_length, num_kv_heads, head_dim]`."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_length(self) -> int:
        return self.k.shape[1]

    @staticmethod
    def init(cfg: LlamaConfig, max_length: int, dtype=torch.bfloat16,
             device=None) -> "KVCache":
        """Zero-filled, so rows never written hold finite values (a masked
        row still enters the value product with probability 0). `device`
        None is the CUDA card (`utils.resolve_device`)."""
        device = resolve_device(device)
        shape = (cfg.num_layers, max_length, cfg.num_kv_heads, cfg.head_dim_)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    def commit_rows(self, scratch: "KVCache", src_slots: torch.Tensor,
                    dest_offset) -> "KVCache":
        """Write scratch rows `src_slots` (`[P]`, may repeat as padding) to
        the window `[dest_offset, dest_offset + P)`, in place. `dest_offset`
        may be a device tensor (no host sync). Returns self."""
        src = src_slots.to(device=self.k.device, dtype=torch.long)
        dest = dest_offset + torch.arange(src.shape[0], device=self.k.device)
        self.k.index_copy_(1, dest, scratch.k.index_select(1, src).to(self.k.dtype))
        self.v.index_copy_(1, dest, scratch.v.index_select(1, src).to(self.v.dtype))
        return self


class KVCache8:
    """int8 KV cache: not ported yet."""

    @staticmethod
    def init(*args, **kwargs):
        raise NotImplementedError("int8 KV cache is not ported yet")


class KVCache4:
    """int4 KV cache: not ported yet."""

    @staticmethod
    def init(*args, **kwargs):
        raise NotImplementedError("int4 KV cache is not ported yet")
