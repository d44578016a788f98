"""Static-shape KV caches for tree speculative decoding.

Port of `sequoia_tpu/kvcache/cache.py`: `KVCache` (float), `KVCache8` (int8
rows) and `KVCache4` (int4 rows, two packings), all in the layout
`[num_layers, max_length, heads, row]`, so one layer's cache `k[l]` is a
contiguous block, which is what the tree-attention kernel reads. Where JAX
returned new buffers, these caches are updated IN PLACE (`commit_rows`, and
the model's window writes).

The quantized caches keep one f32 scale per (row, kv head). The dequantizing
multiplies fold into attention exactly: scores times `ks[m, h]` before the
softmax, probabilities times `vs[m, h]` before the value product
(`kernels/tree_attention.py`), so the only error is the rounding of the
rows. The row quantizers reproduce the JAX package's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.config import LlamaConfig
from ..utils import resolve_device


def _window(dest_offset, n: int, device) -> torch.Tensor:
    """Slots `[dest_offset, dest_offset + n)`; the offset may be a device
    tensor (no host sync)."""
    return dest_offset + torch.arange(n, device=device)


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

    def zero_(self) -> "KVCache":
        """Zero every row in place (an engine reusing its cache for a new
        request). Returns self."""
        for t in (self.k, self.v):
            t.zero_()
        return self

    def commit_rows(self, scratch: "KVCache", src_slots: torch.Tensor,
                    dest_offset) -> "KVCache":
        """Write scratch rows `src_slots` (`[P]`, may repeat as padding) to
        the window `[dest_offset, dest_offset + P)`, in place. `dest_offset`
        may be a device tensor (no host sync). Returns self."""
        src = src_slots.to(device=self.k.device, dtype=torch.long)
        dest = _window(dest_offset, src.shape[0], self.k.device)
        self.k.index_copy_(1, dest, scratch.k.index_select(1, src).to(self.k.dtype))
        self.v.index_copy_(1, dest, scratch.v.index_select(1, src).to(self.v.dtype))
        return self


@dataclass
class _QuantizedKVCache:
    """Integer rows `k`, `v` and f32 scales `ks`, `vs` `[L, M, Hkv]`."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @property
    def max_length(self) -> int:
        return self.k.shape[1]

    def quantize_rows(self, x: torch.Tensor):
        raise NotImplementedError

    def zero_(self):
        """Zero every row and scale in place (see `KVCache.zero_`)."""
        for t in (self.k, self.v, self.ks, self.vs):
            t.zero_()
        return self

    def write_rows(self, layer: int, rows: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
        """Quantize float rows `k`, `v` `[Q, Hkv, D]` and write them, with
        their scales, at slots `rows` of layer `layer`, in place."""
        for x, ints, scales in ((k, self.k, self.ks), (v, self.v, self.vs)):
            q, s = self.quantize_rows(x)
            ints[layer].index_copy_(0, rows, q)
            scales[layer].index_copy_(0, rows, s)

    def commit_rows(self, scratch: KVCache, src_slots: torch.Tensor, dest_offset):
        """Quantize the float scratch rows `src_slots` and write them to the
        window at `dest_offset`, in place (see `KVCache.commit_rows`). Rows
        are quantized ONCE, at commit, not at every verify, and the tree
        search itself runs on full-precision scratch rows. Returns self."""
        src = src_slots.to(device=self.k.device, dtype=torch.long)
        dest = _window(dest_offset, src.shape[0], self.k.device)
        for x, ints, scales in ((scratch.k, self.k, self.ks), (scratch.v, self.v, self.vs)):
            q, s = self.quantize_rows(x.index_select(1, src))
            ints.index_copy_(1, dest, q)
            scales.index_copy_(1, dest, s)
        return self


class KVCache8(_QuantizedKVCache):
    """int8 KV cache: per-row, per-kv-head symmetric scales. Half the bytes
    of a bf16 cache, for the attention read and for the batch that fits.

    k/v:   int8 `[L, M, Hkv, D]`
    ks/vs: f32  `[L, M, Hkv]`
    """

    @staticmethod
    def init(cfg: LlamaConfig, max_length: int, dtype=None, device=None) -> "KVCache8":
        """`dtype` is accepted (and ignored) for the call shape of
        `KVCache.init`: rows are always int8 with f32 scales."""
        device = resolve_device(device)
        shape = (cfg.num_layers, max_length, cfg.num_kv_heads, cfg.head_dim_)
        return KVCache8(k=torch.zeros(shape, dtype=torch.int8, device=device),
                        v=torch.zeros(shape, dtype=torch.int8, device=device),
                        ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                        vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device))

    def quantize_rows(self, x):
        return quantize_kv_rows(x)


class KVCache4(_QuantizedKVCache):
    """int4-packed KV cache: the scheme of `KVCache8` at half its bytes; the
    rows are coarser, so acceptance should be re-measured at this precision.

    Two packings, told apart by shape (`shape[-1] == head_dim` <=> head
    paired); `init(packing=...)` selects, default "auto":

    - "head" (the auto default when Hkv is even): the byte at `[m, j, d]`
      holds head `2j`'s value d in the low nibble and head `2j+1`'s in the
      high nibble. k/v: int8 `[L, M, Hkv/2, D]`.
    - "dsplit" (odd head counts; in JAX also the tensor-parallel fallback):
      byte d holds row value d (low) and D/2 + d (high), the kv-head axis
      stays whole. k/v: int8 `[L, M, Hkv, D/2]`.

    ks/vs: f32 `[L, M, Hkv]` either way.
    """

    @staticmethod
    def init(cfg: LlamaConfig, max_length: int, dtype=None, packing: str = "auto",
             device=None) -> "KVCache4":
        if packing not in ("auto", "head", "dsplit"):
            raise ValueError(f"unknown int4 KV packing {packing!r}")
        if packing == "auto":
            packing = "head" if cfg.num_kv_heads % 2 == 0 else "dsplit"
        if packing == "head":
            if cfg.num_kv_heads % 2:
                raise ValueError("head-paired int4 KV needs an even kv-head count")
            shape = (cfg.num_layers, max_length, cfg.num_kv_heads // 2, cfg.head_dim_)
        else:
            if cfg.head_dim_ % 2:
                raise ValueError("dsplit int4 KV needs an even head_dim")
            shape = (cfg.num_layers, max_length, cfg.num_kv_heads, cfg.head_dim_ // 2)
        sshape = (cfg.num_layers, max_length, cfg.num_kv_heads)
        device = resolve_device(device)
        return KVCache4(k=torch.zeros(shape, dtype=torch.int8, device=device),
                        v=torch.zeros(shape, dtype=torch.int8, device=device),
                        ks=torch.zeros(sshape, dtype=torch.float32, device=device),
                        vs=torch.zeros(sshape, dtype=torch.float32, device=device))

    @property
    def packing(self) -> str:
        # From the shapes: head-paired keeps the full head_dim, dsplit halves
        # it; the scales' head axis is always the full Hkv.
        return "head" if self.k.shape[-2] * 2 == self.ks.shape[-1] else "dsplit"

    def quantize_rows(self, x):
        return quantize_kv_rows4(x, packing=self.packing)


# The main-cache class of each `kv_quant` value of the engines and the
# profiler; `KVCache4.init` picks its packing unless told.
KV_CACHES = {None: KVCache, "none": KVCache, "int8": KVCache8, "int4": KVCache4}


def quantize_kv_rows(x: torch.Tensor):
    """x: float `[..., Hkv, D]` -> (int8 rows, f32 scales `[..., Hkv]`).
    No clip, as in JAX: |x / scale| <= 127 up to rounding."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / _const(127.0, x)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def quantize_kv_rows4(x: torch.Tensor, packing: str = "head"):
    """x: float `[..., Hkv, D]` -> (packed int4 rows, f32 scales `[..., Hkv]`).

    `packing="head"`: `[..., Hkv/2, D]`, low nibble = head 2j, high = 2j+1.
    `packing="dsplit"`: `[..., Hkv, D/2]`, low nibble = dim d, high = D/2+d.
    The quantized VALUES are the same under both packings. The bytes equal
    JAX's: it shifts the int8 high value left by 4 and lets it wrap; here the
    nibbles are combined in int16 and the low byte reinterpreted as int8."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / _const(7.0, x)
    q = torch.round(xf / scale[..., None]).clamp(-7, 7).to(torch.int16)
    if packing == "head":
        lo, hi = q[..., 0::2, :], q[..., 1::2, :]
    else:
        half = q.shape[-1] // 2
        lo, hi = q[..., :half], q[..., half:]
    packed = (lo & 0x0F) | ((hi & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def unpack_kv_rows4(packed: torch.Tensor, packing: str = "head") -> torch.Tensor:
    """head: packed int8 `[..., Hkv/2, D]` -> values `[..., Hkv, D]` (heads
    re-interleaved); dsplit: `[..., Hkv, D/2]` -> `[..., Hkv, D]`. Sign
    extended either way."""
    p = packed.to(torch.int16)
    lo = (((p & 0x0F) ^ 8) - 8).to(torch.int8)
    hi = (p >> 4).to(torch.int8)                # arithmetic: sign-extends
    if packing == "head":
        stacked = torch.stack([lo, hi], dim=-2)  # [..., Hp, 2, D]
        return stacked.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                               packed.shape[-1])
    return torch.cat([lo, hi], dim=-1)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 divisor on `like`'s device: dividing by a tensor is a true
    division on the card, where PyTorch multiplies by the reciprocal of a
    Python scalar; the scales must equal JAX's bit for bit."""
    return torch.full((), value, dtype=torch.float32, device=like.device)
