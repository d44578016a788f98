"""Per-rank memory of a tensor-parallel deployment, reckoned on the `meta`
device (no weights made, no card needed).

Port of `sequoia_tpu/parallel/aot_proof.py`. JAX compiles the sharded
iteration over a virtual mesh and reads XLA's buffer assignment; the port
has no compiler to ask, so it counts the buffers one rank of
`SpecEngine(mesh=...)` holds:

- the target's shard and, with `shard_draft`, the draft's (else the whole
  draft), made by `parallel/sharding.py::shard_params_rank` from a model of
  `meta` tensors with the shapes of `quant/quantize.py::random_quantized_model`;
- the main KV caches at `max_length` and the tree scratches of the growmap,
  with this rank's `Hkv / tp` heads (`shard_config`), bf16;
- the engine's vocab-wide buffers (root, draft and target logits of one
  tree, the gathered logits of one verify).

Activations of one forward at the tree's width are small beside these and
are not counted.

    python -m sequoia_torch.parallel.aot_proof --target llama-2-70b \\
        --draft llama-2-7b --tp 8 --max-length 1024

prints one JSON object: the per-rank bytes of each part and whether they fit
one H100's 80 GB.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import NamedTuple, Optional

import torch

from ..core.config import LlamaConfig, get_config
from ..core.model import LayerParams, LlamaParams
from ..quant.qtensor import QuantizedTensor
from ..quant.quantize import model_bytes
from .sharding import check_tp_divisibility, shard_config, shard_params_rank

H100_HBM_BYTES = 80 * 10**9
_REPO = pathlib.Path(__file__).resolve().parents[2]
GROWMAP = _REPO / "growmaps" / "TPU-v5-lite-llama-2-7b-int8-llama-68m-stochastic-S64.json"


def meta_quantized_model(cfg: LlamaConfig, bits: Optional[int] = 4,
                         dtype=torch.bfloat16) -> LlamaParams:
    """`random_quantized_model(cfg, bits=bits)`'s structure, shapes and
    dtypes as `meta` tensors (`bits=None`: the float model of `dtype`)."""
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    def w(*shape):
        if bits is None:
            return empty(*shape)
        *lead, K, N = shape
        return QuantizedTensor(q=empty(*lead, K if bits == 8 else K // 2, N, dt=torch.int8),
                               scale=empty(*lead, 1, N, dt=torch.float32))

    layers = LayerParams(attn_norm=empty(L, E), wq=w(L, E, H * D), wk=w(L, E, Hkv * D),
                         wv=w(L, E, Hkv * D), wo=w(L, H * D, E), mlp_norm=empty(L, E),
                         w_gate=w(L, E, F), w_up=w(L, E, F), w_down=w(L, F, E))
    return LlamaParams(embed=empty(V, E), layers=layers, final_norm=empty(E), lm_head=w(E, V))


class MemoryEstimate(NamedTuple):
    target: str
    draft: str
    tp: int
    max_length: int
    tree_size: int
    target_weight_bytes: int
    draft_weight_bytes: int
    kv_bytes: int
    logits_bytes: int

    @property
    def total_bytes(self) -> int:
        return (self.target_weight_bytes + self.draft_weight_bytes + self.kv_bytes
                + self.logits_bytes)

    @property
    def fits_h100(self) -> bool:
        return self.total_bytes <= H100_HBM_BYTES

    def as_dict(self) -> dict:
        return dict(self._asdict(), total_bytes=self.total_bytes,
                    total_gb=self.total_bytes / 1e9, fits_h100_80gb=self.fits_h100)


def _kv_bytes(cfg: LlamaConfig, rows: int, itemsize: int = 2) -> int:
    """K and V rows `[L, rows, Hkv, D]` of one config."""
    return 2 * cfg.num_layers * rows * cfg.num_kv_heads * cfg.head_dim_ * itemsize


def tp_memory_estimate(target: str = "llama-2-70b", draft: str = "llama-2-7b", tp: int = 8,
                       max_length: int = 1024, bits: Optional[int] = 4,
                       shard_draft: bool = True, growmap_path=None) -> MemoryEstimate:
    """One rank's bytes for `target` (and `draft`) quantized to `bits` under
    tp (JAX's proof: int4 70B + int4 7B, tp = 8, M = 1024, its 64-node
    growmap)."""
    from ..trees.growmap import GrowMap

    tcfg, dcfg = get_config(target), get_config(draft)
    check_tp_divisibility(tcfg, tp)
    if shard_draft:
        check_tp_divisibility(dcfg, tp)
    size = GrowMap.load(str(growmap_path or GROWMAP)).size
    t = shard_params_rank(meta_quantized_model(tcfg, bits), tp, 0)
    d = meta_quantized_model(dcfg, bits)
    if shard_draft:
        d = shard_params_rank(d, tp, 0)
    tkv, dkv = shard_config(tcfg, tp), shard_config(dcfg, tp) if shard_draft else dcfg
    kv = _kv_bytes(tkv, max_length + size) + _kv_bytes(dkv, max_length + size)
    V = tcfg.vocab_size
    logits = 4 * V * (1 + 2 * size + size)   # root, draft and target rows, the gather
    return MemoryEstimate(target=target, draft=draft, tp=tp, max_length=max_length,
                          tree_size=size, target_weight_bytes=model_bytes(t),
                          draft_weight_bytes=model_bytes(d), kv_bytes=kv,
                          logits_bytes=logits)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--target", default="llama-2-70b")
    ap.add_argument("--draft", default="llama-2-7b")
    ap.add_argument("--tp", type=int, default=8)
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--bits", default="4", choices=["4", "8", "none"])
    ap.add_argument("--no-shard-draft", action="store_true")
    ap.add_argument("--growmap", default=None)
    args = ap.parse_args(argv)
    est = tp_memory_estimate(args.target, args.draft, args.tp, args.max_length,
                             None if args.bits == "none" else int(args.bits),
                             not args.no_shard_draft, args.growmap)
    print(json.dumps(est.as_dict()))


if __name__ == "__main__":
    main()
