"""Megatron-style tensor parallelism over a (dp, tp) device mesh.

Port of `sequoia_tpu/parallel/sharding.py`. JAX places each leaf on the mesh
with a `NamedSharding` and GSPMD inserts the collectives; here there is no
partitioner, so to shard a leaf means that each rank keeps its own slice of
it, as a contiguous tensor of its own (the kernels take contiguous,
16-byte-aligned operands, which a strided slice is not), and the forward
runs the collectives itself (`core/model.py`, `tp=`):

- column-parallel `wq`, `wk`, `wv`, `w_gate`, `w_up`: split on the output
  axis, a quantized leaf's scale with it; panel-tiled int4 on its panels;
- row-parallel `wo`, `w_down`: split on the input axis, the scale
  replicated; their partial products are all-reduced (SUM) before the
  residual add;
- `lm_head`: split over the vocabulary; the logits are all-gathered;
- `embed` and the norms: replicated;
- KV caches: split on the KV-head axis (the int8 / int4 scales too).

Packed int4 weights are half-split: packed row r holds logical rows r and
K/2 + r (`quant/qtensor.py::quantize_int4`). JAX's spec slices the packed
rows of a row-parallel weight, which gives a rank two pieces of logical K
far apart; a rank's input is one contiguous slice of heads (or of F). So a
row shard of packed or tiled int4 takes the rank's contiguous logical K
slice and packs it half-split again within the shard: an exact
rearrangement of nibbles, which the forward then reads as any int4 weight.

The dp axis holds whole replicas: `BatchedSpecEngine` serves a contiguous
share of the slots on each dp rank (`engine/batched.py`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..core.config import LlamaConfig
from ..core.model import LayerParams, LlamaParams, OffloadLayers
from ..kernels.quant_matmul import unpack_int4, untile
from ..quant.qtensor import QuantizedTensor, WeightLike, is_tiled, pack_int4, tile_int4

# How each leaf is split: "col" on its output axis, "row" on its input axis,
# None replicated (`tp_param_specs`).
COL, ROW = "col", "row"


def make_mesh(tp: int, dp: int = 1):
    """The (dp, tp) `DeviceMesh` over the initialized process group (tp
    innermost). The world must hold exactly tp x dp ranks; a run that never
    called `init_process_group` has a world of one."""
    from torch.distributed.device_mesh import init_device_mesh

    if tp < 1 or dp < 1:
        raise ValueError(f"tp and dp must be >= 1, got tp={tp}, dp={dp}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py::initialize_distributed)")
    n = dist.get_world_size()
    if tp * dp != n:
        raise ValueError(f"need {tp * dp} ranks for tp={tp} x dp={dp}, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


class MeshAxes(NamedTuple):
    """A rank's place on a (dp, tp) mesh: each axis's size, this rank's
    index on it and its process group."""

    tp: int
    tp_rank: int
    tp_group: object
    dp: int
    dp_rank: int
    dp_group: object


def mesh_axes(mesh) -> MeshAxes:
    return MeshAxes(
        tp=mesh["tp"].size(), tp_rank=mesh.get_local_rank("tp"), tp_group=mesh.get_group("tp"),
        dp=mesh["dp"].size(), dp_rank=mesh.get_local_rank("dp"), dp_group=mesh.get_group("dp"))


def check_tp_divisibility(cfg: LlamaConfig, tp: int) -> None:
    """Raise unless every sharded axis of `cfg` divides by `tp`."""
    for name, n in (("num_kv_heads", cfg.num_kv_heads), ("num_heads", cfg.num_heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{name} = {n} does not divide by tp = {tp}")


def shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The config one rank's shard computes with: `H/tp` heads, `Hkv/tp` KV
    heads, `F/tp` ffn columns, the head dim fixed at the model's (the
    caches of a rank are made from it). The vocabulary stays whole: the
    logits are gathered."""
    check_tp_divisibility(cfg, tp)
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp, head_dim=cfg.head_dim_)


def tp_param_specs(params: LlamaParams) -> LlamaParams:
    """`params`' structure with each leaf's split (`COL`, `ROW` or None):
    column-parallel qkv / gate / up, row-parallel o / down, the
    vocab-parallel head, everything else replicated. A quantized leaf splits
    its q and scale together (see `shard_weight`)."""
    layer = LayerParams(attn_norm=None, wq=COL, wk=COL, wv=COL, wo=ROW, mlp_norm=None,
                        w_gate=COL, w_up=COL, w_down=ROW)
    return LlamaParams(embed=None, layers=layer, final_norm=None, lm_head=COL)


def _piece(n: int, tp: int, rank: int) -> slice:
    if n % tp:
        raise ValueError(f"axis of {n} does not divide by tp = {tp}")
    k = n // tp
    return slice(rank * k, (rank + 1) * k)


def _row_shard_int4(q: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rows `[rank K/tp, (rank + 1) K/tp)` of the LOGICAL int4 matrix
    packed as `q` `[..., K/2, N]`, packed half-split again: `[..., K/(2 tp), N]`."""
    v = unpack_int4(q)
    return pack_int4(v[..., _piece(v.shape[-2], tp, rank), :])


def out_features(w: WeightLike) -> int:
    """The logical output width of a weight, float or quantized."""
    return w.scale.shape[-1] if isinstance(w, QuantizedTensor) else w.shape[-1]


def shard_weight(w: WeightLike, split: Optional[str], tp: int, rank: int,
                 in_features: Optional[int] = None) -> WeightLike:
    """Rank `rank`'s contiguous slice of one weight (stacked `[L, ...]` or
    not), split as `tp_param_specs` says. A quantized row split needs the
    logical `in_features` (int8 stores every input row, int4 half).
    Panel-tiled int4 is untiled, cut and tiled again with its panel width:
    on the panel axis where the shard's columns are whole panels; a row
    shard of packed or tiled int4 is re-packed (module doc)."""
    if split is None:
        return w
    if split not in (COL, ROW):
        raise ValueError(f"unknown split {split!r}")
    if not isinstance(w, QuantizedTensor):
        if split == COL:
            return w[..., _piece(w.shape[-1], tp, rank)].contiguous()
        return w[..., _piece(w.shape[-2], tp, rank), :].contiguous()
    tiled = is_tiled(w)
    N = w.scale.shape[-1]
    q = untile(w.q, N) if tiled else w.q
    if split == COL:
        cols = _piece(N, tp, rank)
        out = QuantizedTensor(q[..., cols].contiguous(), w.scale[..., cols].contiguous())
    else:
        if in_features is None:
            raise ValueError("shard_weight: a quantized row split needs in_features")
        if q.shape[-2] * 2 == in_features:
            out = QuantizedTensor(_row_shard_int4(q, tp, rank), w.scale)
        elif q.shape[-2] == in_features:
            out = QuantizedTensor(q[..., _piece(in_features, tp, rank), :].contiguous(),
                                  w.scale)
        else:
            raise ValueError(f"q {tuple(q.shape)} does not hold {in_features} input rows")
    return tile_int4(out, bn0=w.q.shape[-1]) if tiled else out


def shard_params(params: LlamaParams, mesh) -> LlamaParams:
    """This rank's shard of `params` on `mesh`'s tp axis (see module doc)."""
    ax = mesh_axes(mesh)
    return shard_params_rank(params, ax.tp, ax.tp_rank)


def shard_params_rank(params: LlamaParams, tp: int, rank: int) -> LlamaParams:
    """`shard_params` for rank `rank` of `tp`, without a mesh."""
    if isinstance(params.layers, OffloadLayers):
        raise ValueError("host-offloaded params are the single-card path: "
                         "tensor parallelism takes device-resident params")
    specs = tp_param_specs(params)
    lp = params.layers
    # The row-parallel weights' inputs are the column-parallel outputs.
    ins = dict(wo=out_features(lp.wq), w_down=out_features(lp.w_gate))
    layers = LayerParams(*(shard_weight(w, s, tp, rank, ins.get(f))
                           for f, w, s in zip(lp._fields, lp, specs.layers)))
    return LlamaParams(embed=params.embed, layers=layers, final_norm=params.final_norm,
                       lm_head=shard_weight(params.lm_head, specs.lm_head, tp, rank))


def tp_kv_spec() -> dict:
    """The axis each leaf of a KV cache splits on over tp: the KV-head axis
    of the rows `[L, (B,) M, Hkv, D]` (the packed head pairs of a
    head-paired int4 cache) and of the int8 / int4 scales `[L, (B,) M,
    Hkv]`. The length axis stays whole, so the commits stay rank-local."""
    return {"k": -2, "v": -2, "ks": -1, "vs": -1}


def shard_kv_rank(kv, tp: int, rank: int):
    """Rank `rank`'s KV heads of a cache (any format, single or batched),
    as a cache of the same class. A head-paired int4 cache splits its
    pairs, which needs `(Hkv / 2) % tp == 0` (`kv4_packing`)."""
    out = {}
    for f, t in zip(kv._fields, kv.tensors()):
        axis = tp_kv_spec()[f]
        piece = _piece(t.shape[axis], tp, rank)
        out[f] = t.narrow(axis, piece.start, piece.stop - piece.start).contiguous()
    return type(kv)(**out)


def shard_kv(kv, mesh):
    """This rank's KV heads of `kv` on `mesh`'s tp axis."""
    ax = mesh_axes(mesh)
    return shard_kv_rank(kv, ax.tp, ax.tp_rank)


def kv4_packing(num_kv_heads: int, tp: int) -> str:
    """The int4 KV packing under tp (JAX `SpecEngine.__init__`): head pairs
    when `Hkv` is even and the pairs split over tp, else "dsplit", which
    keeps the KV-head axis whole (llama-2-70b, Hkv = 8, at tp = 8)."""
    return "head" if num_kv_heads % 2 == 0 and (num_kv_heads // 2) % tp == 0 else "dsplit"


def dp_share(n: int, dp: int, dp_rank: int) -> slice:
    """The contiguous share of `n` slots (or requests) that dp rank
    `dp_rank` serves: `n / dp` each, the first `n % dp` ranks one more."""
    base, extra = divmod(n, dp)
    start = dp_rank * base + min(dp_rank, extra)
    return slice(start, start + base + (dp_rank < extra))


def shard_batched_state(state, mesh):
    """This rank's part of a batched state (`engine/batched.py::BatchState`,
    slot axis first, the caches' on axis 1): its dp share of the slots, and
    of each cache its tp share of the KV heads (JAX `shard_batched_state`)."""
    ax = mesh_axes(mesh)
    share = dp_share(state.tokens.shape[0], ax.dp, ax.dp_rank)
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if hasattr(t, "tensors"):    # a cache: slots on axis 1
            t = type(t)(*(x[:, share].contiguous() for x in t.tensors()))
            out[f.name] = shard_kv_rank(t, ax.tp, ax.tp_rank)
        else:
            out[f.name] = t[share].contiguous()
    return type(state)(**out)
