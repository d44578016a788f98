"""Process-group bootstrap and the (dp, tp) device mesh.

Port of `sequoia_tpu/parallel/distributed.py`. JAX starts one process per
host and sees every chip of the slice; here, as `torchrun` launches it, one
process drives one card (or, on the CPU, one gloo rank). The rank, the
world size and the rendezvous come from the environment `torchrun` sets
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) unless
the caller passes them. A single-process run skips initialization, as
JAX's does.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with dims
`("dp", "tp")`, tp innermost: the ranks of one tensor-parallel group are
consecutive, so with one process per card and cards numbered host by host
a tp group stays on one host's NVLink and the dp axis spans hosts. Its
`get_group("tp")` is the group the forward's collectives run on
(`core/model.py`), its `get_group("dp")` the one the batched engine
gathers its slots' outputs over (`engine/batched.py`).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Idempotent `init_process_group`. `coordinator_address` is
    `host:port` (default `MASTER_ADDR:MASTER_PORT`), `num_processes` the
    world size (default `WORLD_SIZE`), `process_id` the rank (default
    `RANK`). A single-process run (world size 1 or none set) returns
    without initializing. `backend`: "nccl" when this process has a CUDA
    card, else "gloo"."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world is None or world == 1:
        return
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("initialize_distributed: no rank (pass process_id or set RANK)")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError("initialize_distributed: no coordinator (pass "
                             "coordinator_address or set MASTER_ADDR / MASTER_PORT)")
        coordinator_address = f"{addr}:{port}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def hybrid_mesh(tp: Optional[int] = None, dp: Optional[int] = None):
    """A (dp, tp) mesh over every rank with tp innermost. Defaults: tp =
    the processes of one host (`LOCAL_WORLD_SIZE`, else the world), dp =
    the rest. Needs an initialized process group (world size 1 included)."""
    n = world_size()
    if tp is None:
        tp = _env_int("LOCAL_WORLD_SIZE") or n
    if dp is None:
        dp = n // tp
    if tp * dp != n:
        raise ValueError(f"tp({tp}) x dp({dp}) != {n} ranks")
    from .sharding import make_mesh

    return make_mesh(tp=tp, dp=dp)


def is_primary() -> bool:
    """True on the process that should write artifacts / print reports."""
    return not dist.is_initialized() or dist.get_rank() == 0
