"""Small host-side utilities: device resolution, sync, generators."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. `None` means the CUDA card; with
    no CUDA device that raises. `"cpu"` is for tests and small checks."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: sequoia_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def hard_sync(device=None) -> None:
    """Wait for all queued work on `device` (a no-op on the CPU)."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_generator(seed: int, device) -> torch.Generator:
    """A seeded generator on `device`, threaded explicitly through every
    random draw (never the global RNG). Streams differ from JAX's keys;
    losslessness is distributional, so nothing needs a particular stream."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


__all__ = ["resolve_device", "hard_sync", "make_generator"]
