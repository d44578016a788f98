"""sequoia_torch — Sequoia tree speculative decoding in PyTorch for an
NVIDIA H100, with hand-written CUDA kernels.

The port of `sequoia_tpu` (which stays the reference). Heavy modules load
lazily; the package root imports nothing but this file.
"""

__version__ = "0.1.0"

__all__ = [
    "SpecEngine",
    "ARBaseline",
    "GrowMap",
    "LlamaConfig",
    "get_config",
]


def __getattr__(name):
    if name == "SpecEngine":
        from .engine.engine import SpecEngine

        return SpecEngine
    if name == "ARBaseline":
        from .engine.baseline import ARBaseline

        return ARBaseline
    if name == "GrowMap":
        from .trees.growmap import GrowMap

        return GrowMap
    if name in ("LlamaConfig", "get_config"):
        from .core import config as _c

        return getattr(_c, name)
    raise AttributeError(f"module 'sequoia_torch' has no attribute {name!r}")
