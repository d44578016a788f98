"""The port stands alone: no file of sequoia_torch/ and not chip_smoke.py
imports jax or sequoia_tpu, and the entry points run on the CUDA card
unless the caller asks for the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "sequoia_tpu")


def _port_files():
    files = sorted((ROOT / "sequoia_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for name in ("distributed", "sharding", "collectives", "aot_proof"):
        assert ROOT / "sequoia_torch" / "parallel" / f"{name}.py" in files
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), name) for p in _port_files() for name in _imports(p)
           if isinstance(name, str) and name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    from sequoia_torch.core.config import get_config
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.baseline import ARBaseline
    from sequoia_torch.engine.engine import SpecEngine
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops.masks import causal_mask
    from sequoia_torch.quant.quantize import random_quantized_model
    from sequoia_torch.trees.growmap import chain
    from sequoia_torch.utils import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = get_config("test-tiny")
    params = random_params(cfg, 0, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecEngine(params, cfg, params, cfg, chain(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        ARBaseline(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        KVCache.init(cfg, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        causal_mask(4, 8)
    for bits in (8, 4):
        with pytest.raises(RuntimeError, match="CUDA"):
            random_quantized_model(cfg, 0, bits=bits)
    assert KVCache.init(cfg, 8, device="cpu").k.device.type == "cpu"
    assert causal_mask(4, 8, device="cpu").device.type == "cpu"
    out = SpecEngine(params, cfg, params, cfg, chain(2), algorithm="greedy",
                     max_length=32, device="cpu").generate(np.arange(4, 9), 3)
    assert len(out) > 5


def test_testbed_cli_runs_on_cpu(capsys):
    from sequoia_torch.cli.testbed import main

    main(["--draft", "test-tiny", "--target", "test-tiny", "--growmap", "tree:2x2",
          "--prompts", "synthetic:2,8", "--gen", "6", "--M", "64", "--dtype", "f32",
          "--mode", "benchmark", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "per-token latency" in out and "accept_kv" in out
    main(["--target", "test-tiny", "--prompts", "synthetic:1,8", "--gen", "4", "--M", "64",
          "--dtype", "f32", "--mode", "baseline", "--device", "cpu"])
    assert "decoding steps (tokens): 4" in capsys.readouterr().out
