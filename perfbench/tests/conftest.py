"""Fixtures of the benchmark's own tests: a tiny benchmark in a temporary
folder (two tiny configurations, each traffic kind, trees, limits, and the
real metric readers and model families), and the card for the tests marked
`cuda`.

    python -m pytest perfbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hf(E, F, L, H, KV, V=512):
    return {"model_type": "llama", "hidden_size": E, "intermediate_size": F, "num_hidden_layers": L,
            "num_attention_heads": H, "num_key_value_heads": KV, "vocab_size": V,
            "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 512,
            "tie_word_embeddings": False}


TINY_CELLS = ("tiny.single", "tiny.batched2", "tiny8.single", "tiny8.batched2")


def make_tiny(base: Path) -> Path:
    """A benchmark of tiny cells under `base`; returns its BENCHMARK.json."""
    from sequoia_torch.trees.growmap import uniform_tree

    for d in ("configs", "traffic", "trees", "limits"):
        (base / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "families", "reference", "program"):
        shutil.copytree(ROOT / "perfbench" / d, base / d, dirs_exist_ok=True)
    for name, fmt, control in (("tiny", "bf16", "fp8"), ("tiny8", "int8", "int4")):
        cfg = {"name": name, "source": "test", "target": _hf(128, 256, 2, 4, 2),
               "draft": _hf(32, 64, 2, 2, 1), "weights": {"target": fmt, "draft": "bf16"},
               "kv_cache": "bf16", "stop_tokens": [0],
               "sampling": {"algorithm": "sequoia", "walk": "node", "temperature": 0.6,
                            "top_p": 0.9},
               "control_weights": control, "assumed": [], "reduced": []}
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        for slots in (1, 2):
            uniform_tree(2, 2).to_json(str(base / "trees" / f"{name}.{slots}.json"))
    (base / "traffic" / "single.json").write_text(json.dumps({
        "kind": "single", "sampled_per_cycle": 3, "greedy_per_cycle": 1,
        "prompt_tokens": {"dist": "loguniform", "min": 8, "max": 32},
        "new_tokens": {"dist": "loguniform", "min": 16, "max": 32}, "chunk_tokens": 4,
        "max_length": 128, "prefill_chunk": 16, "check": {"greedy": 1, "sampled": 3}}))
    (base / "traffic" / "batched2.json").write_text(json.dumps({
        "kind": "batched", "slots": 2, "sampled_per_batch": 3, "greedy_per_batch": 2,
        "prompt_tokens": {"dist": "loguniform", "min": 8, "max": 24},
        "new_tokens": {"dist": "fixed", "value": 16}, "max_length": 96,
        "prefill_chunk": 16, "check": {"greedy": 2, "sampled": 3}}))
    cells = []
    for name in TINY_CELLS:
        cfg, mix = name.split(".")
        cells.append({"name": name, "config": cfg, "traffic": mix, "chips": 1, "why": "test"})
        # The tiny models' readings on the CPU, seeds 3-14 (the requests
        # `calibrate.py` reads): the program's gap_max 0-0.0018, gap_mean
        # 0-0.00006, nucleus_excess up to 0.0014, logp_z 0.06-2.33; the
        # controls' gap_max 0-0.20, gap_mean 0-0.037; walk_accepts_all's
        # and top_p_off's nucleus_excess 0.0095-0.0994. At these widths the
        # logits are nearly flat, so walk_in_nucleus reads as the program.
        (base / "limits" / f"{name}.json").write_text(json.dumps(
            {"gap_max": {"limit": 0.005}, "gap_mean": {"limit": 0.0005},
             "nucleus_excess": {"limit": 0.005}, "logp_z": {"limit": 5.0},
             "short_requests": {"limit": 0}}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["workloads"] = cells
    path = base / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    base = tmp_path_factory.mktemp("tinybench")
    return base, make_tiny(base)
