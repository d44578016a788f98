"""Model families are found by a block's `model_type`, from files alone.

The Llama family behind `families/`, `reference/` and `program/` reads what
the harness read before families existed: the numbers below are the
harness's own from then, on the same CPU runs, compared exactly. A second
family made of new files in a copy of the benchmark runs, and is judged by
its own reference."""

import hashlib
import json
import shutil
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import work
from perfbench.drive import Bench
from perfbench.judge import readings, samples
from perfbench.result import measure
from perfbench.spec import load_cell, metric_reader, models

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977

# Of the tiny cells (`conftest.py`) at SEED: the sha256 of each model's
# params, of the tokens the calibration's requests were served, and the
# judge's readings of them with the configuration's control.
PARENT = {
    "tiny.single": {
        "weights": {"draft": "2612aaa83560466940ef38fb84be52e10b8b9678fdfd0c9a68b457c011112f38",
                    "target": "27e3cf8d5cf953b9b8d8a41435d0fad118492bf464ca456778a798e3298f9dcc"},
        "tokens": "d8f026664b7d2a851efcf25cf72bcce6afeb6e59c7f76ccc609f555a6a394390",
        "readings": {"gap_max": 0.0, "gap_mean": 0.0, "nucleus_excess": -0.002750342116592752,
                     "logp_z": 1.095062536497201, "greedy_tokens": 23, "sampled_tokens": 73,
                     "control_gap_max.fp8": 0.020840823650360107,
                     "control_gap_mean.fp8": 0.0018696862971410155}},
    "tiny.batched2": {
        "weights": {"draft": "2612aaa83560466940ef38fb84be52e10b8b9678fdfd0c9a68b457c011112f38",
                    "target": "27e3cf8d5cf953b9b8d8a41435d0fad118492bf464ca456778a798e3298f9dcc"},
        "tokens": "6a99f6062ad385c380326c93ab01bca40a7a513240bdde663e7fd3590c8e13c3",
        "readings": {"gap_max": 0.0011324286460876465, "gap_mean": 3.538839519023895e-05,
                     "nucleus_excess": -0.09180835960976896, "logp_z": 1.5765836727644105,
                     "greedy_tokens": 32, "sampled_tokens": 48,
                     "control_gap_max.fp8": 0.011142611503601074,
                     "control_gap_mean.fp8": 0.0007107798010110855}},
    "tiny8.single": {
        "weights": {"draft": "2612aaa83560466940ef38fb84be52e10b8b9678fdfd0c9a68b457c011112f38",
                    "target": "8bad967dcdc29696dc3530840ff042470f7115aad2c338c9b90faca7b04aa394"},
        "tokens": "da92c3c6ad7506b97472583f8c2d951645d2f94df75bee6f32a89651e56f8a4c",
        "readings": {"gap_max": 0.0, "gap_mean": 0.0, "nucleus_excess": -0.01112816827938301,
                     "logp_z": 0.5787648292586569, "greedy_tokens": 23, "sampled_tokens": 74,
                     "control_gap_max.int4": 0.09880566596984863,
                     "control_gap_mean.int4": 0.02881898544728756}},
    "tiny8.batched2": {
        "weights": {"draft": "2612aaa83560466940ef38fb84be52e10b8b9678fdfd0c9a68b457c011112f38",
                    "target": "8bad967dcdc29696dc3530840ff042470f7115aad2c338c9b90faca7b04aa394"},
        "tokens": "8f9a201ec3404eb1055f42b36499b5f26e3bd799ed16fd470cc393d09b7f93bc",
        "readings": {"gap_max": 0.0014809370040893555, "gap_mean": 4.627928137779236e-05,
                     "nucleus_excess": -0.0908152635938776, "logp_z": 1.5752185163895254,
                     "greedy_tokens": 32, "sampled_tokens": 48,
                     "control_gap_max.int4": 0.20090341567993164,
                     "control_gap_mean.int4": 0.032012876123189926}},
}

# The work readers over SNAPS at the real configurations' widths, with one
# kernel of every pattern taking the whole traced second (so each reading is
# its work's bound, in % of a second), the target served int8.
SNAPS = [("prefill", 300), ("before", 310), ("after", 312), ("before", [400, 50, 700]),
         ("after", [402, 50, 705]), ("admit", [[0, 300, 1], [128, 300, 1], [0, 64, 0]]),
         ("before", [20, 30]), ("after", [21, 33])]
PARENT_WORK = {
    ("yi-34b-int8", "yi-34b-int8.8"): {"step_mfu": 4.808611681378362,
                                       "attn_roofline": 0.06663201623880596,
                                       "qmm_roofline": 7.994845900334847},
    ("smollm2-1.7b", "smollm2-1.7b.32"): {"step_mfu": 0.27061161974681497,
                                          "attn_roofline": 0.025315664238805973,
                                          "qmm_roofline": 0.42938442293353457},
    ("smollm2-1.7b", "smollm2-1.7b.1"): {"step_mfu": 0.22487299768816987,
                                         "attn_roofline": 0.02254536214925373,
                                         "qmm_roofline": 0.4205664074111465},
}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            yield from _leaves(getattr(x, f))


def _sha(params) -> str:
    h = hashlib.sha256()
    for t in _leaves(params):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_weights_tokens_and_readings_as_before(tiny, name):
    base, bench_json = tiny
    cell = load_cell(name, bench_json, base)
    want = PARENT[name]
    bench = Bench(cell, SEED, "cpu")
    assert {r: _sha(p) for r, p in bench.params.items()} == want["weights"]
    win = bench.run_window(0.0, seed=SEED, check_only=True)
    served = b"".join(np.asarray(s.tokens, np.int64).tobytes() for s in win.served)
    assert hashlib.sha256(served).hexdigest() == want["tokens"]
    got = readings(cell, SEED, *samples(cell, win.served, SEED), "cpu",
                   [cell.config["control_weights"]])
    assert got == want["readings"]


@pytest.mark.parametrize("config,tree", sorted(PARENT_WORK))
def test_work_counts_as_before(config, tree):
    path = ROOT / "perfbench" / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    run = types.SimpleNamespace(
        calls=work.from_snaps(SNAPS, work.Tree.load(ROOT / "perfbench" / "trees" /
                                                    f"{tree}.json"), 128),
        kernels=[("tree_attention qmm8_sm90", 0.0, 1.0)], trace_s=1.0,
        dims={r: m.dims for r, m in models(cfg, path).items()},
        formats={"target": "int8", "draft": "bf16"}, cell=types.SimpleNamespace(config=cfg))
    got = {m: metric_reader(f"{m}.x")(run) for m in PARENT_WORK[config, tree]}
    assert got == PARENT_WORK[config, tree]


# A second family: Llama's block under GPT-2's key names. Its program side
# is the port's Llama path.
TOYFAM = {
    "families": '''
from perfbench.families import llama


def dims(hf):
    return llama.Dims(vocab=hf["vocab_size"], hidden=hf["n_embd"], intermediate=hf["n_inner"],
                      layers=hf["n_layer"], heads=hf["n_head"], kv_heads=hf["n_head"],
                      head_dim=hf["n_embd"] // hf["n_head"], rope_theta=10000.0, eps=1e-5,
                      tied=False)
''',
    "reference": '''
from perfbench.reference.llama import logits
''',
    "program": '''
from perfbench.program.llama import fill, make
from sequoia_torch.core.config import LlamaConfig


def config(hf, stop_tokens):
    return LlamaConfig(vocab_size=hf["vocab_size"], hidden_size=hf["n_embd"],
                       intermediate_size=hf["n_inner"], num_layers=hf["n_layer"],
                       num_heads=hf["n_head"], num_kv_heads=hf["n_head"],
                       max_position_embeddings=hf["n_positions"],
                       stop_tokens=tuple(stop_tokens))
''',
}
# The same, with every logit moved one token along the vocabulary.
WRONG_REFERENCE = '''
from perfbench.reference import llama


def logits(*args, **kwargs):
    return [[x.roll(1, dims=-1) for x in f] for f in llama.logits(*args, **kwargs)]
'''


def _toy_bench(tiny, tmp_path, reference=TOYFAM["reference"]):
    """A copy of the tiny benchmark with the family `toyfam` and a cell
    `toy.single` whose target is of it and whose draft is a Llama."""
    base = tmp_path / "copy"
    shutil.copytree(tiny[0], base)
    for folder, text in {**TOYFAM, "reference": reference}.items():
        (base / folder / "toyfam.py").write_text(text)
    cfg = json.loads((base / "configs" / "tiny.json").read_text())
    cfg["name"] = "toy"
    cfg["target"] = {"model_type": "toyfam", "n_embd": 128, "n_inner": 256, "n_layer": 2,
                     "n_head": 4, "vocab_size": 512, "n_positions": 512}
    (base / "configs" / "toy.json").write_text(json.dumps(cfg))
    shutil.copy(base / "trees" / "tiny.1.json", base / "trees" / "toy.1.json")
    shutil.copy(base / "limits" / "tiny.single.json", base / "limits" / "toy.single.json")
    b = json.loads((base / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "toy.single", "config": "toy", "traffic": "single",
                           "chips": 1, "why": "test"})
    (base / "BENCHMARK.json").write_text(json.dumps(b))
    return load_cell("toy.single", base / "BENCHMARK.json", base)


def test_a_second_family_is_new_files(tiny, tmp_path):
    cell = _toy_bench(tiny, tmp_path)
    assert {r: m.family for r, m in cell.models.items()} == {"draft": "llama",
                                                             "target": "toyfam"}
    assert cell.models["target"].dims.hidden == 128
    line = measure(cell, SEED, 0.2, False, time.perf_counter(), None, device="cpu")
    assert line["correct"], line["checks"]


def test_the_judge_reads_the_target_family_reference(tiny, tmp_path):
    cell = _toy_bench(tiny, tmp_path, reference=WRONG_REFERENCE)
    line = measure(cell, SEED, 0.2, False, time.perf_counter(), None, device="cpu")
    assert not line["correct"]
    assert line["checks"]["gap_max"]["value"] > line["checks"]["gap_max"]["limit"]


@pytest.mark.parametrize("block,error,says", [
    ({}, ValueError, "names no model_type"),
    ({"model_type": "../llama"}, ValueError, "names no model_type"),
    ({"model_type": "mamba"}, FileNotFoundError, "families/mamba.py, reference/mamba.py, "
                                                 "program/mamba.py"),
])
def test_a_block_without_a_family_stops_the_run(block, error, says):
    path = ROOT / "perfbench" / "configs" / "smollm2-1.7b.json"
    cfg = json.loads(path.read_text())
    cfg["draft"] = {k: v for k, v in cfg["draft"].items() if k != "model_type"} | block
    with pytest.raises(error, match=str(path)) as e:
        models(cfg, path)
    assert says in str(e.value) and "draft" in str(e.value)
