"""The benchmark is driven by data: BENCHMARK.json keeps to its contract,
every file a cell names is there, every model block names a family whose
files are there, and a new configuration, traffic mix, tree and per-layer
metric are found by name from new files alone (a new family:
`test_perfbench_families.py`)."""

import json
import re
import shutil
import time
from pathlib import Path

from perfbench import spec
from perfbench.result import RunData, _per_layer, measure
from perfbench.spec import load_cell, metric_reader
from sequoia_torch.trees.growmap import uniform_tree

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        names.add(c["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        metric_reader(m["name"])
    cells = {w["name"]: w for w in b["workloads"]}
    for name, w in cells.items():
        assert NAME.match(name) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = load_cell(name)   # config, traffic, tree and limits are there
        assert cell.tree_path.exists(), cell.tree_path
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in cells.values())


def test_every_block_names_a_family_with_its_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for role in spec.ROLES:
            family = cfg[role]["model_type"]
            for folder in spec.FAMILY_FILES:
                assert (ROOT / "perfbench" / folder / f"{family}.py").exists(), (c, role)
        found = spec.models(cfg, ROOT / c["file"])
        assert {r: m.family for r, m in found.items()} == {
            r: cfg[r]["model_type"] for r in spec.ROLES}


def test_a_new_cell_is_new_files_and_entries(tiny, tmp_path):
    base = tmp_path / "copy"
    shutil.copytree(tiny[0], base)
    cfg = json.loads((base / "configs" / "tiny.json").read_text())
    cfg["name"] = "dummy"
    (base / "configs" / "dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "single.json").read_text())
    mix["sampled_per_cycle"] = 2
    (base / "traffic" / "dummymix.json").write_text(json.dumps(mix))
    uniform_tree(1, 3).to_json(str(base / "trees" / "dummy.1.json"))
    (base / "limits" / "dummy.dummymix.json").write_text(
        (base / "limits" / "tiny.single.json").read_text())
    (base / "metrics" / "dummy_tokens.py").write_text(
        "def read(run):\n    return float(sum(len(s.tokens) for s in run.window.served))\n")
    b = json.loads((base / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "dummy.dummymix", "config": "dummy",
                           "traffic": "dummymix", "chips": 1, "why": "test"})
    b["per_layer"] = [{"name": "dummy_tokens.x", "unit": "tokens", "better": "higher",
                       "source": "program_counter", "layer": "entry",
                       "moves": "ms_per_token"}]
    (base / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("dummy.dummymix", base / "BENCHMARK.json", base)
    assert cell.tree_path == base / "trees" / "dummy.1.json"
    assert cell.traffic["sampled_per_cycle"] == 2
    line = measure(cell, 5, 0.2, False, time.perf_counter(), None, device="cpu")
    assert line["correct"], line["checks"]
    data = type("D", (), {"window": None})()
    from perfbench.drive import Bench

    bench = Bench(cell, 5, "cpu")
    data.window = bench.run_window(0.1)
    got = {m["name"]: metric_reader(m["name"], base)(data) for m in cell.per_layer}
    assert got["dummy_tokens.x"] > 0
    assert RunData and _per_layer   # the readers are found through these in a traced run
