"""What a run is: the cell of `BENCHMARK.json` and the files it names.

Every configuration, traffic mix, tree, limit and per-layer metric is a file
of its own under `perfbench/`, found by name:

- `configs/<config>.json`: the pair's published values, weights, stop tokens
  and sampling;
- `traffic/<traffic>.json`: the parameters of the general generator
  (`traffic.py`);
- `trees/<config>.<slots>.json`: the frozen growmap (`plan_trees.py`);
- `limits/<cell>.json`: the limit of each number `correct` compares, with the
  readings it was set from;
- `metrics/<name>.py` or `metrics/<name before the first dot>.py`: the reader
  of a per-layer metric (`read(run) -> float | None`).

So a later cell, configuration or metric is new files and new entries in
`BENCHMARK.json`, and no edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    tree_path: Path
    limits: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[Path] = None, base: Path = HERE) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its files under `base`."""
    bench = _load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    traffic = _load_json(base / "traffic" / f"{w['traffic']}.json")
    slots = int(traffic.get("slots", 1))
    return Cell(
        name=name,
        config=_load_json(base / "configs" / f"{w['config']}.json"),
        traffic=traffic,
        tree_path=base / "trees" / f"{w['config']}.{slots}.json",
        limits=_load_json(base / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str, base: Path = HERE):
    """The `read` function of per-layer metric `name`."""
    for stem in (name, name.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"perfbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base / 'metrics'}")
