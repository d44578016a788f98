"""What a run is: the cell of `BENCHMARK.json` and the files it names.

Every configuration, traffic mix, tree, limit, per-layer metric and model
family is a file of its own under `perfbench/`, found by name:

- `configs/<config>.json`: the pair's published blocks (`target`, `draft`),
  weights, stop tokens and sampling;
- `traffic/<traffic>.json`: the parameters of the general generator
  (`traffic.py`);
- `trees/<config>.<slots>.json`: the frozen growmap (`plan_trees.py`);
- `limits/<cell>.json`: the limit of each number `correct` compares, with the
  readings it was set from;
- `metrics/<name>.py` or `metrics/<name before the first dot>.py`: the reader
  of a per-layer metric (`read(run) -> float | None`);
- the three files of a model family, named by each block's HF `model_type`
  (draft and target may be of different families):
  - `families/<model_type>.py`, importing nothing of the program:
    `dims(block) -> dims`, the widths of the published block. `dims` has
    `vocab`, `hidden`, `tied` and `shape(leaf)` (a matrix's `[in, out]`), by
    which `gen.py` draws the family's leaves, and the work counts the readers
    call: `row_flops()`, the flops of one query row through every weight
    matrix; `attention(call)`, `(flops, bytes, launches)` of a
    `work.Call`'s attention; `matmuls()`, `(launches, [(K, N, output
    bytes), ...])` of the weight matrices a forward streams;
  - `reference/<model_type>.py`, importing nothing of the program: the plain
    float32 forward, `logits(dims, seed, role, formats, sequences, rows,
    device, controls_over)` (`judge.py`), drawing the weights again from
    `gen.py` and serving them by `reference/quant.py`;
  - `program/<model_type>.py`, the one family file that imports the
    program: `config(block, stop_tokens)`, the port's config; `make(dims,
    fmt, seed, role, device)`, the port's params, drawn on the device from
    `gen.py`; `fill(params, dims, seed, role)`, another seed's weights drawn
    into them in place.
  Family files import the benchmark's modules by absolute name
  (`from perfbench import gen`): they are loaded by path.

So a later cell, configuration, metric or model family is new files and new
entries in `BENCHMARK.json`, and no edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ROLES = ("draft", "target")
FAMILY_FILES = ("families", "reference", "program")
_FAMILY_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Model:
    """One model block of a configuration, read through its family's files."""

    family: str      # the block's model_type
    dims: object     # families/<family>.py::dims(block)
    base: Path       # the folder the family's files are under

    def reference(self) -> ModuleType:
        """`reference/<family>.py`, the plain forward."""
        return _module(self.base / "reference" / f"{self.family}.py",
                       f"perfbench_reference_{self.family}")

    def program(self) -> ModuleType:
        """`program/<family>.py`, which hands the model to the port."""
        return _module(self.base / "program" / f"{self.family}.py",
                       f"perfbench_program_{self.family}")


def models(config: dict, path: Path, base: Path = HERE) -> Dict[str, Model]:
    """The draft and target blocks of configuration file `path`, each through
    the family its `model_type` names."""
    out = {}
    for role in ROLES:
        family = config[role].get("model_type")
        if not isinstance(family, str) or not _FAMILY_NAME.match(family):
            raise ValueError(f"{path}: the {role} block names no model_type (HF's "
                             f"model_type of its config.json, such as \"llama\"); got "
                             f"{family!r}")
        missing = [f"{d}/{family}.py" for d in FAMILY_FILES
                   if not (base / d / f"{family}.py").exists()]
        if missing:
            raise FileNotFoundError(f"{path}: the {role} block's family {family!r} has no "
                                    f"{', '.join(missing)} under {base}")
        mod = _module(base / "families" / f"{family}.py", f"perfbench_family_{family}")
        out[role] = Model(family, mod.dims(config[role]), base)
    return out


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    tree_path: Path
    limits: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list
    models: Dict[str, Model]


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
    config_path = base / "configs" / f"{w['config']}.json"
    config = _load_json(config_path)
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        tree_path=base / "trees" / f"{w['config']}.{slots}.json",
        limits=_load_json(base / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        models=models(config, config_path, base),
    )


def metric_reader(name: str, base: Path = HERE):
    """The `read` function of per-layer metric `name`."""
    for stem in (name, name.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.exists():
            return _module(path, f"perfbench_metric_{stem}").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base / 'metrics'}")
