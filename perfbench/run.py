"""The benchmark of sequoia_torch on an NVIDIA H100: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `BENCHMARK.json`; its configuration, traffic, tree
and limits are files under `perfbench/` (`spec.py`). The run makes the
weights on the card from the seed, builds the engines and warms up every
shape the window uses (the set-up, `setup_s`), drives the traffic for
`--seconds` seconds (whole cycles of requests or whole batches), and then
judges a sample of the greedy and the sampled requests it served against the
plain reference (`judge.py`). The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
ones), `device`, with `--trace 1` `breakdown`, and last `checks`, each
number compared beside its limit. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 2. If JAX or the JAX
package is loaded when the window has closed, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sequoia_tpu")


def _pin_caches() -> None:
    """Every cache a run may write, at fixed paths inside the checkout."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list:
    """The modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in modules if m.split(".")[0] in FORBIDDEN})


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.spec import load_cell

    workloads = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    chips = next((int(w["chips"]) for w in workloads if w["name"] == args.workload), None)
    if chips is None:
        print(f"perfbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found; "
              "no result", file=sys.stderr)
        return 2
    from perfbench.result import measure

    cell = load_cell(args.workload)
    line = measure(cell, args.seed, args.seconds, bool(args.trace), T_START,
                   power_limit_w())
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
