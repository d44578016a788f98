"""The idle time of one cell's traced window, split by what the program's
host was in.

    python3 perfbench/idle_split.py --workload <name> --seed <n> --seconds <s>

Sets the cell up and runs its window traced as `run.py --trace 1` does, then
prints one JSON line: `window_s`, the traced window; `idle_s`, its seconds
with no kernel or copy running; `split_s`, those seconds by
`metrics/_spans.py::idle_split` (`launch`: inside a `cudaGraphLaunch`; then
the innermost span of the program; `none`: outside every span); and
`metrics`, the cell's per-layer readings. It judges nothing. The window runs
whole cycles or batches, so a `--seconds` of 1 runs one. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.run import _pin_caches

    _pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card; no result", file=sys.stderr)
        return 2
    from perfbench.drive import Bench
    from perfbench.metrics._spans import idle_split
    from perfbench.result import RunData, _per_layer
    from perfbench.spec import load_cell
    from perfbench.trace import idle_gaps, union_seconds

    cell = load_cell(args.workload)
    bench = Bench(cell, args.seed)
    bench.warm_up()
    bench.arm_trace(float(cell.traffic.get("trace_seconds", 3.0)) if bench.batched else None)
    data = RunData(cell, bench, bench.run_window(args.seconds))
    line = {"window_s": data.trace_s, "idle_s": None, "split_s": idle_split(data),
            "metrics": {k: v["value"] for k, v in _per_layer(cell, data).items()}}
    if data.kernels and data.trace_s:
        t0 = min(a for _, a, _ in data.kernels)
        gaps = idle_gaps([(a, b) for _, a, b in data.kernels], t0, t0 + data.trace_s)
        line["idle_s"] = union_seconds(gaps)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
