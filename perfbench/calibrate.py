"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 11 12 13 ... \
        [--controls int8 fp8] [--fault walk_in_nucleus]

Builds the cell once, then for each seed draws that seed's weights into the
same tensors, serves the requests a run judges (of the window's first cycle
or batch, every greedy request and the first sampled ones, at the cell's
own load: one client, or every slot busy) and reads from the plain
reference every number `judge.py` compares: the program's readings, the
lower ends of the limits. The greedy numbers are read for each control too,
the reference in a lower precision (default: the configuration's
`control_weights`), and with `--fault` the program runs with that fault of
`faults.py` planted: the upper ends. One JSON line a seed. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=None,
                    help="weight formats of the controls (default: the config's)")
    ap.add_argument("--fault", default=None, help="a fault of perfbench/faults.py to plant")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import faults
    from perfbench.drive import Bench
    from perfbench.judge import readings, samples
    from perfbench.spec import load_cell

    if args.fault:
        faults.plant(args.fault)
    cell = load_cell(args.workload)
    controls = args.controls if args.controls is not None else [cell.config["control_weights"]]
    bench = Bench(cell, args.seeds[0])
    bench.warm_up()
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if i:
            bench.reseed(seed)
        win = bench.run_window(0.0, seed=seed, check_only=True)
        r = readings(cell, seed, *samples(cell, win.served, seed), "cuda", controls)
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault, **r,
                          "served": [len(s.tokens) for s in win.served],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
