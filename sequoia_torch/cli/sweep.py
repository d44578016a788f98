"""Benchmark sweep runner of the port (port of `sequoia_tpu/cli/sweep.py`):
the analog of the reference's shell sweeps (`tests/run_L40.sh`,
`tests/run_A100.sh` over draft/target x dataset x mode; `tests/run.sh` over
fixed k x d SpecInfer trees; `tests/run_wiki.sh` long-prefill `--S`
sweeps), driven from one CLI.

Each grid point runs the port's testbed (`cli/testbed.py::main`) in this
process and appends one JSON line to `--log` (the reference's
`resultsv2.log`, machine-readable); a point that fails is logged with its
error and the sweep goes on.

    python -m sequoia_torch.cli.sweep --algorithms sequoia,greedy --growmaps planned,tree:4x2
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import re
import sys
import time
import traceback


def parse_metrics(out: str) -> dict:
    """The testbed's printed metric block as a dict."""
    m = {}
    pats = {
        "total_time_s": r"total time: ([\d.]+)s",
        "tokens": r"decoding steps \(tokens\): (\d+)",
        "large_model_steps": r"large model steps: (\d+)",
        "ms_per_token": r"per-token latency: ([\d.]+) ms",
        "accepted_per_step": r"accepted tokens per target step: ([\d.]+)",
    }
    for k, pat in pats.items():
        hit = re.search(pat, out)
        if hit:
            v = hit.group(1)
            m[k] = float(v) if "." in v else int(v)
    return m


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", default="llama-68m:llama-2-7b",
                    help="comma-separated draft:target preset pairs")
    ap.add_argument("--algorithms", default="sequoia,greedy")
    ap.add_argument("--growmaps", default="planned",
                    help="comma-separated growmap specs (path|chain:N|tree:DxB|planned)")
    ap.add_argument("--prompts", default="synthetic:4,128")
    ap.add_argument("--modes", default="spec", help="spec,baseline,benchmark")
    ap.add_argument("--M", type=int, default=256)
    ap.add_argument("--gen", type=int, default=128)
    ap.add_argument("--T", type=float, default=0.6)
    ap.add_argument("--P", type=float, default=0.9)
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for small checks")
    ap.add_argument("--log", default="results.jsonl")
    args = ap.parse_args(argv)

    from .testbed import main as testbed_main

    pairs = [p.split(":") for p in args.pairs.split(",")]
    grid = list(itertools.product(pairs, args.algorithms.split(","),
                                  args.growmaps.split(","), args.modes.split(",")))
    print(f"sweep: {len(grid)} grid points -> {args.log}")
    for (draft, target), algo, gm, mode in grid:
        point = dict(draft=draft, target=target, algorithm=algo, growmap=gm, mode=mode)
        print(f"--- {point}")
        buf = io.StringIO()
        t0 = time.time()
        argv_point = [
            "--draft", draft, "--target", target, "--algorithm", algo, "--growmap", gm,
            "--mode", mode, "--M", str(args.M), "--gen", str(args.gen), "--T", str(args.T),
            "--P", str(args.P), "--dtype", args.dtype, "--seed", str(args.seed),
            "--prompts", args.prompts,
        ] + (["--device", args.device] if args.device else [])
        try:
            with contextlib.redirect_stdout(buf):
                testbed_main(argv_point)
            record = {**point, **parse_metrics(buf.getvalue()),
                      "wall_s": round(time.time() - t0, 2)}
        except Exception as e:  # the sweep's boundary: log the point's failure, go on
            traceback.print_exc()
            record = {**point, "error": f"{type(e).__name__}: {e}"}
        sys.stdout.write(buf.getvalue())
        with open(args.log, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(json.dumps(record))


if __name__ == "__main__":
    main()
