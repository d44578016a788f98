"""Plan each configuration's frozen tree once, on the card, with the port's
own planner, and write it to `perfbench/trees/<config>.<slots>.json`.

    python3 perfbench/plan_trees.py --config smollm2-1.7b --slots 1 32 --seed 7

For each configuration: the seeded pair's acceptance vector
(`planner/acceptance.py::static_acceptance` over sequences of the traffic's
random token ids, at the configuration's temperature and top-p), then for
each slot count the card's latency curve (`planner/profile.py`: the
target's split-mode forward at each tree width, over `slots` slots, and the
draft's at width 8), and `planner/dp.py::plan`. The file holds the growmap
and, under `planning`, the vector, the curve and the plan. No run of the
benchmark plans again: the runs read the file.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Per slot count: the tree widths timed and planned among, and the context
# (rows already in the cache) and buffer the curve is timed at, near the
# traffic's. At 32 slots the plan is among trees of 32 and 64 nodes, where
# the verify's tree attention runs the slot-axis Hopper kernel (Q > 16): on
# the random pair the planner's free choice there is the 1-node tree, a
# batched AR step with a re-draft, which leaves that kernel and the tree out.
CURVES = {1: dict(budgets=(1, 2, 4, 8, 16, 32, 64, 128), kv_len=512, max_length=2048),
          8: dict(budgets=(1, 2, 4, 8, 16, 32, 64, 128), kv_len=512, max_length=2048),
          32: dict(budgets=(32, 64), kv_len=320, max_length=1024)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--slots", type=int, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--out", default=str(ROOT / "perfbench" / "trees"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from perfbench import traffic
    from perfbench.spec import ROLES, models
    from sequoia_torch.planner.acceptance import static_acceptance
    from sequoia_torch.planner.dp import plan
    from sequoia_torch.planner.profile import measure_latency_curve
    from sequoia_torch.quant.qtensor import set_w8a8

    path = ROOT / "perfbench" / "configs" / f"{args.config}.json"
    cfg = json.loads(path.read_text())
    set_w8a8("off")
    blocks = models(cfg, path)
    dims = {r: m.dims for r, m in blocks.items()}
    programs = {r: m.program() for r, m in blocks.items()}
    stop = cfg["stop_tokens"]
    params = {r: programs[r].make(dims[r], cfg["weights"][r], args.seed, r, "cuda")
              for r in ROLES}
    cfgs = {r: programs[r].config(cfg[r], stop) for r in ROLES}
    rng = np.random.default_rng([args.seed, 5])
    seqs = [traffic.prompt_tokens(rng, args.length, dims["target"].vocab, stop)
            for _ in range(args.sequences)]
    s = cfg["sampling"]
    vec = static_acceptance(params["draft"], cfgs["draft"], params["target"], cfgs["target"],
                            seqs, k=8, temperature=s["temperature"], top_p=s["top_p"],
                            seed=args.seed)
    print(f"{args.config}: acceptance vector {np.round(vec, 4).tolist()}", flush=True)
    for slots in args.slots:
        c = CURVES[slots]
        budgets, target_time, draft_time = measure_latency_curve(
            params["draft"], cfgs["draft"], params["target"], cfgs["target"],
            budgets=c["budgets"], max_length=c["max_length"], kv_len=c["kv_len"],
            batch=slots)
        gm, info = plan(vec, budgets, target_time, draft_time, max_branch=8)
        path = Path(args.out) / f"{args.config}.{slots}.json"
        gm.to_json(str(path))
        d = json.loads(path.read_text())
        d["planning"] = {"seed": args.seed, "vector": vec.tolist(), "budgets": list(budgets),
                         "target_time_s": target_time, "draft_time_s": draft_time,
                         "kv_len": c["kv_len"], "max_length": c["max_length"],
                         "device": torch.cuda.get_device_name(0), **info}
        path.write_text(json.dumps(d))
        print(f"{args.config} slots {slots}: curve ms "
              f"{[round(t * 1e3, 4) for t in target_time]} draft {draft_time * 1e3:.4f} ms; "
              f"plan {info}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
