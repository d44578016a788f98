"""Offline planner CLI of the port (port of `sequoia_tpu/cli/tree_search.py`),
the analog of the reference `tree_search.py`. Host only: it reads
measurements and runs the DP (the native table when `g++` can build it).

Reads the reference's JSON config schema (`demo-config.json:1-9`):
  acceptance_rate_vector (path to .pt, .json, or "default"),
  max_depth, max_budget, draft_time, valid_budget, target_time, dst.
`valid_budget` / `target_time` / `draft_time` are the card's latency curve
(`planner/profile.py::measure_latency_curve`, seconds). Writes the growmap
as JSON (`dst` ending in .json) or as a reference-compatible torch dict
(`dst` ending in .pt).

    python -m sequoia_torch.cli.tree_search --config demo-config.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_acceptance_vector(spec: str) -> np.ndarray:
    """The planner's vector from a `cli/accept.py` JSON, a torch `.pt`
    tensor, or "default" (the bundled 68m->7b one). The trailing element is
    dropped, as the reference does (`tree_search.py:14`)."""
    if spec == "default":
        from ..planner.profile import default_acceptance_vector

        return default_acceptance_vector()
    if spec.endswith(".json"):
        with open(spec) as f:
            d = json.load(f)
        v = np.asarray(d["vector"] if isinstance(d, dict) else d, np.float64)
    else:
        import torch

        v = np.asarray(torch.load(spec, map_location="cpu", weights_only=True), np.float64)
    return v[:-1]


def save_growmap(gm, dst: str) -> None:
    if dst.endswith(".json"):
        gm.to_json(dst)
        return
    import torch

    torch.save({
        "roots": gm.roots,
        "branches": gm.branches,
        "Successors": gm.successors,
        "mask": torch.from_numpy(gm.ancestors.astype(np.int64)),
        "depth": torch.from_numpy(np.asarray(gm.depth, np.int64)),
        "size": gm.size,
    }, dst)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", type=str, required=True)
    args = ap.parse_args(argv)

    from ..planner.dp import plan

    with open(args.config) as f:
        cfg = json.load(f)
    p = load_acceptance_vector(cfg["acceptance_rate_vector"])
    gm, info = plan(p, cfg["valid_budget"], cfg["target_time"], cfg["draft_time"],
                    max_depth=cfg["max_depth"], max_budget=cfg.get("max_budget"))
    print(f"budget={info['budget']} depth={info['depth']} "
          f"E[accepted]={info['expected_accepted']:.4f} "
          f"dec_time={info['dec_time']:.4f} "
          f"speedup_vs_budget1={info['speedup_vs_target_time0']:.3f}")
    save_growmap(gm, cfg["dst"])
    print(f"saved growmap ({gm.size} nodes) -> {cfg['dst']}")


if __name__ == "__main__":
    main()
