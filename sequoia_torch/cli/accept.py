"""Acceptance-vector measurement CLI of the port (port of
`sequoia_tpu/cli/accept.py`): the analog of the reference's
`tests/test_accept.py` (dynamic: the engine on a star tree) and
`tests/fast_test.py` (static: teacher-forced). Saves the vector as JSON,
which `cli/tree_search.py` reads.

Runs on the CUDA card (`--device cpu` only for small checks). Weights are
random from `--seed` or a HF checkpoint directory (`--draft-weights DIR`,
`--target-weights DIR`); prompts as the testbed takes them.

    python -m sequoia_torch.cli.accept --method dynamic --prompts jsonl:sequoia_tpu/data/bundled/c4_small.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .testbed import build_params, load_prompts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--draft", default="llama-68m")
    ap.add_argument("--target", default="llama-2-7b")
    ap.add_argument("--draft-weights", default="random")
    ap.add_argument("--target-weights", default="random")
    ap.add_argument("--method", choices=["static", "dynamic"], default="static")
    ap.add_argument("--mode", choices=["stochastic", "greedy"], default="stochastic",
                    help="dynamic protocol: SpecTreeTest vs GreedyTreeTest "
                         "(tests/test_accept.py --Mode)")
    ap.add_argument("--W", type=int, default=8, help="max rank / star width")
    ap.add_argument("--T", type=float, default=0.6)
    ap.add_argument("--P", type=float, default=0.9)
    ap.add_argument("--DP", type=float, default=0.99, help="draft top-p (static)")
    ap.add_argument("--prompts", default="synthetic:4,96")
    ap.add_argument("--steps", type=int, default=64, help="steps/prompt (dynamic)")
    ap.add_argument("--M", type=int, default=256)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--dst", default="acceptance-rate-vector.json")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for small checks")
    args = ap.parse_args(argv)

    from ..planner.acceptance import dynamic_acceptance, static_acceptance
    from ..utils import resolve_device

    device = resolve_device(args.device)
    target_params, target_cfg = build_params(args.target, args.target_weights, args.dtype,
                                             args.seed, device)
    draft_params, draft_cfg = build_params(args.draft, args.draft_weights, args.dtype,
                                           args.seed + 1, device)
    data = load_prompts(args.prompts, target_cfg.vocab_size, args.seed)

    if args.method == "static":
        vec = static_acceptance(
            draft_params, draft_cfg, target_params, target_cfg, data,
            k=args.W, temperature=args.T, top_p=args.P, draft_top_p=args.DP,
            seed=args.seed)
    else:
        vec = dynamic_acceptance(
            draft_params, draft_cfg, target_params, target_cfg, data,
            width=args.W, steps_per_prompt=args.steps, temperature=args.T, top_p=args.P,
            max_length=args.M, seed=args.seed,
            algorithm={"stochastic": "sequoia", "greedy": "greedy"}[args.mode])
    print("acceptance vector:", np.round(vec, 4).tolist())
    with open(args.dst, "w") as f:
        json.dump({"vector": vec.tolist(), "method": args.method, "draft": args.draft,
                   "target": args.target, "T": args.T, "top_p": args.P}, f, indent=1)
    print(f"saved -> {args.dst}")


if __name__ == "__main__":
    main()
