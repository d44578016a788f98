"""Benchmark / evaluation CLI of the port — the analog of the reference's
`tests/testbed.py` family, with the four verification algorithms behind
one `--algorithm` flag (port of `sequoia_tpu/cli/testbed.py`).

Prints the reference's metrics (tests/testbed.py:94,215): total time,
per-token latency, decoding steps, large-model steps, accepted/step.

Runs on the CUDA card (`--device cpu` only for small checks). Weights are
random, from `--seed`; prompts are `synthetic:N,LEN`. `--quant int8|int4`
quantizes the target's weights (random init straight into quantized
layers); `--kv-quant int8|int4` gives the target an int8 / int4 KV cache.
Offloading is not ported yet: its flag takes only its "off" value.

    python -m sequoia_torch.cli.testbed --mode spec
    python -m sequoia_torch.cli.testbed --mode spec --quant int8
    python -m sequoia_torch.cli.testbed --mode spec --kv-quant int4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_params(name: str, weights: str, dtype_str: str, seed: int, device=None,
                 quant_bits=None):
    """`(params, cfg)` for a preset with random weights. `quant_bits` (8 or
    4) gives an int-quantized model, initialized straight into quantized
    layers (`random_quantized_model`): a bf16 7B tree first would need both
    copies in memory at once."""
    from ..core import init as pinit
    from ..core.config import get_config

    if weights != "random":
        raise NotImplementedError("checkpoint loading is not ported yet; use random")
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_str]
    cfg = get_config(name)
    if quant_bits is not None:
        from ..quant.quantize import random_quantized_model

        return random_quantized_model(cfg, seed, bits=quant_bits, dtype=dtype,
                                      device=device), cfg
    return pinit.random_params(cfg, seed, dtype=dtype, device=device), cfg


def load_prompts(spec: str, vocab: int, seed: int):
    """`synthetic:N,LEN`: N prompts of LEN token ids drawn from `seed`."""
    if not spec.startswith("synthetic:"):
        raise NotImplementedError("only synthetic:N,LEN prompts are ported yet")
    n, ln = (int(x) for x in spec.split(":")[1].split(","))
    rng = np.random.default_rng(seed)
    return [rng.integers(10, vocab, size=ln) for _ in range(n)]


def load_growmap(spec: str):
    """`planned` | `tree:DxB` | `chain:N` | a growmap path (.json or .pt)."""
    from ..trees.growmap import GrowMap, chain, uniform_tree

    if spec.startswith("chain:"):
        return chain(int(spec.split(":")[1]))
    if spec.startswith("tree:"):
        d, b = (int(x) for x in spec.split(":")[1].split("x"))
        return uniform_tree(d, b)
    if spec == "planned":
        from ..planner.dp import plan
        from ..planner.profile import default_acceptance_vector

        # The same synthetic curve as the JAX testbed's; the card's measured
        # curves (planner/profile.py, chip_smoke.py phase 7) are in PERF.md.
        gm, _ = plan(
            default_acceptance_vector(), [1, 2, 4, 8, 16, 32, 64],
            [1.0, 1.0, 1.01, 1.02, 1.05, 1.1, 1.2], 0.05, max_depth=8,
        )
        return gm
    return GrowMap.load(spec)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--draft", default="llama-68m", help="preset name")
    ap.add_argument("--target", default="llama-2-7b")
    ap.add_argument("--draft-weights", default="random")
    ap.add_argument("--target-weights", default="random")
    ap.add_argument("--growmap", default="planned",
                    help="path | chain:N | tree:DxB | planned")
    ap.add_argument("--algorithm", default="sequoia",
                    choices=["sequoia", "specinfer", "greedy", "greedys"])
    ap.add_argument("--mode", default="spec", choices=["spec", "baseline", "benchmark"])
    ap.add_argument("--T", type=float, default=0.6)
    ap.add_argument("--P", type=float, default=0.9)
    ap.add_argument("--M", type=int, default=256, help="max buffer length")
    ap.add_argument("--gen", type=int, default=128, help="max new tokens/prompt")
    ap.add_argument("--prompts", default="synthetic:4,128", help="synthetic:N,LEN")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--quant", default="none", choices=["none", "int8", "int4"],
                    help="target weight quantization (random init goes "
                         "straight to quantized layers)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8", "int4"],
                    help="int8 / int4 target KV cache (per-row scales)")
    ap.add_argument("--offloading", action="store_true",
                    help="host-offloaded target weights (not ported yet)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for small checks")
    args = ap.parse_args(argv)
    if args.offloading:
        raise NotImplementedError("--offloading is not ported yet")

    from ..engine.baseline import ARBaseline
    from ..engine.engine import SpecEngine
    from ..utils import hard_sync, resolve_device

    device = resolve_device(args.device)
    target_params, target_cfg = build_params(
        args.target, args.target_weights, args.dtype, args.seed, device,
        quant_bits=None if args.quant == "none" else int(args.quant[3:]))
    prompts = load_prompts(args.prompts, target_cfg.vocab_size, args.seed)

    total_tokens = 0
    total_steps = 0
    t_total = 0.0
    if args.mode == "baseline":
        ar = ARBaseline(target_params, target_cfg, max_length=args.M,
                        temperature=args.T, top_p=args.P,
                        greedy=(args.algorithm == "greedy"), kv_quant=args.kv_quant,
                        device=device)
        ar.generate(prompts[0], max_new_tokens=4)  # warm up
        for i, prompt in enumerate(prompts):
            hard_sync(device)
            t0 = time.perf_counter()
            out = ar.generate(prompt, max_new_tokens=args.gen, seed=args.seed + i)
            t_total += time.perf_counter() - t0
            produced = len(out) - len(prompt)
            total_tokens += produced
            total_steps += produced
    else:
        draft_params, draft_cfg = build_params(
            args.draft, args.draft_weights, args.dtype, args.seed + 1, device)
        gm = load_growmap(args.growmap)
        eng = SpecEngine(draft_params, draft_cfg, target_params, target_cfg, gm,
                         algorithm=args.algorithm, max_length=args.M,
                         temperature=args.T, top_p=args.P, kv_quant=args.kv_quant,
                         device=device)
        phase_totals = {}
        bench = args.mode == "benchmark"
        eng.generate(prompts[0], max_new_tokens=4)  # warm up
        for i, prompt in enumerate(prompts):
            hard_sync(device)
            t0 = time.perf_counter()
            if bench:
                _, totals = eng.generate_benchmark(prompt, max_new_tokens=args.gen,
                                                   seed=args.seed + i)
                for k, v in totals.items():
                    phase_totals[k] = phase_totals.get(k, 0.0) + v
            else:
                eng.generate(prompt, max_new_tokens=args.gen, seed=args.seed + i)
            t_total += time.perf_counter() - t0
            total_tokens += eng.num_decoding_steps
            total_steps += eng.num_large_model_steps
        if phase_totals and total_steps:
            # Reference per-phase report (tests/testbed.py:216-218).
            print("phase breakdown (ms per target step):")
            for k, v in phase_totals.items():
                print(f"  {k}: {v / total_steps * 1e3:.2f}")

    # Reference metric block (tests/testbed.py:94).
    print(f"total time: {t_total:.3f}s")
    print(f"decoding steps (tokens): {total_tokens}")
    print(f"large model steps: {total_steps}")
    if total_tokens:
        print(f"per-token latency: {t_total / total_tokens * 1e3:.2f} ms")
    if total_steps:
        print(f"accepted tokens per target step: {total_tokens / total_steps:.3f}")


if __name__ == "__main__":
    main()
