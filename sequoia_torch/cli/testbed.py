"""Benchmark / evaluation CLI of the port — the analog of the reference's
`tests/testbed.py` family, with the four verification algorithms behind
one `--algorithm` flag (port of `sequoia_tpu/cli/testbed.py`).

Prints the reference's metrics (tests/testbed.py:94,215): total time,
per-token latency, decoding steps, large-model steps, accepted/step. As
JAX's testbed does, `--mode spec` and `--mode baseline` time `generate_fast`
(the loop on the device: CUDA-graph replays, one host read per block), and
`--mode benchmark` times `generate_benchmark`, whose iterations go through
`iterate_phased` (the phase graphs with CUDA events between them).

Runs on the CUDA card (`--device cpu` only for small checks). Weights are
random, from `--seed`, or a HF checkpoint directory (`--target-weights
DIR`, `--draft-weights DIR`, or the directory as the model name with
`auto`); prompts are `synthetic:N,LEN`, a pre-tokenized `jsonl:PATH` /
`arrow:PATH`, or a JSON file of token-id lists. `--quant int8|int4`
quantizes the target's weights (random init straight into quantized
layers); `--kv-quant int8|int4` gives the target an int8 / int4 KV cache.
`--offloading --staylayer N` keeps the target's first N layers on the card
and streams the rest from pinned host memory (`engine/offload.py`); random
weights are then built straight into host memory, so a target larger than
the card (llama-2-70b) runs.

    python -m sequoia_torch.cli.testbed --mode spec
    python -m sequoia_torch.cli.testbed --mode spec --quant int8
    python -m sequoia_torch.cli.testbed --mode spec --kv-quant int4
    python -m sequoia_torch.cli.testbed --mode spec --offloading --staylayer 16
    python -m sequoia_torch.cli.testbed --draft-weights CKPT_DIR --end 4 --prompts jsonl:sequoia_tpu/data/bundled/c4_small.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_params(name_or_path: str, weights: str, dtype_str: str, seed: int, device=None,
                 quant_bits=None, stay_layers=None):
    """`(params, cfg)` from a preset name or a HF checkpoint directory.

    `weights`: "random" (random init from `seed`, on the device), "auto"
    (the checkpoint's weights when `name_or_path` is a checkpoint
    directory, else random), a checkpoint directory, or a torch state-dict
    file. `quant_bits` (8 or 4) gives an int-quantized model; random init
    goes straight into quantized layers (`random_quantized_model`): a bf16
    7B tree first would need both copies in memory at once. `stay_layers`
    (not None) gives a host-offloaded model with that many layers on the
    device: random init builds the streamed stacks in host memory
    (`random_offloaded_params`), a checkpoint is read on the host and
    offloaded from there (`offload_params`)."""
    import os

    from ..core import init as pinit
    from ..core.config import PRESETS, LlamaConfig, get_config
    from ..engine.offload import offload_params, random_offloaded_params

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_str]
    is_ckpt_dir = os.path.isdir(name_or_path) and os.path.exists(
        os.path.join(name_or_path, "config.json"))
    if name_or_path in PRESETS:
        cfg = get_config(name_or_path)
    elif is_ckpt_dir:
        cfg = LlamaConfig.from_json(os.path.join(name_or_path, "config.json"))
    else:
        raise ValueError(f"{name_or_path!r} is neither a preset nor a checkpoint dir")
    if weights == "random" or (weights == "auto" and not is_ckpt_dir):
        if stay_layers is not None:
            return random_offloaded_params(cfg, seed, bits=quant_bits, dtype=dtype,
                                           stay_layers=stay_layers, device=device), cfg
        if quant_bits is not None:
            from ..quant.quantize import random_quantized_model

            return random_quantized_model(cfg, seed, bits=quant_bits, dtype=dtype,
                                          device=device), cfg
        return pinit.random_params(cfg, seed, dtype=dtype, device=device), cfg
    load_on = device if stay_layers is None else "cpu"
    if weights == "auto":
        params, cfg = pinit.load_hf_checkpoint(name_or_path, dtype=dtype, device=load_on)
    elif os.path.isdir(weights):
        params, cfg = pinit.load_hf_checkpoint(weights, dtype=dtype, device=load_on)
    else:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        params = pinit.params_from_hf_state_dict(cfg, sd, dtype=dtype, device=load_on)
    if quant_bits is not None:
        from ..quant.quantize import quantize_model

        params = quantize_model(params, bits=quant_bits)
    if stay_layers is not None:
        params = offload_params(params, stay_layers, device=device)
    return params, cfg


def load_prompts(spec: str, vocab: int, seed: int, prefill_len: int = 0):
    """`synthetic:N,LEN` (N prompts of LEN ids drawn from `seed`) |
    `jsonl:<path>` / `arrow:<path>` (pre-tokenized, the data layer) | a
    JSON file of token-id lists. `prefill_len` > 0 pads or truncates every
    prompt to exactly that length (the reference greedy testbed's `--S`
    long-prefill knob, `tests/testbed_greedy.py:240-245`)."""
    if spec.startswith("synthetic:"):
        n, ln = (int(x) for x in spec.split(":")[1].split(","))
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(10, vocab, size=ln) for _ in range(n)]
    elif spec.startswith(("jsonl:", "arrow:")):
        from ..data.datasets import load_dataset_by_name

        ds = load_dataset_by_name(spec, seq_len=max(prefill_len, 256))
        prompts = [np.minimum(p, vocab - 1) for p in ds]
    else:
        with open(spec) as f:
            prompts = [np.asarray(p, np.int32) for p in json.load(f)]
    if prefill_len > 0:
        from ..data.datasets import TokenDataset

        ds = TokenDataset.from_sequences(prompts, seq_len=prefill_len)
        prompts = [ds.ids[i] for i in range(len(ds))]  # exact-length rows
    return prompts


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
    ap.add_argument("--draft", default="llama-68m", help="preset name or config dir")
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
    ap.add_argument("--prompts", default="synthetic:4,128",
                    help="synthetic:N,LEN | jsonl:<path> | arrow:<path> | token-id JSON")
    ap.add_argument("--S", type=int, default=0,
                    help="force prefill length (pad/truncate prompts; "
                         "long-prefill runs, testbed_greedy --S)")
    ap.add_argument("--start", type=int, default=0,
                    help="dataset window start (tests/testbed.py:27)")
    ap.add_argument("--end", type=int, default=None, help="dataset window end")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--quant", default="none", choices=["none", "int8", "int4"],
                    help="target weight quantization (random init goes "
                         "straight to quantized layers)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8", "int4"],
                    help="int8 / int4 target KV cache (per-row scales)")
    ap.add_argument("--offloading", action="store_true",
                    help="stream the target's layers from pinned host memory "
                         "(engine/offload.py; the reference's --offloading)")
    ap.add_argument("--staylayer", type=int, default=0,
                    help="offloading: target layers kept on the device "
                         "(tests/run_sequoia.py --staylayer)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for small checks")
    args = ap.parse_args(argv)

    from ..engine.baseline import ARBaseline
    from ..engine.engine import SpecEngine
    from ..utils import hard_sync, resolve_device

    device = resolve_device(args.device)
    target_params, target_cfg = build_params(
        args.target, args.target_weights, args.dtype, args.seed, device,
        quant_bits=None if args.quant == "none" else int(args.quant[3:]),
        stay_layers=args.staylayer if args.offloading else None)
    prompts = load_prompts(args.prompts, target_cfg.vocab_size, args.seed,
                           prefill_len=args.S)[args.start:args.end]

    total_tokens = 0
    total_steps = 0
    t_total = 0.0
    if args.mode == "baseline":
        ar = ARBaseline(target_params, target_cfg, max_length=args.M,
                        temperature=args.T, top_p=args.P,
                        greedy=(args.algorithm == "greedy"), kv_quant=args.kv_quant,
                        device=device)
        ar.generate_fast(prompts[0], max_new_tokens=4)  # warm up (and capture)
        for i, prompt in enumerate(prompts):
            hard_sync(device)
            t0 = time.perf_counter()
            out = ar.generate_fast(prompt, max_new_tokens=args.gen, seed=args.seed + i)
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
        # Warm up (and capture the phase graphs).
        if bench:
            eng.generate_benchmark(prompts[0], max_new_tokens=4)
        else:
            eng.generate_fast(prompts[0], max_new_tokens=4)
        for i, prompt in enumerate(prompts):
            hard_sync(device)
            t0 = time.perf_counter()
            if bench:
                _, totals = eng.generate_benchmark(prompt, max_new_tokens=args.gen,
                                                   seed=args.seed + i)
                for k, v in totals.items():
                    phase_totals[k] = phase_totals.get(k, 0.0) + v
            else:
                eng.generate_fast(prompt, max_new_tokens=args.gen, seed=args.seed + i)
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
