"""Chat runner of the port (port of `sequoia_tpu/cli/chat.py`): the analog
of the reference's `tests/run_sequoia.py` (stochastic), `tests/greedy_run.py`
(greedy, Llama-3-aware) and `tests/specinfer_run.py`, behind one
`--algorithm` flag.

- A target larger than the card is served with `--offloading --staylayer
  N`: its first N layers stay on the card and the rest stream from pinned
  host memory (`engine/offload.py`, the reference's `offload_engine.py`),
  which composes with `--quant int8|int4` to cut the bytes over the link.
- A target larger than one card is served with tensor parallelism,
  `--tp N`, one process a card under `torchrun` (the draft stays whole on
  every card; only rank 0 prints). `--tp` does not compose with
  `--offloading` (the single-card path) or `--mode baseline` (the AR
  baseline takes no mesh).
- The prompt template, MT-Bench loading, seed and stop-token handling are
  the reference's (`tests/run_sequoia.py:82,284-297`; the Llama-3 EOS
  override `tests/greedy_run.py:129` is `--stop-tokens`).
- Tokens stream from `SpecEngine.stream_fast` (the device loop in chunks of
  `--stream-chunk` tokens, one host read a block); `--stream-chunk 1`
  streams one eager iteration at a time.

Runs on the CUDA card (`--device cpu` only for small checks), offline with
`--tokenizer none` (token ids) or `byte` (the byte-level codec), or with a
local HF tokenizer directory.

    python -m sequoia_torch.cli.chat --tokenizer byte --limit 4
    python -m sequoia_torch.cli.chat --tokenizer byte --offloading --staylayer 16
    torchrun --nproc-per-node 4 -m sequoia_torch.cli.chat --tp 4 --tokenizer byte
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np


def _load_tokenizer(spec: str):
    if spec == "none":
        return None
    if spec == "byte":
        from ..data.tokenizer import ByteTokenizer

        return ByteTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(spec, use_fast=True)


def _decode_stream(tokenizer, toks: np.ndarray, so_far: list) -> str:
    """Incremental detokenization: decode the whole sequence so far and
    let the caller print the new suffix (robust to multi-token characters;
    the reference re-decodes every iteration, tests/run_sequoia.py:140-145)."""
    so_far.extend(int(t) for t in toks)
    return tokenizer.decode(so_far, skip_special_tokens=True)


def run_prompts(engine, prompts_tokens, args, tokenizer) -> dict:
    """Stream every prompt through `engine`, printing the text (or ids) as
    it comes; returns the totals: wall seconds, tokens, target steps,
    time to the first chunk, and the steady rate after it."""
    total_tokens = 0
    total_steps = 0
    t_total = 0.0
    ttfc_total = 0.0        # time to the first chunk (prefill + first block)
    steady_s = 0.0          # wall clock after the first chunk
    steady_tokens = 0
    detok_s = 0.0
    for i, prompt in enumerate(prompts_tokens):
        if len(prompt) + engine.tree_size + 1 > args.M:
            print(f"[prompt {i} too long ({len(prompt)}), skipped]")
            continue
        print(f"\n=== prompt {i} ({len(prompt)} tokens) ===")
        acc: list = []
        shown = 0
        t0 = time.perf_counter()
        chunk = getattr(args, "stream_chunk", 1)
        if chunk > 1 and hasattr(engine, "stream_fast"):
            stream = engine.stream_fast(prompt, max_new_tokens=args.gen, chunk_tokens=chunk,
                                        seed=args.seed + i)
        else:
            stream = engine.stream(prompt, max_new_tokens=args.gen, seed=args.seed + i)
        t_first = None
        first_tokens = 0
        for new in stream:
            if t_first is None:
                t_first = time.perf_counter() - t0
                first_tokens = len(new)
            if tokenizer is not None:
                td = time.perf_counter()
                text = _decode_stream(tokenizer, new, acc)
                sys.stdout.write(text[shown:])
                shown = len(text)
                detok_s += time.perf_counter() - td
            else:
                sys.stdout.write(" " + " ".join(str(int(t)) for t in new))
            sys.stdout.flush()
        dt = time.perf_counter() - t0
        t_total += dt
        print()
        if t_first is not None:
            ttfc_total += t_first
            steady_s += dt - t_first
            steady_tokens += engine.num_decoding_steps - first_tokens
            rest = max(engine.num_decoding_steps - first_tokens, 1)
            print(f"[prompt {i}: first chunk {t_first * 1e3:.0f} ms "
                  f"(prefill {len(prompt)} tok + first block), then "
                  f"{(dt - t_first) * 1e3 / rest:.1f} ms/token steady]")
        total_tokens += engine.num_decoding_steps
        total_steps += engine.num_large_model_steps
    return {
        "total_time_s": t_total,
        "tokens": total_tokens,
        "large_model_steps": total_steps,
        "ttfc_s": ttfc_total,
        "steady_s": steady_s,
        "steady_tokens": steady_tokens,
        "detok_s": detok_s,
    }


class _BaselineStream:
    """`ARBaseline` behind the streaming interface `run_prompts` expects
    (one step a token: accepted tokens per step is 1)."""

    tree_size = 1

    def __init__(self, ar) -> None:
        self.ar = ar
        self.num_decoding_steps = 0
        self.num_large_model_steps = 0

    def stream(self, prompt, max_new_tokens, seed):
        self.num_decoding_steps = 0
        for tok in self.ar.stream(prompt, max_new_tokens=max_new_tokens, seed=seed):
            self.num_decoding_steps += 1
            self.num_large_model_steps = self.num_decoding_steps
            yield tok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--draft", default="llama-68m", help="preset or HF checkpoint dir")
    ap.add_argument("--target", default="llama-2-7b")
    ap.add_argument("--tokenizer", default="none",
                    help="'none' (token ids), 'byte' (the offline byte-level codec: "
                         "MT-Bench with no network), or a local HF tokenizer dir")
    ap.add_argument("--growmap", default="planned", help="path | chain:N | tree:DxB | planned")
    ap.add_argument("--algorithm", default="sequoia",
                    choices=["sequoia", "specinfer", "greedy", "greedys"])
    ap.add_argument("--mode", default="spec", choices=["spec", "baseline"])
    ap.add_argument("--quant", default="none", choices=["none", "int8", "int4"],
                    help="target weight-only quantization")
    ap.add_argument("--offloading", action="store_true",
                    help="stream the target's layers from pinned host memory "
                         "(engine/offload.py); composes with --quant")
    ap.add_argument("--staylayer", type=int, default=0,
                    help="offloading: target layers kept on the device "
                         "(tests/run_sequoia.py:247 --staylayer)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: one process a card under torchrun "
                         "(--nproc-per-node N); on the CPU (--device cpu) gloo ranks")
    ap.add_argument("--T", type=float, default=0.6)
    ap.add_argument("--P", type=float, default=0.9)
    ap.add_argument("--M", type=int, default=1024, help="max buffer length")
    ap.add_argument("--gen", type=int, default=256)
    ap.add_argument("--stream-chunk", type=int, default=16,
                    help="tokens a streamed chunk (the device loop between yields; "
                         "1 = one eager iteration a yield)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--stop-tokens", default=None,
                    help="comma-separated EOS ids (Llama-3: 128009,128001)")
    ap.add_argument("--data-root", default="tests/dataset",
                    help="directory holding mt_bench.jsonl (else the bundled copy)")
    ap.add_argument("--prompts", default=None,
                    help="override: synthetic:N,LEN | token-id JSON file | "
                         "text file (one prompt a line)")
    ap.add_argument("--limit", type=int, default=None, help="max prompts")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up generation: by default one synthetic "
                         "chunk runs before the first prompt, so the kernel build "
                         "and the graphs' capture land outside the prompt loop")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for small checks")
    args = ap.parse_args(argv)
    mesh = None
    if args.tp != 1:
        if args.offloading:
            raise ValueError("--offloading is the single-card path; it does not compose "
                             "with --tp")
        if args.mode == "baseline":
            raise ValueError("--tp serves the spec mode: the AR baseline takes no mesh")
        from ..parallel.distributed import initialize_distributed
        from ..parallel.sharding import make_mesh

        initialize_distributed(backend="gloo" if args.device == "cpu" else "nccl")
        mesh = make_mesh(tp=args.tp)
    from ..parallel.distributed import is_primary

    with contextlib.ExitStack() as stack:
        if not is_primary():
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        _run(args, mesh)


def _run(args, mesh) -> None:
    import dataclasses

    from ..data.datasets import ensure_mt_bench, format_inst, load_mt_bench_prompts
    from ..engine.baseline import ARBaseline
    from ..engine.engine import SpecEngine
    from ..utils import resolve_device
    from .testbed import build_params, load_growmap, load_prompts

    device = resolve_device(args.device)
    tokenizer = _load_tokenizer(args.tokenizer)
    target_params, target_cfg = build_params(
        args.target, "auto", args.dtype, args.seed, device,
        quant_bits=None if args.quant == "none" else int(args.quant[3:]),
        stay_layers=args.staylayer if args.offloading else None)
    if args.stop_tokens:
        stops = tuple(int(t) for t in args.stop_tokens.split(","))
        target_cfg = dataclasses.replace(target_cfg, stop_tokens=stops)
    if mesh is not None:
        from ..parallel.sharding import shard_params

        target_params = shard_params(target_params, mesh)

    # --- Prompts ----------------------------------------------------------
    if args.prompts is not None:
        if args.prompts.startswith("synthetic:") or args.prompts.endswith(".json"):
            prompts_tokens = load_prompts(args.prompts, target_cfg.vocab_size, args.seed)
        else:
            if tokenizer is None:
                raise ValueError("text prompts need --tokenizer")
            with open(args.prompts) as f:
                texts = [line.rstrip("\n") for line in f if line.strip()]
            prompts_tokens = [np.asarray(tokenizer(format_inst(t))["input_ids"], np.int32)
                              for t in texts]
    else:
        if tokenizer is None:
            raise ValueError("MT-Bench prompts need --tokenizer (or pass --prompts)")
        texts = load_mt_bench_prompts(ensure_mt_bench(args.data_root))
        prompts_tokens = [np.asarray(tokenizer(format_inst(t))["input_ids"], np.int32)
                          for t in texts]
    if args.limit:
        prompts_tokens = prompts_tokens[: args.limit]

    # --- Engine -----------------------------------------------------------
    if args.mode == "baseline":
        engine = _BaselineStream(ARBaseline(
            target_params, target_cfg, max_length=args.M, temperature=args.T,
            top_p=args.P, greedy=(args.algorithm == "greedy"), device=device))
    else:
        draft_params, draft_cfg = build_params(args.draft, "auto", args.dtype, args.seed + 1,
                                               device)
        engine = SpecEngine(
            draft_params, draft_cfg, target_params, target_cfg, load_growmap(args.growmap),
            algorithm=args.algorithm, max_length=args.M, temperature=args.T, top_p=args.P,
            mesh=mesh, device=device)

    if not args.no_warmup:
        # One synthetic chunk through the entry point the prompt loop uses
        # (at least one token, whatever --M): builds the kernels and
        # captures the graphs before the first prompt, like a warm server.
        t0 = time.perf_counter()
        warm_prompt = np.arange(7, 7 + max(1, min(args.M // 4, 64)),
                                dtype=np.int32) % target_cfg.vocab_size
        chunk = 1 if args.mode == "baseline" else args.stream_chunk
        if chunk > 1 and hasattr(engine, "stream_fast"):
            warm = engine.stream_fast(warm_prompt, max_new_tokens=chunk, chunk_tokens=chunk,
                                      seed=args.seed)
        else:
            warm = engine.stream(warm_prompt, max_new_tokens=1, seed=args.seed)
        for _ in warm:
            break
        print(f"[warmup: {time.perf_counter() - t0:.1f}s (kernel build / graph capture)]")

    stats = run_prompts(engine, prompts_tokens, args, tokenizer)
    print(f"\ntotal time: {stats['total_time_s']:.3f}s")
    if stats["tokens"]:
        print(f"tokens generated: {stats['tokens']}")
        print(f"per-token latency: {stats['total_time_s'] / stats['tokens'] * 1e3:.2f} ms")
    if stats["large_model_steps"]:
        print(f"accepted tokens per target step: "
              f"{stats['tokens'] / stats['large_model_steps']:.3f}")
    if stats.get("steady_tokens"):
        # The warm wall clock split into each prompt's time to its first
        # chunk (prefill + first block) and the steady streaming rate.
        print(f"time-to-first-chunk total: {stats['ttfc_s']:.3f}s "
              f"({stats['ttfc_s'] / max(len(prompts_tokens), 1) * 1e3:.0f} ms/prompt)")
        print(f"steady-state: {stats['steady_s'] / stats['steady_tokens'] * 1e3:.2f} "
              f"ms/token over {stats['steady_tokens']} tokens "
              f"(detok {stats['detok_s'] * 1e3:.0f} ms total)")


if __name__ == "__main__":
    main()
