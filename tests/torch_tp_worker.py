"""One rank of the CPU tensor- and data-parallel checks of sequoia_torch
(`tests/test_torch_distributed.py`): run as

    python tests/torch_tp_worker.py JOB INPUT OUTDIR

with `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` set, as
`torchrun` sets them. It joins a gloo group, builds the (dp, tp) mesh from
`INPUT` (a `torch.save` of plain numpy data: weights in the JAX layout,
inputs, settings), runs JOB and writes `OUTDIR/rank<R>.pt`. It imports
nothing of JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from sequoia_torch.core import model as tmodel  # noqa: E402
from sequoia_torch.core.config import get_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.kvcache.cache import KVCache  # noqa: E402
from sequoia_torch.ops import masks  # noqa: E402
from sequoia_torch.parallel.distributed import initialize_distributed, is_primary  # noqa: E402
from sequoia_torch.parallel.sharding import (  # noqa: E402
    make_mesh,
    mesh_axes,
    shard_config,
    shard_params,
)
from sequoia_torch.quant import qtensor  # noqa: E402
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402


def _routes(fmt: str):
    qtensor.set_w8a8("on" if fmt == "w8a8" else "off")
    qtensor.set_w4a8("on" if fmt == "w4a8" else "off")


def job_forward(inp, mesh):
    """Each weight format's sharded prefill forward: logits and this rank's
    KV heads; for w8a8 / w4a8 also the logits with per-shard row scales
    (the row-maxima all-reduce replaced by the rank's own maxima)."""
    cfg = get_config(inp["config"])
    ax = mesh_axes(mesh)
    toks = torch.as_tensor(inp["tokens"])
    pos = torch.arange(len(toks))
    mask = masks.causal_mask(len(toks), inp["max_length"], 0, "cpu")
    out = {}
    for fmt, tree in inp["params"].items():
        _routes(fmt)
        params = shard_params(params_from_numpy(tree, device="cpu"), mesh)
        kv = KVCache.init(shard_config(cfg, ax.tp), inp["max_length"], torch.float32, "cpu")

        def run(kv=kv, params=params):
            with torch.no_grad():
                return tmodel.forward(params, cfg, toks, pos, kv.zero_(), 0, mask,
                                      tp=ax.tp_group)

        logits, kv = run()
        out[fmt] = {"logits": logits.numpy(), "k": kv.k.numpy().copy(),
                    "v": kv.v.numpy().copy()}
        if fmt in ("w8a8", "w4a8"):
            own = tmodel.all_reduce_max
            tmodel.all_reduce_max = lambda x, group: x
            try:
                out[fmt]["per_shard_logits"] = run()[0].numpy()
            finally:
                tmodel.all_reduce_max = own
    _routes("float")
    return out


def _engine(inp, mesh, **kw):
    from sequoia_torch.engine.engine import SpecEngine

    cfg = get_config(inp["config"])
    draft = params_from_numpy(inp["draft"], device="cpu")
    target = shard_params(params_from_numpy(inp["target"], device="cpu"), mesh)
    if inp.get("shard_draft"):
        draft = shard_params(draft, mesh)
    return SpecEngine(draft, cfg, target, cfg, uniform_tree(*inp["tree"]), mesh=mesh,
                      shard_draft=inp.get("shard_draft", False), device="cpu",
                      **inp["engine"], **kw)


def job_engines(inp, mesh):
    """Greedy Sequoia tokens under tp with the draft sharded too, eager and
    through the device loop; stochastic Sequoia (draft whole) with each KV
    cache format: the tokens this rank committed and the int4 packing the
    engine chose."""
    prompt = np.asarray(inp["prompt"])
    eng = _engine(dict(inp, shard_draft=True), mesh, algorithm="greedy")
    out = {"greedy": {"generate": eng.generate(prompt, max_new_tokens=inp["new"]),
                      "generate_fast": eng.generate_fast(prompt, max_new_tokens=inp["new"])},
           "stochastic": {}}
    for kvq in inp["kv_quants"]:
        eng = _engine(inp, mesh, algorithm="sequoia", kv_quant=kvq)
        out["stochastic"][kvq] = {"tokens": eng.generate(prompt, max_new_tokens=inp["new"],
                                                         seed=3),
                                  "packing": eng._kv4_packing}
    return out


def job_gloo_cuda(inp, mesh):
    """On the card with a gloo tp group: `generate_fast` must raise, the
    eager `generate` run."""
    from sequoia_torch.core.init import random_params
    from sequoia_torch.engine.engine import SpecEngine

    cfg = get_config("test-tiny")
    params = random_params(cfg, 0, dtype=torch.float32, device="cuda")
    eng = SpecEngine(params, cfg, shard_params(params, mesh), cfg, uniform_tree(2, 2),
                     algorithm="greedy", max_length=64, mesh=mesh, device="cuda")
    prompt = np.arange(5, 11)
    try:
        eng.generate_fast(prompt, max_new_tokens=4)
        raised = False
    except RuntimeError as e:
        raised = "NCCL" in str(e)
    return {"raised": raised,
            "eager_tokens": len(eng.generate(prompt, max_new_tokens=4)) - len(prompt)}


def job_batched(inp, mesh):
    """dp x tp batched serving: generate_batch, serve and serve_device."""
    from sequoia_torch.engine.batched import BatchedSpecEngine

    cfg = get_config(inp["config"])
    draft = shard_params(params_from_numpy(inp["draft"], device="cpu"), mesh)
    target = shard_params(params_from_numpy(inp["target"], device="cpu"), mesh)
    eng = BatchedSpecEngine(draft, cfg, target, cfg, uniform_tree(*inp["tree"]), mesh=mesh,
                            shard_draft=True, device="cpu", algorithm="greedy",
                            batch_size=inp["batch_size"], **inp["engine"])
    prompts = [np.asarray(p) for p in inp["prompts"]]
    return {"slots": eng.batch_size,
            "generate_batch": eng.generate_batch(prompts[:inp["batch_size"]],
                                                 max_new_tokens=inp["new"]),
            "serve": eng.serve(prompts, max_new_tokens=inp["new"]),
            "serve_device": eng.serve_device(prompts, max_new_tokens=inp["new"])}


def job_chat(inp, mesh):
    """`cli/chat.py --tp`: the CLI builds its own mesh; only rank 0 prints."""
    import contextlib
    import io

    from sequoia_torch.cli.chat import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(inp["argv"])
    return {"stdout": buf.getvalue(), "primary": is_primary()}


JOBS = {"forward": job_forward, "engines": job_engines, "batched": job_batched,
        "chat": job_chat, "gloo_cuda": job_gloo_cuda}


def main():
    job, inp_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    inp = torch.load(inp_path, weights_only=False)
    if job == "gloo_cuda":   # a gloo group of one: initialize_distributed skips a world of 1
        import torch.distributed as dist

        dist.init_process_group("gloo", rank=0, world_size=1, init_method="tcp://localhost:"
                                + os.environ["MASTER_PORT"])
    else:
        initialize_distributed(backend="gloo")
    mesh = None if job == "chat" else make_mesh(tp=inp["tp"], dp=inp.get("dp", 1))
    out = JOBS[job](inp, mesh)
    rank = int(os.environ["RANK"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
