"""Tensor and data parallelism of sequoia_torch on the CPU: gloo ranks in
spawned processes (`tests/torch_tp_worker.py`), each holding its shard
(`parallel/sharding.py`), against the JAX package run in this process.

- the sharded forward's logits and this rank's KV heads against JAX's
  forward, at tp 2 (test-tiny) and tp 4 (test-small), f32, 1e-4, for
  float, int8, packed int4, tiled int4 (bn0 = 16), w8a8 and w4a8 weights;
  per-shard activation scales miss that bound;
- greedy Sequoia tokens under tp 2 and 4 equal to JAX's (eager and the
  device loop); under stochastic Sequoia every rank commits the same
  tokens, with every KV cache format, and the int4 packing follows JAX's
  rule;
- dp 2 x tp 2 batched serving (`generate_batch`, `serve`, `serve_device`)
  equal to one process;
- `cli/chat.py --tp 2`: only rank 0 prints;
- the single-process bootstrap.

The card's side (the graph entry points refusing a gloo tp group) is in
tests/test_torch_cuda.py, which imports no JAX.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sequoia_tpu.core import model as jmodel  # noqa: E402
from sequoia_tpu.core.config import get_config  # noqa: E402
from sequoia_tpu.core.init import random_params as jax_random_params  # noqa: E402
from sequoia_tpu.engine.engine import SpecEngine as JaxSpec  # noqa: E402
from sequoia_tpu.kvcache.cache import KVCache as JKV  # noqa: E402
from sequoia_tpu.ops import masks as jmasks  # noqa: E402
from sequoia_tpu.quant import qtensor as jq  # noqa: E402
from sequoia_tpu.quant.quantize import quantize_model as jax_quantize_model  # noqa: E402
from sequoia_tpu.trees.growmap import uniform_tree as jax_uniform_tree  # noqa: E402
from sequoia_torch.core.config import get_config as port_config  # noqa: E402
from sequoia_torch.core.init import params_from_numpy  # noqa: E402
from sequoia_torch.engine.batched import BatchedSpecEngine  # noqa: E402
from sequoia_torch.parallel.distributed import (  # noqa: E402
    hybrid_mesh,
    initialize_distributed,
    is_primary,
)
from sequoia_torch.trees.growmap import uniform_tree  # noqa: E402

WORKER = Path(__file__).with_name("torch_tp_worker.py")
FORMATS = ("float", "int8", "int4", "tiled", "w8a8", "w4a8")
M = 32
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module (see test_torch_offload.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(job: str, inp: dict, world: int, tmp: Path, timeout: float = 240):
    """Run `job` on `world` gloo ranks; returns each rank's output."""
    tmp.mkdir(parents=True, exist_ok=True)
    inp_path = tmp / "input.pt"
    torch.save(inp, inp_path)
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), job, str(inp_path), str(tmp)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{(tmp / f'rank{r}.log').read_text()[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def plain(tree):
    """A JAX params pytree of numpy arrays as nested dicts (the worker
    imports nothing of JAX; `params_from_numpy` reads dicts)."""
    if hasattr(tree, "_asdict"):
        return {k: plain(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _tile_layers(qp):
    lay = qp.layers
    return qp._replace(layers=lay._replace(**{
        f: jq.tile_int4(w, bn0=16) for f, w in lay._asdict().items()
        if isinstance(w, jq.QuantizedTensor)}))


def _jax_w4a8(x, w, *, preferred_element_type=None):
    """JAX's w4a8 product (`kernels/quant_matmul.py:358-364` around its
    kernel) in eager unfused ops: a true division by 127 (ROADMAP C3)."""
    if not isinstance(w, jq.QuantizedTensor) or w.q.shape[-2] * 2 != x.shape[-1]:
        return jq.matmul(x, w, preferred_element_type=preferred_element_type)
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    x8 = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(x8, jq.unpack_int4(w.q), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * sx * w.scale.astype(jnp.float32)
    return y.astype(preferred_element_type or x.dtype)


def _jax_forward(params, cfg, tokens, fmt):
    """JAX's forward (eager, as tests/test_torch_quant.py runs it) in
    write mode over a fresh cache, with `fmt`'s matmul route."""
    kv = JKV.init(cfg, M, jnp.float32)
    n = len(tokens)
    jq.set_w8a8("on" if fmt == "w8a8" else "off")
    qmm = jmodel.qmm
    if fmt == "w4a8":
        jmodel.qmm = _jax_w4a8
    try:
        logits, kv = jmodel.forward(params, cfg, jnp.asarray(tokens), jnp.arange(n), kv, 0,
                                    jmasks.causal_mask(n, M, 0))
    finally:
        jmodel.qmm = qmm
        jq.set_w8a8("auto", min_rows=96)
    return np.asarray(logits), np.asarray(kv.k), np.asarray(kv.v)


def _formats(params):
    q8 = jax_quantize_model(params, bits=8)
    q4 = jax_quantize_model(params, bits=4)
    return {"float": params, "int8": q8, "int4": q4, "tiled": _tile_layers(q4),
            "w8a8": q8, "w4a8": q4}


# tp -> (config, weight seed). An activation within one f32 rounding of a
# half-way point between two int8 levels rounds either way under any change
# of summation order, the all-reduce's as much as GSPMD's: such an input
# moves a w8a8 / w4a8 logit by about 1e-2 at these sizes whatever the code
# does (test-small at seed 34 has one 1e-6 of a level from the tie, which
# flips). So the seeds are ones whose unsharded w8a8 and w4a8 forwards keep
# every activation at least TIE_MARGIN of a level from a tie, which
# `test_sharded_forward_matches_jax` checks first.
SIZES = {2: ("test-tiny", 32), 4: ("test-small", 38)}
TIE_MARGIN = 1e-5


def _tie_margin(tree, name, fmt, tokens) -> float:
    """The least distance, in int8 levels, of an activation from a rounding
    tie in the port's unsharded forward with `fmt`'s route."""
    from sequoia_torch.core import model as tmodel
    from sequoia_torch.kernels import quant_matmul as tqmm
    from sequoia_torch.kvcache.cache import KVCache
    from sequoia_torch.ops import masks as tmasks
    from sequoia_torch.quant import qtensor as tq

    seen, own = [], tqmm.quantize_activations_plain

    def spy(x, amax=None):
        xf = x.float()
        a = xf.abs().amax(dim=-1, keepdim=True) if amax is None else amax
        r = xf / (a.clamp_min(1e-8) / torch.full((), 127.0))
        seen.append(float((r - r.floor() - 0.5).abs().min()))
        return own(x, amax)

    cfg = port_config(name)
    tqmm.quantize_activations_plain = spy
    tq.set_w8a8("on" if fmt == "w8a8" else "off")
    tq.set_w4a8("on" if fmt == "w4a8" else "off")
    try:
        with torch.no_grad():
            tmodel.forward(params_from_numpy(tree, device="cpu"), cfg, torch.as_tensor(tokens),
                           torch.arange(len(tokens)), KVCache.init(cfg, M, torch.float32, "cpu"),
                           0, tmasks.causal_mask(len(tokens), M, 0, "cpu"))
    finally:
        tqmm.quantize_activations_plain = own
        tq.set_w8a8("auto", min_rows=96)
        tq.set_w4a8("off")
    return min(seen)


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """Per tp: JAX's outputs, every rank's (one launch a tp), and the tie
    margin of each activation-quantized format."""
    out = {}
    for tp, (name, seed) in SIZES.items():
        cfg = get_config(name)
        params = jax_random_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
        fmts = _formats(params)
        tokens = (np.arange(12) * 37 + 5) % cfg.vocab_size
        want = {f: _jax_forward(p, cfg, tokens, f) for f, p in fmts.items()}
        margins = {f: _tie_margin(plain(fmts[f]), name, f, tokens) for f in ("w8a8", "w4a8")}
        got = launch("forward", {"config": name, "tp": tp, "max_length": M, "tokens": tokens,
                                 "params": {f: plain(p) for f, p in fmts.items()}},
                     tp, tmp_path_factory.mktemp(f"fwd{tp}"))
        out[tp] = (cfg, want, got, margins)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_forward_matches_jax(forwards, tp, fmt):
    """Logits gathered on every rank and each rank's KV heads, against
    JAX's unsharded forward (which its GSPMD-sharded one equals,
    tests/test_sharding.py), 1e-4 at f32."""
    cfg, want, got, margins = forwards[tp]
    assert margins.get(fmt, 1.0) > TIE_MARGIN, margins   # see SIZES
    logits, k, v = want[fmt]
    hk = cfg.num_kv_heads // tp
    for r, out in enumerate(got):
        np.testing.assert_allclose(out[fmt]["logits"], logits, rtol=TOL, atol=TOL)
        heads = slice(r * hk, (r + 1) * hk)
        np.testing.assert_allclose(out[fmt]["k"], k[:, :, heads], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out[fmt]["v"], v[:, :, heads], rtol=TOL, atol=TOL)
    # The ranks received the same bits: their decisions cannot diverge.
    for out in got[1:]:
        np.testing.assert_array_equal(out[fmt]["logits"], got[0][fmt]["logits"])


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_per_shard_activation_scales_miss_the_bound(forwards, fmt):
    """The global row maxima matter: scaling each row-parallel shard by its
    own maxima moves the logits past the 1e-4 bound the global ones meet."""
    for tp in (2, 4):
        _, want, got, _ = forwards[tp]
        err = np.abs(got[0][fmt]["per_shard_logits"] - want[fmt][0]).max()
        assert err > 10 * TOL, (tp, err)


ENGINE = dict(max_length=96, prefill_chunk=16, temperature=0.8, top_p=0.9)
PROMPT = np.array([9, 4, 27, 31, 5, 44])


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """test-small (4 KV heads) under tp 2 and 4: greedy tokens (draft
    sharded too) and stochastic Sequoia with each KV cache format; and
    JAX's unsharded greedy tokens."""
    cfg = get_config("test-small")
    draft = jax_random_params(cfg, jax.random.PRNGKey(17), dtype=jnp.float32)
    target = jax_random_params(cfg, jax.random.PRNGKey(18), dtype=jnp.float32)
    jeng = JaxSpec(draft, cfg, target, cfg, jax_uniform_tree(2, 2), algorithm="greedy",
                   max_length=96, prefill_chunk=16)
    want = np.asarray(jeng.generate(PROMPT, max_new_tokens=20))
    got = {}
    for tp in (2, 4):
        got[tp] = launch("engines", {
            "config": "test-small", "tp": tp, "tree": (2, 2), "engine": ENGINE,
            "draft": plain(draft), "target": plain(target), "prompt": PROMPT, "new": 20,
            "kv_quants": ["none", "int8", "int4"]}, tp, tmp_path_factory.mktemp(f"eng{tp}"))
    return want, got


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_greedy_tokens_match_jax(engines, tp):
    want, got = engines
    for out in got[tp]:
        for entry in ("generate", "generate_fast"):
            np.testing.assert_array_equal(out["greedy"][entry], want)


@pytest.mark.parametrize("tp", [2, 4])
def test_stochastic_ranks_commit_identical_tokens(engines, tp):
    """Every rank runs the walk and the samplers on the same gathered
    logits with the same seeds: the tokens agree on every rank, with each
    KV cache format, and the run made tokens."""
    _, got = engines
    for kvq in ("none", "int8", "int4"):
        first = got[tp][0]["stochastic"][kvq]["tokens"]
        assert len(first) > len(PROMPT)
        for out in got[tp][1:]:
            np.testing.assert_array_equal(out["stochastic"][kvq]["tokens"], first)


@pytest.mark.parametrize("tp,packing", [(2, "head"), (4, "dsplit")])
def test_int4_kv_packing_under_tp(engines, tp, packing):
    """JAX's rule (`tests/test_sharding.py::test_sharded_int4_kv_runs`):
    4 KV heads pair under tp 2 (2 pairs, 1 a rank), not under tp 4."""
    _, got = engines
    for out in got[tp]:
        assert out["stochastic"]["int4"]["packing"] == packing


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    """dp 2 x tp 2 on 4 ranks, and the same engine in this process."""
    name = "test-tiny"
    cfg, tcfg = get_config(name), port_config(name)
    draft = jax_random_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    target = jax_random_params(cfg, jax.random.PRNGKey(8), dtype=jnp.float32)
    prompts = [np.array([11, 23, 5, 99, 42, 7]), np.array([3, 1, 4, 1, 5]),
               np.array([42, 17]), np.array([8, 6, 7, 5, 3, 9, 2])]
    kw = dict(max_length=64, prefill_chunk=16)
    ref = BatchedSpecEngine(params_from_numpy(plain(draft), device="cpu"), tcfg,
                            params_from_numpy(plain(target), device="cpu"), tcfg,
                            uniform_tree(2, 2), algorithm="greedy", batch_size=2,
                            device="cpu", **kw)
    want = {"generate_batch": ref.generate_batch(prompts[:2], max_new_tokens=10),
            "serve": ref.serve(prompts, max_new_tokens=10),
            "serve_device": ref.serve_device(prompts, max_new_tokens=10)}
    got = launch("batched", {"config": name, "tp": 2, "dp": 2, "tree": (2, 2), "engine": kw,
                             "draft": plain(draft), "target": plain(target),
                             "prompts": prompts, "new": 10, "batch_size": 2},
                 4, tmp_path_factory.mktemp("dp"))
    return want, got


@pytest.mark.parametrize("entry", ["generate_batch", "serve", "serve_device"])
def test_dp_tp_batched_serving_matches_one_process(batched, entry):
    """Each dp rank serves one of the 2 slots (and its half of the queue);
    the gathered outputs, on every rank, equal one process's, in input order."""
    want, got = batched
    for out in got:
        assert out["slots"] == 1
        assert len(out[entry]) == len(want[entry])
        for g, w in zip(out[entry], want[entry]):
            np.testing.assert_array_equal(g, w)


def test_chat_tp_prints_on_rank_zero_only(tmp_path):
    argv = ["--draft", "test-tiny", "--target", "test-tiny", "--growmap", "tree:2x2",
            "--prompts", "synthetic:2,8", "--gen", "6", "--M", "64", "--dtype", "f32",
            "--tp", "2", "--device", "cpu", "--no-warmup"]
    got = launch("chat", {"argv": argv}, 2, tmp_path)
    assert got[0]["primary"] and not got[1]["primary"]
    assert "per-token latency" in got[0]["stdout"]
    assert got[1]["stdout"] == ""


def test_single_process_bootstrap(monkeypatch):
    """World size 1 (or none set) skips initialization; the process is the
    primary; a mesh needs a process group; the chat CLI's --tp refuses the
    single-card paths."""
    from sequoia_torch.cli.chat import main
    from sequoia_torch.parallel.sharding import make_mesh

    from sequoia_torch.utils import hard_sync_all_devices

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert is_primary()
    hard_sync_all_devices()   # no group: a no-op on the CPU
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(tp=1)
    with pytest.raises(RuntimeError, match="process group"):
        hybrid_mesh(tp=1)
    for extra in (["--offloading"], ["--mode", "baseline"]):
        with pytest.raises(ValueError):
            main(["--tp", "2", "--device", "cpu"] + extra)
