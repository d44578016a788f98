"""The port's chat runner and sweep runner (`cli/chat.py`, `cli/sweep.py`,
`data/datasets.py::ensure_mt_bench`) on the CPU at test-tiny size, as
`tests/test_chat.py` checks JAX's: the streaming entry points commit what
the whole-sequence ones commit, the chat CLI runs in token-id mode, with
int8 weights and with an offloaded target, MT-Bench runs offline with the
byte tokenizer, and the sweep scrapes the port testbed's metrics. No test
reaches the network: the MT-Bench download is stubbed."""

import json

import numpy as np
import pytest
import torch

from sequoia_torch.core.config import get_config
from sequoia_torch.core.init import random_params
from sequoia_torch.data import datasets
from sequoia_torch.engine.baseline import ARBaseline
from sequoia_torch.engine.engine import SpecEngine
from sequoia_torch.trees.growmap import uniform_tree

CFG = get_config("test-tiny")
PROMPT = np.array([11, 23, 5, 99, 42, 7])
GREEDY = dict(algorithm="greedy", max_length=128, prefill_chunk=16, device="cpu")
CLI = ["--draft", "test-tiny", "--target", "test-tiny", "--M", "64", "--gen", "8",
       "--dtype", "f32", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    draft = random_params(CFG, 7, dtype=torch.float32, device="cpu")
    target = random_params(CFG, 8, dtype=torch.float32, device="cpu")
    return draft, target


@pytest.fixture(scope="module")
def greedy_run(tiny):
    """One engine and its whole-sequence outputs (24 new tokens)."""
    eng = SpecEngine(tiny[0], CFG, tiny[1], CFG, uniform_tree(3, 2), **GREEDY)
    return eng, eng.generate(PROMPT, max_new_tokens=24, seed=0)


def test_stream_matches_generate(greedy_run):
    eng, full = greedy_run
    streamed = list(eng.stream(PROMPT, max_new_tokens=24, seed=0))
    np.testing.assert_array_equal(np.concatenate([PROMPT] + streamed), full)
    # every chunk: at least the bonus token, at most the tree's depth + 1
    assert all(1 <= len(c) <= eng.max_depth + 1 for c in streamed)


@pytest.mark.parametrize("chunk", [1, 5, 16, 64])
def test_stream_fast_matches_generate(greedy_run, chunk):
    """The device loop's chunks commit exactly what `generate` commits, for
    any chunk size (budgets not divisible by the chunk included)."""
    eng, full = greedy_run
    streamed = list(eng.stream_fast(PROMPT, max_new_tokens=24, chunk_tokens=chunk, seed=0))
    np.testing.assert_array_equal(np.concatenate([PROMPT] + streamed), full)
    assert all(1 <= len(c) <= chunk + eng.max_depth + 1 for c in streamed)


def test_baseline_stream_matches_generate(tiny):
    ar = ARBaseline(tiny[1], CFG, max_length=64, greedy=True, prefill_chunk=16, device="cpu")
    prompt = np.array([3, 1, 4, 1, 5])
    full = ar.generate(prompt, max_new_tokens=16)
    streamed = list(ar.stream(prompt, max_new_tokens=16))
    np.testing.assert_array_equal(np.concatenate([prompt] + streamed), full)


@pytest.mark.parametrize("extra,want", [
    (["--mode", "spec", "--algorithm", "greedy", "--growmap", "chain:4",
      "--prompts", "synthetic:2,10", "--limit", "1"], "=== prompt 0"),
    (["--mode", "baseline", "--algorithm", "greedy", "--prompts", "synthetic:2,10",
      "--limit", "1"], "=== prompt 0"),
    (["--mode", "spec", "--algorithm", "sequoia", "--growmap", "tree:2x2",
      "--prompts", "synthetic:1,10", "--quant", "int8"], "per-token latency"),
    (["--mode", "spec", "--algorithm", "sequoia", "--growmap", "tree:2x2",
      "--prompts", "synthetic:1,10", "--offloading", "--staylayer", "1"],
     "accepted tokens per target step"),
])
def test_chat_cli(capsys, extra, want):
    """Token-id mode: spec and baseline, int8 target weights, and a target
    offloaded with one layer kept on the device."""
    from sequoia_torch.cli.chat import main

    main(CLI + extra)
    out = capsys.readouterr().out
    assert "total time" in out and want in out


def test_chat_cli_refuses_tensor_parallelism():
    """`--tp 2` needs a process group (torchrun's ranks,
    tests/test_torch_distributed.py runs it so); a single process without
    one is refused, and so are the single-card paths under --tp."""
    from sequoia_torch.cli.chat import main

    with pytest.raises(RuntimeError, match="process group"):
        main(CLI + ["--tp", "2", "--prompts", "synthetic:1,10"])
    with pytest.raises(ValueError, match="offloading"):
        main(CLI + ["--tp", "2", "--offloading", "--prompts", "synthetic:1,10"])


def test_chat_mt_bench_offline_byte_tokenizer(capsys, tmp_path):
    """MT-Bench prompts (the bundled file: the data root is empty) through
    the chat CLI with the byte tokenizer: the no-network chat path."""
    from sequoia_torch.cli.chat import main

    main(["--draft", "test-tiny", "--target", "test-tiny", "--tokenizer", "byte",
          "--growmap", "chain:3", "--algorithm", "greedy", "--M", "1024", "--gen", "8",
          "--limit", "1", "--dtype", "f32", "--device", "cpu",
          "--data-root", str(tmp_path / "dataset")])
    out = capsys.readouterr().out
    assert "accepted tokens per target step" in out


def test_ensure_mt_bench(tmp_path, monkeypatch):
    """The data root's file first, then the bundled one; with neither, the
    download is tried (stubbed here) and its failure raises."""
    calls = []

    def offline(url, path):
        calls.append(url)
        raise OSError("no network")

    monkeypatch.setattr(datasets, "_fetch", offline)
    assert datasets.ensure_mt_bench(str(tmp_path)) == datasets.BUNDLED_MT_BENCH
    assert len(datasets.load_mt_bench_prompts(datasets.BUNDLED_MT_BENCH)) == 80
    local = tmp_path / "mt_bench.jsonl"
    local.write_text(json.dumps({"question_id": 1, "turns": ["hi", "again"]}) + "\n")
    assert datasets.ensure_mt_bench(str(tmp_path)) == str(local)
    assert datasets.load_mt_bench_prompts(str(local)) == ["hi"]
    monkeypatch.setattr(datasets, "BUNDLED_MT_BENCH", str(tmp_path / "absent.jsonl"))
    with pytest.raises(RuntimeError, match="download failed"):
        datasets.ensure_mt_bench(str(tmp_path / "empty"))
    assert calls == [datasets.MT_BENCH_URL]


def test_sweep_parses_the_testbed_and_runs_a_grid(tmp_path, capsys):
    """`parse_metrics` reads the port testbed's metric block; a two-point
    grid logs one JSON line a point, with those metrics."""
    from sequoia_torch.cli.sweep import main as sweep, parse_metrics
    from sequoia_torch.cli.testbed import main as testbed

    args = ["--algorithm", "greedy", "--mode", "spec", "--prompts", "synthetic:1,10"]
    testbed(CLI + ["--growmap", "chain:2"] + args)
    m = parse_metrics(capsys.readouterr().out)
    assert set(m) == {"total_time_s", "tokens", "large_model_steps", "ms_per_token",
                      "accepted_per_step"}
    assert 0 < m["tokens"] <= 8 and 0 < m["large_model_steps"] <= m["tokens"]

    log = tmp_path / "results.jsonl"
    sweep(["--pairs", "test-tiny:test-tiny", "--algorithms", "greedy",
           "--growmaps", "chain:2,tree:2x2", "--prompts", "synthetic:1,10", "--M", "64",
           "--gen", "8", "--dtype", "f32", "--device", "cpu", "--log", str(log)])
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["growmap"] for r in records] == ["chain:2", "tree:2x2"]
    for r in records:
        assert "error" not in r and r["tokens"] == m["tokens"] and r["ms_per_token"] > 0
