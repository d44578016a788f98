"""The work and byte arithmetic, and the trace reductions behind the
per-layer metrics."""

import types

import pytest

from perfbench import work
from perfbench.families import llama
from perfbench.metrics import _roofline
from perfbench.spec import metric_reader
from perfbench.trace import idle_gaps, kernel_seconds, label_gaps, top_ops, union_seconds

# A chain of 3 nodes below the root: levels of width 1, 1 at depths 1, 2.
CHAIN = work.Tree(size=3, depth=[0, 1, 2], widths=[1, 1], starts=[1, 2])
DIMS = llama.Dims(vocab=100, hidden=8, intermediate=16, layers=2, heads=2, kv_heads=1,
                  head_dim=4, rope_theta=1e4, eps=1e-5, tied=False)


def test_chunk_and_prefill_calls():
    c = work.chunk_call("target", 4, 3)   # rows attend 5, 6, 7 keys
    assert (c.rows, c.keys, c.kv_rows) == (3, 18, 7)
    calls = work.prefill_calls(10, 4)      # chunks 4, 4, 2
    assert [c.rows for c in calls] == [4, 4, 4, 4, 2, 2]
    assert sum(c.keys for c in calls if c.model == "draft") == sum(range(1, 11))


def test_iteration_calls_of_a_chain():
    calls = work.iteration_calls(CHAIN, [(10, 12)])
    grow1, grow2, verify, redraft = calls
    assert (grow1.model, grow1.rows, grow1.keys, grow1.kv_rows) == ("draft", 1, 11, 11)
    assert (grow2.rows, grow2.keys, grow2.kv_rows) == (1, 12, 12)
    # verify: 3 nodes over 9 rows before the root, plus 1, 2, 3 ancestors
    assert (verify.model, verify.rows, verify.keys, verify.kv_rows) == ("target", 3, 33, 12)
    assert (redraft.rows, redraft.keys, redraft.kv_rows) == (1, 12, 12)
    two = work.iteration_calls(CHAIN, [(10, 12), (20, 21)])
    assert two[2].rows == 6 and two[2].keys == 33 + 63
    assert work.iteration_calls(CHAIN, []) == []


def test_from_snaps_skips_slots_that_commit_nothing():
    snaps = [("prefill", 5), ("before", [10, 7]), ("after", [12, 7]),
             ("admit", [[0, 5, 1], [16, 3, 0]]), ("before", 4), ("after", 4)]
    calls = work.from_snaps(snaps, CHAIN, 16)
    assert sum(c.rows for c in calls if c.model == "target") == 5 + 3 + 5


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union_seconds(spans) == pytest.approx(3.0)
    assert idle_gaps(spans, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    host = [("outer", 1.5, 3.5), ("inner", 1.9, 2.5)]
    assert label_gaps(idle_gaps(spans, 0.0, 5.0), host) == [["inner", 1.0], ["host", 1.0]]
    k = [("void qmm8_sm90<1>", 0.0, 1.0), ("tree_attention_tc_kernel", 1.0, 1.5),
         ("void qmm8_sm90<1>", 2.0, 2.25)]
    assert kernel_seconds(k, ("qmm8_sm90",)) == pytest.approx(1.25)
    assert top_ops(k)[0] == ["void qmm8_sm90<1>", 1.25]


def _run(calls, kernels, trace_s=1.0, target="int8", kv="bf16"):
    return types.SimpleNamespace(calls=calls, kernels=kernels, trace_s=trace_s,
                                 dims={"draft": DIMS, "target": DIMS},
                                 formats={"target": target, "draft": "bf16"},
                                 cell=types.SimpleNamespace(config={"kv_cache": kv}))


def test_attention_roofline_by_hand():
    call = work.Call("target", rows=4, keys=400, kv_rows=100)
    flops = 4 * 2 * 4 * 400
    nbytes = 2 * (2 * 4 * 2 * 4 + 2 * 100 * 1 * 4)
    bound = 2 * _roofline.bound_s(flops, nbytes)      # two layers
    assert bound == pytest.approx(2 * nbytes / 3.35e12)
    run = _run([call], [("tree_attention_tc_kernel", 0.0, 2 * bound)])
    assert metric_reader("attn_roofline.single")(run) == pytest.approx(50.0)
    assert metric_reader("attn_roofline.batched")(_run([call], [])) is None
    assert metric_reader("attn_roofline.single")(_run([call], run.kernels, kv="int8")) is None


def test_qmm_roofline_and_mfu_by_hand():
    call = work.Call("target", rows=2, keys=10, kv_rows=5)
    per_layer = sum(max(2 * 2 * K * N / 989e12,
                        (K * N + 4 * N + 2 * 2 * K + 2 * 2 * N) / 3.35e12)
                    for K, N in (DIMS.shape(n) for n in llama.PROJECTIONS))
    head = max(2 * 2 * 8 * 100 / 989e12, (800 + 400 + 32 + 800) / 3.35e12)
    bound = 2 * per_layer + head
    kernels = [("void qmm8_sm90<false,1,64>", 0.0, 4 * bound)]
    assert metric_reader("qmm_roofline.batched")(_run([call], kernels)) == pytest.approx(25.0)
    assert metric_reader("qmm_roofline.single")(_run([call], kernels, target="bf16")) is None
    flops = 2 * 2 * DIMS.projection_params() + 4 * 2 * 4 * 10 * 2
    assert metric_reader("step_mfu.single")(_run([call], kernels, trace_s=2.0)) == \
        pytest.approx(100 * flops / (2.0 * 989e12))


def test_idle_share_and_phase_readers():
    run = _run([], [("k", 0.0, 0.25), ("memcpy", 0.2, 0.5)], trace_s=2.0)
    assert metric_reader("idle_share.batched")(run) == pytest.approx(75.0)
    run.phase_ms = {"grow": 1.5}
    assert metric_reader("grow_ms.single")(run) == 1.5
    assert metric_reader("verify_ms.single")(run) is None
    run.window = types.SimpleNamespace(sampled_tokens=30, sampled_steps=12)
    assert metric_reader("tokens_per_step.single")(run) == 2.5
    assert metric_reader("tokens_per_iter.batched")(run) == 2.5
    run.ttfc = [0.1, 0.3, 0.2]
    assert metric_reader("ttfc_ms.single")(run) == pytest.approx(200.0)
