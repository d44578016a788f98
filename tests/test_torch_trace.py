"""The tracer (`sequoia_torch/trace.py`) on the engines, on the CPU: off it
records nothing and calls neither a CUDA event nor the profiler; under
`enable()` the spans nest by time, one `request` span a request, and the
counters equal the engine's own; under a profiler with no `enable()` every
marked span has its marker pair in the trace, and no marker makes a
device-side annotation; a graph replay's span holds the replay. On
the card (marked `cuda`) the replay spans carry device time and leave the
captured graphs as they were."""

import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sequoia_torch import trace
from sequoia_torch.core.config import get_config
from sequoia_torch.core.init import random_params
from sequoia_torch.engine.batched import BatchedSpecEngine
from sequoia_torch.engine.engine import SpecEngine
from sequoia_torch.trees.growmap import uniform_tree

CFG = get_config("test-tiny")
PROMPTS = [np.arange(5, 20), np.array([3, 1, 4, 1, 5, 9, 2, 6]), np.arange(40, 75), np.array([42])]
COMMON = dict(algorithm="sequoia", max_length=96, prefill_chunk=16, temperature=0.8, top_p=0.9)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def models():
    return (random_params(CFG, 0, dtype=torch.float32, device="cpu"),
            random_params(CFG, 1, dtype=torch.float32, device="cpu"))


def _single(models, device="cpu"):
    d, t = models
    return SpecEngine(d, CFG, t, CFG, uniform_tree(2, 2), device=device, **COMMON)


def _batched(models, admit_width=None):
    d, t = models
    return BatchedSpecEngine(d, CFG, t, CFG, uniform_tree(2, 2), device="cpu", batch_size=2,
                             admit_width=admit_width, **COMMON)


def _stream(eng, prompt, seed=1):
    return list(eng.stream_fast(prompt, max_new_tokens=12, chunk_tokens=4, seed=seed))


def test_off_records_nothing_and_calls_nothing(models, monkeypatch):
    calls = []
    spy = lambda *a, **k: calls.append((a, k))  # noqa: E731
    monkeypatch.setattr(trace, "record_function", spy)
    monkeypatch.setattr(torch.cuda, "Event", spy)
    monkeypatch.setattr(trace, "Span", spy)
    monkeypatch.setattr(trace, "PhaseClock", spy)
    assert not trace.on()
    _stream(_single(models), PROMPTS[0])
    _batched(models).serve_device(PROMPTS[:3], max_new_tokens=6, seed=0)
    assert calls == [] and trace.records() == [] and trace.counters() == {}


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _parent(r, recs, names):
    """The innermost span of `names` that holds `r` (by time)."""
    holders = [o for o in recs if o is not r and o.name in names and _inside(r, o)]
    return max(holders, key=lambda o: o.start_ns) if holders else None


@pytest.mark.parametrize("entry", ["stream_fast", "generate_fast"])
def test_enable_nests_spans_one_request_id_each(models, entry):
    eng = _single(models)
    iterations, finalize = [0], eng._finalize_counted

    def counted(*args):
        iterations[0] += 1
        return finalize(*args)

    eng._finalize_counted = counted
    with trace.enable():
        assert trace.on()
        for i, p in enumerate(PROMPTS[:2]):
            if entry == "stream_fast":
                _stream(eng, p, seed=i)
            else:
                eng.generate_fast(p, max_new_tokens=12, seed=i)
    assert not trace.on()
    recs = trace.records()
    requests = [r for r in recs if r.name == "request"]
    assert len(requests) == 2 and requests[0].end_ns <= requests[1].start_ns
    want_parent = {"prefill": "request", "loop": "request", "chunk_out": "request",
                   "block": "loop", "host_read": "loop"}
    for r in recs:
        if r.name != "request":
            assert _parent(r, recs, set(want_parent.values())).name == want_parent[r.name]
    for q in requests:   # each request's spans inside its own span
        names = Counter(r.name for r in recs if r is not q and _inside(r, q))
        assert names["prefill"] == 1 and names["loop"] >= 1
    names = Counter(r.name for r in recs)
    assert names["prefill"] == 2 and names["host_read"] == names["block"] >= 2
    assert (names["chunk_out"] > 0) == (entry == "stream_fast")
    # uniform_tree(2, 2): the first grow level's forward and the re-draft
    # an iteration, no-op ones of a block included
    assert trace.counters() == {"prefill_tokens": len(PROMPTS[0]) + len(PROMPTS[1]),
                                "draft_forwards": 2 * iterations[0]}
    for r in recs:   # the CPU's device clock is the host's
        assert (r.device_ms is not None) == (r.name == "prefill")
        assert r.host_ms > 0


@pytest.mark.parametrize("admit_width", [1, 2])
def test_serve_device_spans_and_counters_equal_the_engines(models, admit_width):
    eng = _batched(models, admit_width)
    with trace.enable():
        eng.serve_device(PROMPTS, max_new_tokens=6, seed=0)
    recs, c = trace.records(), trace.counters()
    assert eng.num_prefill_steps > 0
    assert c["admit_entries"] == eng.admit_width * eng.num_prefill_steps
    # every prompt chunk of 16 is one valid entry
    assert c["admit_valid"] == sum(-(-len(p) // 16) for p in PROMPTS) <= c["admit_entries"]
    assert set(c) == {"admit_entries", "admit_valid"}
    serve = [r for r in recs if r.name == "serve"]
    assert len(serve) == 1
    names = Counter(r.name for r in recs)
    assert names["admit.plan"] == eng.num_prefill_steps
    assert names["harvest"] == names["decode"] >= 1
    for r in recs:
        if r.name in ("admit.plan", "harvest", "decode"):
            assert _parent(r, recs, {"serve", "decode"}) is serve[0]
        if r.name == "block":
            assert _parent(r, recs, {"serve", "decode"}).name == "decode"


def _markers(prof):
    return sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.name.startswith("sequoia."))


def test_profiler_turns_it_on_and_every_span_has_its_markers(models):
    eng, beng = _single(models), _batched(models)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        _stream(eng, PROMPTS[0])
        beng.serve_device(PROMPTS[:3], max_new_tokens=6, seed=0)
    assert not trace.on()
    recs = trace.records()
    assert recs and trace.counters()["admit_entries"] == beng.admit_width * beng.num_prefill_steps
    # The markers, in time order, open and close the spans as a stack.
    stack, closed = [], Counter()
    for _, name in _markers(prof):
        span, edge = name[len("sequoia."):].rsplit(".", 1)
        if edge == "begin":
            stack.append(span)
        else:
            assert stack.pop() == span
            closed[span] += 1
    assert stack == [] and closed == Counter(r.name for r in recs if r.markers)
    events = prof.events()
    assert not [e.name for e in events
                if e.is_user_annotation and e.device_type != DeviceType.CPU]


def test_capturing_stream_turns_it_off(monkeypatch):
    monkeypatch.setattr(trace, "_cuda", True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with trace.enable():
        assert not trace.on()
        with trace.span("x") as s:
            assert s is None
        trace.count("n")
    assert trace.records() == [] and trace.counters() == {}


def test_spans_outside_engines_nest_and_reset():
    with trace.enable():
        with trace.enable():
            with trace.span("a") as a:
                with trace.span("b", device=torch.device("cpu")) as b:
                    pass
                trace.count("n", 3)
        assert trace.on()
        trace.count("n")
    recs = trace.records()
    assert [r.name for r in recs] == ["b", "a"] and _inside(b, a)
    assert a.device_ms is None and 0 <= b.device_ms <= a.host_ms
    assert trace.counters() == {"n": 4}
    trace.reset()
    assert trace.records() == [] and trace.counters() == {}


def test_a_replay_span_holds_each_replay_and_no_markers():
    from sequoia_torch.engine.graphs import GraphSet, _Captured

    seen = []

    class Graph:
        def replay(self):
            seen.append(time.perf_counter_ns())

    graphs = object.__new__(GraphSet)   # a CPU stand-in: no capture, one fake graph
    graphs.device = torch.device("cpu")
    graphs.graphs = {"grow": _Captured(Graph(), {}, None, 0.0)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graphs.replay("grow", times=2)
    recs = trace.records()
    assert [r.name for r in recs] == ["replay.grow"] * 2
    assert all(not r.markers and r.device_ms is not None for r in recs)
    assert all(r.start_ns <= t <= r.end_ns for r, t in zip(recs, seen))
    assert _markers(prof) == []
    graphs.replay("grow")   # off: the replay alone
    assert len(seen) == 3 and len(trace.records()) == 2 and graphs.graphs["grow"].replays == 3


def test_phase_clock_names_each_phase():
    clock = trace.PhaseClock(torch.device("cpu"))
    for name in ("draft_run", "target_run", "accept_kv"):
        clock.mark(name)
        torch.ones(64, 64) @ torch.ones(64, 64)
    clock.mark()
    secs = clock.seconds()
    assert set(secs) == {"draft_run", "target_run", "accept_kv"}
    assert all(v >= 0 for v in secs.values())


@pytest.mark.cuda
def test_replay_spans_on_the_card_leave_the_graphs_alone(models):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import graph_nodes

    dev = torch.device("cuda")
    cuda_models = tuple(random_params(CFG, i, dtype=torch.bfloat16, device=dev) for i in (0, 1))
    nodes = {}
    for mode in ("off", "enable", "profile"):
        eng = _single(cuda_models, device=dev)
        if mode == "off":
            _stream(eng, PROMPTS[0])
        elif mode == "enable":
            with trace.enable():
                _stream(eng, PROMPTS[0])
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _stream(eng, PROMPTS[0])
        nodes[mode] = {n: graph_nodes(g.graph) for n, g in eng._graphs.graphs.items()}
    assert nodes["off"] == nodes["enable"] == nodes["profile"]
    recs = trace.records()
    replays = [r for r in recs if r.name.startswith("replay.")]
    assert replays and all(r.device_ms > 0 for r in replays)
    cuda_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert cuda_events
    assert not [e.name for e in cuda_events if e.is_user_annotation or "sequoia." in e.name]
