"""The readers of the program's spans and counters (`metrics/_spans.py` and
the metrics on it) on hand-built traces and a fake tracer: the idle split by
innermost span and the idle share inside the spans that do work, by hand;
the admission and prefill readings; and nothing where nothing was recorded
(a program without the tracer)."""

import sys
from types import SimpleNamespace

import pytest

from perfbench.metrics import _spans
from perfbench.spec import metric_reader


def _run(kernels, host, trace_s):
    return SimpleNamespace(kernels=kernels, host=host, trace_s=trace_s)


def _m(name, a, b=None):
    return (f"sequoia.{name}", a, a + 0.01 if b is None else b)


# Kernels busy [0, 1), [3, 4), [6, 10): idle [1, 3) and [4, 6) of a 10 s window.
KERNELS = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 10.0)]


def test_idle_program_share_by_hand():
    host = [("cudaGraphLaunch", 0.5, 1.5),           # the first gap starts inside it
            _m("loop.begin", 0.2), _m("host_read.begin", 2.5),
            _m("host_read.end", 3.49), _m("loop.end", 5.0),   # loop ends at 5.01
            ("aten::copy_", 4.2, 4.4)]
    run = _run(KERNELS, host, 10.0)
    # idle [1, 3) and [4, 6): the launch's [1, 1.5); host_read's [2.5, 3); the
    # umbrella loop's [1.5, 2.5) and [4, 5.01); outside every span [5.01, 6)
    split = _spans.idle_split(run)
    assert split == pytest.approx({"launch": 0.5, "host_read": 0.5, "loop": 2.01, "none": 0.99})
    got = metric_reader("idle_program_share.single")(run)
    assert got == pytest.approx(100.0 * 0.5 / 10.0)


def test_idle_program_share_a_span_the_trace_cut_ends_at_its_stop():
    host = [_m("serve.begin", 0.0), _m("admit.plan.begin", 4.5)]   # no end markers
    run = _run(KERNELS, host, 10.0)
    assert _spans.idle_split(run) == pytest.approx(
        {"launch": 0.0, "serve": 2.5, "admit.plan": 1.5, "none": 0.0})
    got = metric_reader("idle_program_share.batched")(run)
    assert got == pytest.approx(100.0 * 1.5 / 10.0)


def test_innermost_names_each_piece_by_the_span_started_last():
    spans = [("serve", 0.0, 10.0), ("decode", 2.0, 8.0), ("block", 3.0, 4.0),
             ("host_read", 4.0, 5.0), ("harvest", 9.0, 12.0)]
    assert _spans.innermost(spans) == [
        ("serve", 0.0, 2.0), ("decode", 2.0, 3.0), ("block", 3.0, 4.0),
        ("host_read", 4.0, 5.0), ("decode", 5.0, 8.0), ("serve", 8.0, 9.0),
        ("harvest", 9.0, 10.0), ("harvest", 10.0, 12.0)]


def test_idle_program_share_needs_markers_and_kernels():
    read = metric_reader("idle_program_share.single")
    assert read(_run(KERNELS, [("cudaGraphLaunch", 0.5, 1.5)], 10.0)) is None
    assert read(_run([], [_m("loop.begin", 0.2)], 10.0)) is None
    assert read(_run(KERNELS, [_m("loop.begin", 0.2)], None)) is None


def test_marker_pairs_nest_by_name():
    host = [_m("block.begin", 1.0), _m("block.end", 2.0), _m("block.begin", 3.0),
            _m("replay.grow.begin", 3.1), _m("replay.grow.end", 3.2),
            _m("block.end", 4.0), _m("host_read.end", 0.5)]   # its begin before the trace
    assert sorted(_spans.marked(host, 9.0)) == [
        ("block", 1.0, 2.01), ("block", 3.0, 4.01), ("replay.grow", 3.1, 3.21)]


def test_interval_arithmetic():
    assert _spans.merged([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2), (3, 4)]
    assert _spans.overlap([(0, 2), (3, 6)], [(1, 4), (5, 7)]) == [(1, 2), (3, 4), (5, 6)]
    assert _spans.minus([(0, 10)], [(1, 2), (4, 5), (9, 12)]) == [(0, 1), (2, 4), (5, 9)]


def _span(name, host_ms, device_ms=None):
    return SimpleNamespace(name=name, host_ms=host_ms, device_ms=device_ms)


@pytest.fixture
def fake(monkeypatch):
    state = SimpleNamespace(records=[], counters={})
    tracer = SimpleNamespace(records=lambda: list(state.records),
                             counters=lambda: dict(state.counters))
    monkeypatch.setattr(_spans, "tracer", lambda: tracer)
    return state


def test_program_readers_on_a_fake_tracer(fake):
    fake.records = [_span("prefill", 410.0, 400.0), _span("prefill", 90.0, 100.0),
                    _span("replay.admit", 0.02, 1.5), _span("replay.admit", 0.03, 2.5),
                    _span("replay.grow", 0.01, 8.0), _span("host_read", 0.2)]
    fake.counters = {"prefill_tokens": 1000, "admit_entries": 20, "admit_valid": 13}
    run = _run([], [], None)
    assert metric_reader("prefill_us_per_token.single")(run) == 500.0
    assert metric_reader("prefill_host_share.single")(run) == 100.0
    assert metric_reader("admit_ms.batched")(run) == 2.0
    assert metric_reader("admit_fill.batched")(run) == 65.0


READERS = ["prefill_us_per_token.single", "prefill_host_share.single", "admit_ms.batched",
           "admit_fill.batched"]


@pytest.mark.parametrize("name", READERS)
def test_program_readers_read_none_where_nothing_was_recorded(fake, name):
    fake.records = [_span("replay.grow", 0.01, 8.0), _span("block", 1.0)]
    assert metric_reader(name)(_run([], [], None)) is None


@pytest.mark.parametrize("name", READERS)
def test_program_readers_without_the_tracer(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "sequoia_torch.trace", None)   # import fails
    import sequoia_torch

    monkeypatch.delattr(sequoia_torch, "trace", raising=False)
    assert _spans.tracer() is None
    assert metric_reader(name)(_run([], [], None)) is None


def test_the_real_tracer_feeds_the_readers():
    import torch

    from sequoia_torch import trace

    trace.reset()
    try:
        with trace.enable():
            with trace.span("prefill", device=torch.device("cpu")):
                trace.count("prefill_tokens", 8)
                sum(range(10000))
            trace.count("admit_entries", 4)
            trace.count("admit_valid", 3)
        run = _run([], [], None)
        assert metric_reader("prefill_us_per_token.single")(run) > 0
        assert metric_reader("prefill_host_share.single")(run) > 0
        assert metric_reader("admit_fill.batched")(run) == 75.0
        assert metric_reader("admit_ms.batched")(run) is None
    finally:
        trace.reset()
