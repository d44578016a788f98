"""CUDA-graph capture and replay for the engines' device loops.

JAX compiles the decode loop once and runs it on the device
(`sequoia_tpu/engine/engine.py::_generate_loop_impl`, `baseline.py::_loop_impl`).
Here each phase of a step is captured once into a CUDA graph and replayed:
the host then issues one launch a phase where the eager loop issued
hundreds of kernels.

`GraphSet` holds the graphs of one engine:

- one memory pool for all of them, so a later phase reads the tensors an
  earlier one wrote (captured phases must then replay in their capture
  order, which the engines do);
- a key (the engine's cache format and matmul routes): a new key drops every
  graph and the next `capture` makes them anew;
- the engine's generators (none, one, or one per slot of a batched
  engine), each registered with every graph: a replay draws from each
  generator's seed and offset at that moment and advances the offset by
  the graph's draws from it, so one seed gives the same numbers eager and
  replayed, and `manual_seed` of one generator between replays reseeds
  that generator's draws alone (a batched engine's new request in one
  slot);
- the launch counters: a wrapper's counter ticks when its Python code runs,
  which for a captured kernel is once, at capture, when nothing launches.
  `capture` records each counter's delta and takes it back out;
  `replay` adds delta x replays, so `build.launches` counts launches on the
  card.

Capture warms up first (`warmup`): the phases run once eagerly on a side
stream, which builds the kernels (`build.load()`), creates cuBLAS handles,
loads lazy modules and allocates the offload staging buffers before any of
that could fall inside a capture. No timing event is recorded inside a
capture: the engines' phase clocks and the tracer's spans mark between
replays, and the tracer is off while a stream captures. Ordering events
are: a forward over host-offloaded layers (`core/model.py::_layer_weights`)
forks its copy stream from the capturing stream and joins it back with
events (`wait_stream` / `wait_event`), so its host-to-device copies and
their order against the compute are nodes of the same graph. A capture or
a replay that fails raises: nothing falls back to the eager loop.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Sequence

import torch

from .. import trace
from ..kernels import build


class _Captured:
    def __init__(self, graph, delta: Dict[str, int], outputs, seconds: float):
        self.graph = graph
        self.delta = delta
        self.outputs = outputs
        self.seconds = seconds
        self.replays = 0


class GraphSet:
    """The captured phases of one engine on one CUDA device."""

    def __init__(self, device: torch.device, generators: Sequence[torch.Generator] = ()):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self.generators = list(generators)
        # "thread_local" under NCCL collectives: their watchdog thread polls
        # events while this thread captures, which "global" would refuse.
        self.error_mode = "global"
        self.key = None
        self.pool = None
        self.graphs: Dict[str, _Captured] = {}

    def reset(self, key) -> None:
        """Drop every graph (and its pool); the next captures are for `key`."""
        self.graphs = {}
        self.pool = None
        self.key = key

    def ensure(self, key, capture: Callable) -> None:
        """Capture anew unless the graphs of `key` exist: `capture(self)`
        warms up and captures. A failure drops every graph and raises."""
        if self.key == key and self.graphs:
            return
        self.reset(key)
        try:
            capture(self)
        except BaseException:
            self.reset(None)
            raise

    @contextmanager
    def warmup(self):
        """Run the body on a side stream (eager launches, counted as such),
        then restore the generators' states: the warm-up draws nothing that
        a later run sees."""
        states = [g.get_state() for g in self.generators]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            yield
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        for g, state in zip(self.generators, states):
            g.set_state(state)

    def capture(self, name: str, fn: Callable):
        """Capture `fn()` as graph `name`; returns its outputs, whose memory
        every replay rewrites. The graph keeps its nodes (`raw_cuda_graph`),
        so they can be counted."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.generators:
            graph.register_generator_state(g)
        before = dict(build.launches)
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, pool=self.pool, capture_error_mode=self.error_mode):
                outputs = fn()
            graph.instantiate()
        finally:
            delta = {k: v - before.get(k, 0) for k, v in build.launches.items()}
            for k, v in before.items():
                build.launches[k] = v
        seconds = time.perf_counter() - t0
        self.graphs[name] = _Captured(graph, {k: v for k, v in delta.items() if v},
                                      outputs, seconds)
        return outputs

    def outputs(self, name: str):
        return self.graphs[name].outputs

    def replay(self, name: str, times: int = 1) -> None:
        """Replay graph `name` `times` times on the current stream, each
        replay the span `replay.<name>` with device time (`trace.py`), and
        count its kernels' launches. The span has no profiler markers, so
        only its start event goes ahead of the launch (the engines' `block`
        spans around the replays carry markers)."""
        g = self.graphs[name]
        span = "replay." + name
        for _ in range(times):
            with trace.span(span, device=self.device, markers=False):
                g.graph.replay()
        g.replays += times
        for k, v in g.delta.items():
            build.launches[k] += v * times

    def report(self) -> Dict[str, dict]:
        """{name: capture seconds, replays, counted launches per replay}."""
        return {n: {"capture_s": g.seconds, "replays": g.replays, "launches": dict(g.delta)}
                for n, g in self.graphs.items()}
