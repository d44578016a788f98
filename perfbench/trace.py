"""The device trace of a traced run, and the arithmetic read from it.

`Tap` stands in for an engine's graph set (`engine/graphs.py::GraphSet`) and
passes every call on to it. Around each replay it records CUDA events, so
the device milliseconds of each phase (grow, verify, finalize, admit) are
known for the whole window. While the profiler runs it also copies the
committed lengths before each grow and after each finalize, and each
admission step's inputs, into device buffers: no host read, so the trace
shows the loop as it runs. From those copies `work.py` counts the work the
traffic needed. The profiler runs from the window's first sampled request:
in a `*.single` cell over that whole request, in a batched one for the
mix's `trace_seconds`, stopping at the end of an iteration.

The reductions (interval union, idle gaps, kernel sums) are plain functions
of `(name, start, end)` tuples, so the CPU tests reach them.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float]


def union_seconds(spans: Sequence[Interval]) -> float:
    """Length of the union of `[start, end)` intervals (overlaps counted once)."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(spans: Sequence[Interval], start: float, stop: float) -> List[Interval]:
    """The gaps of `[start, stop)` in which no interval runs, longest first."""
    gaps, end = [], start
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, stop)))
        end = max(end, b)
    if stop > end:
        gaps.append((end, stop))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])


def kernel_seconds(kernels: Sequence[Tuple[str, float, float]], patterns: Sequence[str]) -> float:
    """Summed duration of the kernels whose name holds one of `patterns`."""
    return sum(b - a for n, a, b in kernels if any(p in n for p in patterns))


def top_ops(kernels: Sequence[Tuple[str, float, float]], n: int = 10) -> List[list]:
    """The `n` device operations that took most time, summed by name."""
    tot: Dict[str, float] = defaultdict(float)
    for name, a, b in kernels:
        tot[name] += b - a
    return [[k[:200], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class Tap:
    """An engine's graph set with phase events and, while tracing, copies of
    the slots' committed lengths (module doc)."""

    def __init__(self, graphs, engine, session: "TraceSession", batched: bool):
        self._g = graphs
        self._eng = engine
        self._session = session
        self._batched = batched
        self.events: Dict[str, List[tuple]] = defaultdict(list)
        self.snaps: List[tuple] = []   # (kind, device tensor)

    def __getattr__(self, name):
        return getattr(self._g, name)

    def _gtl(self) -> torch.Tensor:
        return (self._eng._bstate.gtl if self._batched else self._eng._gtl).clone()

    def replay(self, name: str, times: int = 1) -> None:
        for _ in range(times):
            tracing = self._session.tracing
            if tracing and name == "grow":
                self.snaps.append(("before", self._gtl()))
            if tracing and name == "admit":
                C = self._eng.prefill_chunk
                self.snaps.append(("admit", self._eng._adm[:, C:C + 3].clone()))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self._g.replay(name)
            b.record()
            self.events[name].append((a, b))
            if tracing and name == "finalize":
                self.snaps.append(("after", self._gtl()))
            if tracing and name in ("finalize", "admit"):
                self._session.maybe_stop()

    def phase_ms(self) -> Dict[str, float]:
        """Device ms per replay of each phase over the window."""
        out = {}
        for name, evs in self.events.items():
            if evs:
                evs[-1][1].synchronize()
                out[name] = sum(a.elapsed_time(b) for a, b in evs) / len(evs)
        return out


class TraceSession:
    """The profiler over the traced part of the window."""

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self.tracing = False
        self.prof = None
        self.t0 = self.t1 = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in the set-up: its first start
        loads and initialises CUPTI."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.tracing = True
        self.t0 = time.perf_counter()

    def maybe_stop(self, force: bool = False) -> None:
        due = self.seconds is not None and time.perf_counter() - self.t0 >= self.seconds
        if self.tracing and (force or due):
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.tracing = False

    @property
    def window_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def device_ops(self) -> Tuple[List[Tuple[str, float, float]], List[Tuple[str, float, float]]]:
        """(device operations, host operations) of the trace as `(name,
        start s, end s)`, on one clock."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self.prof.events():
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if b <= a:
                continue
            (dev if e.device_type == DeviceType.CUDA else host).append((e.name, a, b))
        return dev, host


def label_gaps(gaps: Sequence[Interval], host: Sequence[Tuple[str, float, float]],
               n: int = 10) -> List[list]:
    """The `n` longest gaps, each named by the innermost host operation
    running at its start ("host" where none is)."""
    out = []
    for a, b in gaps[:n]:
        inner = None
        for name, s, e in host:
            if s <= a < e and (inner is None or s >= inner[1]):
                inner = (name, s)
        out.append([inner[0][:200] if inner else "host", b - a])
    return out
