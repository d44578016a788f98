"""Spans and counters of the engines, on the host clock, the device's and
the profiler's.

The tracer is process-wide. It records only while it is on (`on()`): inside
`enable()`, or while a torch profiler runs, and never while the current
stream captures a CUDA graph. Off, each hook costs that one check: no
record, no CUDA event, no profiler marker, and no node in a captured graph.

- `span(name, device=None, markers=True)`: a context manager. It records
  the name and the span's start and end on `time.perf_counter_ns`. With
  `device` (a `torch.device`) it also records the span's device time: a
  CUDA event pair on the current stream on the card, the host clock on the
  CPU. With `markers`, while a profiler runs, it emits two marker ranges,
  `sequoia.<name>.begin` and `sequoia.<name>.end`, each entered and left at
  once: they enclose no launch, so the profiler makes no device-side
  annotation of them, and they put the span on the trace's clock, where
  spans nest by time. A span entered while the tracer is on is recorded
  whole, whenever it ends.
- `count(name, n=1)`: add to a counter.
- `records()`, `counters()`, `reset()`: the finished spans (device times
  resolved once, at read time, with one synchronize), the counters, and
  both cleared.
- `PhaseClock`: named marks on the same device clock as the spans', for
  the per-phase times of `iterate_phased`.

The names the engines use, and what reads them: `PERF.md` §3.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled
_depth = 0          # enable() calls in force
_cuda = None        # whether CUDA is there (asked once, when first on)
_done: List["Span"] = []
_counts: Dict[str, int] = {}


def on() -> bool:
    """Whether the hooks record: `enable()` in force or a profiler running,
    and the current stream not capturing a graph."""
    if not (_depth or _profiling()):
        return False
    global _cuda
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    return not (_cuda and torch.cuda.is_current_stream_capturing())


@contextmanager
def enable():
    """Record inside the block, with no profiler (nested blocks count)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _stamp(cuda: bool):
    """A point on the device clock: a CUDA event recorded on the current
    stream on the card (between launches or replays, never inside a
    capture), the host clock on the CPU."""
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _seconds(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) / 1e3 if cuda else b - a


class PhaseClock:
    """Per-phase device time: a phase runs from its mark to the next."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self, name: Optional[str] = None) -> None:
        self.marks.append((name, _stamp(self.cuda)))

    def seconds(self) -> dict:
        """{phase: seconds}; on the card this waits for the last mark."""
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        return {name: _seconds(a, b, self.cuda)
                for (name, a), (_, b) in zip(self.marks, self.marks[1:])}


class Span:
    """One span: its record, and the context manager that makes it."""

    def __init__(self, name: str, device, markers: bool):
        self.name = name
        self.markers = markers
        self.timed = device is not None
        self.cuda = self.timed and torch.device(device).type == "cuda"
        self.start_ns = self.end_ns = None
        self.device_ms: Optional[float] = None
        self._a = self._b = None   # the device pair, until `records()` reads it

    def __enter__(self) -> "Span":
        self.start_ns = time.perf_counter_ns()
        if self.markers:
            self._marker("begin")
        if self.timed:
            self._a = _stamp(self.cuda)
        return self

    def __exit__(self, *exc) -> bool:
        if self.timed:
            self._b = _stamp(self.cuda)
        if self.markers:
            self._marker("end")
        self.end_ns = time.perf_counter_ns()
        _done.append(self)
        return False

    def _marker(self, edge: str) -> None:
        if _profiling():
            with record_function(f"sequoia.{self.name}.{edge}"):
                pass

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, device=None, markers: bool = True):
    """A span (module doc); `with span(...) as s:` gives None while off."""
    if not on():
        return _OFF
    return Span(name, device, markers)


def count(name: str, n: int = 1) -> None:
    if on():
        _counts[name] = _counts.get(name, 0) + int(n)


def records() -> List[Span]:
    """The finished spans in the order they ended; device times resolved
    here, with one synchronize for all of them."""
    pending = [s for s in _done if s._b is not None]
    if any(s.cuda for s in pending):
        torch.cuda.synchronize()
    for s in pending:
        s.device_ms = _seconds(s._a, s._b, s.cuda) * 1e3
        s._a = s._b = None
    return list(_done)


def counters() -> Dict[str, int]:
    return dict(_counts)


def reset() -> None:
    """Clear the finished spans and the counters (open spans stay open)."""
    _done.clear()
    _counts.clear()
