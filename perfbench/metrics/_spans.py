"""Shared by the readers of the program's own spans and counters
(`sequoia_torch/trace.py`): the tracer's records, each span's interval on
the profiler's clock from its `sequoia.<name>.begin` / `.end` markers, and
the traced window's idle time split by the innermost span (`idle_split`).
A program without the tracer gives no record, no counter and no marker."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from perfbench.trace import idle_gaps, union_seconds

Interval = Tuple[float, float]
PREFIX = "sequoia."
# Spans that hold the others and little work of their own.
UMBRELLA = ("request", "serve", "loop", "decode")


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from sequoia_torch import trace
    except ImportError:
        return None
    return trace


def spans(name: str) -> list:
    """The tracer's finished spans named `name`."""
    t = tracer()
    return [] if t is None else [s for s in t.records() if s.name == name]


def counters() -> dict:
    t = tracer()
    return {} if t is None else t.counters()


def marked(host: Sequence[Tuple[str, float, float]], stop: float) -> List[Tuple[str, float, float]]:
    """`(span name, start, end)` of each marker pair among the trace's host
    operations: from a begin marker's start to its end marker's end, paired
    as a stack per name; a span whose end falls after the trace stopped ends
    at `stop`."""
    out, open_ = [], {}
    for start, end, name in sorted((a, b, n) for n, a, b in host if n.startswith(PREFIX)):
        span, _, edge = name[len(PREFIX):].rpartition(".")
        if edge == "begin":
            open_.setdefault(span, []).append(start)
        elif edge == "end" and open_.get(span):
            out.append((span, open_[span].pop(), end))
    out += [(span, a, stop) for span, starts in open_.items() for a in starts]
    return out


def merged(spans: Sequence[Interval]) -> List[Interval]:
    """The union of `[start, end)` intervals as disjoint sorted intervals."""
    out: List[Interval] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """Where both sets of intervals run."""
    xs, ys, out, i, j = merged(xs), merged(ys), [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """Where `xs` run and `ys` do not."""
    out, ys = [], merged(ys)
    for a, b in merged(xs):
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
        if b > a:
            out.append((a, b))
    return out


def innermost(spans: Sequence[Tuple[str, float, float]]) -> List[Tuple[str, float, float]]:
    """The time under `spans` as disjoint `(name, start, end)` pieces, each
    named by the innermost span over it: of those running, the one that
    started last (the shorter where two start together)."""
    edges = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, _, b) in enumerate(spans)])
    out, running = [], set()
    for (t, starts, i), nxt in zip(edges, edges[1:] + [None]):
        (running.add if starts else running.discard)(i)
        if running and nxt is not None and nxt[0] > t:
            j = max(running, key=lambda k: (spans[k][1], -spans[k][2]))
            out.append((spans[j][0], t, nxt[0]))
    return out


def idle_split(run) -> Optional[Dict[str, float]]:
    """The idle seconds of the traced window (no kernel or copy running: the
    window and kernels of `idle_share`) by what the host was in: `launch`
    inside a `cudaGraphLaunch`, whose length the profiler inflates, else
    the innermost program span, else `none`. None without a window,
    kernels or the program's markers."""
    if not run.trace_s or not run.kernels:
        return None
    t0 = min(a for _, a, _ in run.kernels)
    stop = t0 + run.trace_s
    spans = marked(run.host, stop)
    if not spans:
        return None
    gaps = idle_gaps([(a, b) for _, a, b in run.kernels], t0, stop)
    launches = [(a, b) for n, a, b in run.host if n == "cudaGraphLaunch"]
    idle = minus(gaps, launches)
    pieces: Dict[str, List[Interval]] = {}
    for name, a, b in innermost(spans):
        pieces.setdefault(name, []).append((a, b))
    out = {"launch": union_seconds(overlap(gaps, launches))}
    out.update((name, union_seconds(overlap(idle, p))) for name, p in pieces.items())
    out["none"] = union_seconds(minus(idle, [x for p in pieces.values() for x in p]))
    return out
