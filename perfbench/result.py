"""One run of a cell, from set-up to the result's line."""

from __future__ import annotations

import sys
import time
from typing import Optional

import torch

from . import judge, work
from .drive import Bench, short
from .spec import Cell, metric_reader
from .trace import idle_gaps, label_gaps, top_ops, union_seconds


class RunData:
    """What a per-layer reader reads (`metrics/<name>.py::read(run)`)."""

    def __init__(self, cell: Cell, bench: Bench, win):
        self.cell = cell
        self.dims = bench.dims
        self.formats = dict(cell.config["weights"])
        self.window = win
        self.tree = work.Tree.load(cell.tree_path)
        chunk = int(cell.traffic["prefill_chunk"])
        snaps = []
        for tap in bench.taps.values():
            snaps += [(k, v.tolist() if isinstance(v, torch.Tensor) else v)
                      for k, v in tap.snaps]
        self.calls = work.from_snaps(snaps, self.tree, chunk)
        sess = bench.session
        self.trace_s = sess.window_s if sess is not None else None
        self.kernels, self.host = sess.device_ops() if sess is not None and sess.prof else ([], [])
        tap = bench.taps.get("sampled")
        self.phase_ms = tap.phase_ms() if tap is not None else {}
        self.ttfc = [s.chunk_times[0] for s in win.served
                     if not s.request.greedy and s.chunk_times]


def _per_layer(cell: Cell, data: RunData) -> dict:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _end_to_end(cell: Cell, win, setup_s: float) -> dict:
    tokens = sum(len(s.tokens) for s in win.served)
    values = {"setup_s": setup_s}
    if tokens:
        values["ms_per_token"] = win.seconds * 1e3 / tokens
        values["tokens_per_s"] = tokens / win.seconds
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def measure(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
            power_w: Optional[float], device="cuda") -> dict:
    bench = Bench(cell, seed, device)
    bench.warm_up()
    if trace:
        bench.arm_trace(float(cell.traffic.get("trace_seconds", 3.0)) if bench.batched
                        else None)
    setup_s = time.perf_counter() - t_start
    win = bench.run_window(seconds)
    t_win = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), "power_limit_w": power_w}
    line = {"correct": False, "attempted": len(win.served),
            "failed": sum(short(s, bench.stop) for s in win.served)}
    if trace:
        data = RunData(cell, bench, win)
        line["metrics"] = _per_layer(cell, data)
        spans = [(a, b) for _, a, b in data.kernels]
        if spans and data.trace_s:
            dev["busy_s"] = union_seconds(spans)
            dev["window_s"] = data.trace_s
            t0 = min(a for a, _ in spans)
            gaps = idle_gaps(spans, t0, t0 + data.trace_s)
            line["breakdown"] = {"device_ops": top_ops(data.kernels),
                                 "idle_gaps": label_gaps(gaps, data.host)}
    else:
        line["metrics"] = _end_to_end(cell, win, setup_s)
    line["device"] = dev
    stop = bench.stop
    bench.free()
    t_judge = time.perf_counter()
    checks = judge.judge(cell, seed, win, stop, device)
    print(f"perfbench: set-up {setup_s:.1f} s, window {win.seconds:.1f} s, "
          f"{len(win.served)} requests; metrics {t_judge - t_win:.1f} s; "
          f"judge {time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    line["correct"] = all(c["value"] is not None and c["value"] <= c["limit"]
                          for c in checks.values())
    line["checks"] = checks
    return line
