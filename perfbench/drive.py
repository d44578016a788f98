"""Set-up and the measured window of one cell, on the program's entry points.

`*.single` cells drive `SpecEngine.stream_fast`: one client in a closed
loop, whole cycles of requests until `--seconds` has passed. `*.batched*`
cells drive `BatchedSpecEngine.serve_device`: whole offline batches until
`--seconds` has passed. Each cell has two engines over the same weights and
tree: the configuration's sampling one, and a greedy one for the greedy
requests the traffic mixes in, whose tokens `correct` compares logit by
logit (`judge.py`).
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sequoia_torch.engine.batched import BatchedSpecEngine
from sequoia_torch.engine.engine import SpecEngine
from sequoia_torch.kernels import build
from sequoia_torch.quant.qtensor import set_w8a8
from sequoia_torch.trees.growmap import GrowMap

from . import traffic
from .spec import ROLES, Cell
from .trace import Tap, TraceSession


@dataclass
class Served:
    request: traffic.Request
    tokens: np.ndarray          # the served tokens, prompt excluded
    chunk_times: List[float] = field(default_factory=list)   # s since the request began


@dataclass
class Window:
    seconds: float = 0.0
    served: List[Served] = field(default_factory=list)
    sampled_tokens: int = 0
    sampled_steps: int = 0      # target steps (single) or batched iterations
    batches: int = 0


class Bench:
    """The program under test for one cell: its weights, engines and traffic."""

    def __init__(self, cell: Cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        cfg, mix = cell.config, cell.traffic
        self.dims = {r: m.dims for r, m in cell.models.items()}
        self._programs = {r: m.program() for r, m in cell.models.items()}
        self.stop = [int(t) for t in cfg["stop_tokens"]]
        self.vocab = self.dims["target"].vocab
        self.batched = mix["kind"] == "batched"
        # The configurations serve weight-only int8: the activations stay bf16.
        set_w8a8("off")
        if self.device.type == "cuda":
            build.load()
        self.params = {r: self._programs[r].make(self.dims[r], cfg["weights"][r], self.seed, r,
                                                 self.device) for r in ROLES}
        self.cfgs = {r: self._programs[r].config(cfg[r], self.stop) for r in ROLES}
        tree = GrowMap.from_json(str(cell.tree_path))
        s = cfg["sampling"]
        kv = None if cfg["kv_cache"] == "bf16" else cfg["kv_cache"]
        common = dict(max_length=int(mix["max_length"]), temperature=s["temperature"],
                      top_p=s["top_p"], prefill_chunk=int(mix["prefill_chunk"]),
                      kv_quant=kv, walk=s["walk"], device=self.device)
        cls = BatchedSpecEngine if self.batched else SpecEngine
        extra = {"batch_size": int(mix["slots"])} if self.batched else {}
        self.engines = {
            kind: cls(self.params["draft"], self.cfgs["draft"], self.params["target"],
                      self.cfgs["target"], tree, algorithm=algo, **common, **extra)
            for kind, algo in (("sampled", s["algorithm"]), ("greedy", "greedy"))}
        self.taps: Dict[str, Tap] = {}
        self.session: Optional[TraceSession] = None

    def reseed(self, seed: int) -> None:
        """Draw another seed's weights into the same tensors (the captured
        graphs keep reading them)."""
        self.seed = int(seed)
        for r in ROLES:
            self._programs[r].fill(self.params[r], self.dims[r], self.seed, r)

    # ---- set-up ----

    def warm_up(self) -> None:
        """Run every shape the window runs, on both engines: the prefill
        chunks, and the captured phases (and admission step) of the loop."""
        mix = self.cell.traffic
        if self.batched:
            B = int(mix["slots"])
            reqs = traffic.warmup_requests(mix, self.vocab, self.stop, B + 1, 4)
            for eng in self.engines.values():
                eng.serve_device([r.prompt for r in reqs], max_new_tokens=4, seed=0)
        else:
            reqs = traffic.warmup_requests(mix, self.vocab, self.stop, 2, 0)
            chunk = int(mix["chunk_tokens"])
            for eng in self.engines.values():
                for r in reqs:
                    for _ in eng.stream_fast(r.prompt, max_new_tokens=2 * chunk,
                                             chunk_tokens=chunk, seed=r.seed):
                        pass
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def arm_trace(self, seconds: Optional[float]) -> None:
        """Trace the next window: phase events on both engines, the profiler
        from the first sampled request for `seconds` (None: that request)."""
        TraceSession.warm()
        self.session = TraceSession(seconds)
        attr = "_bgraphs" if self.batched else "_graphs"
        for kind, eng in self.engines.items():
            self.taps[kind] = Tap(getattr(eng, attr), eng, self.session, self.batched)
            setattr(eng, attr, self.taps[kind])

    # ---- the window ----

    def run_window(self, seconds: float, seed: Optional[int] = None,
                   check_only: bool = False) -> Window:
        """The measured window. `check_only` serves the readings of
        `calibrate.py`: of the first cycle or batch, only the requests a run
        judges (every greedy one, the first sampled ones), at the cell's
        load."""
        seed = self.seed if seed is None else int(seed)
        if self.batched:
            return self._window_batched(seconds, seed, check_only)
        return self._window_single(seconds, seed, check_only)

    def _start_trace(self) -> None:
        if self.session is not None and self.session.prof is None:
            self.session.start()

    def _window_single(self, seconds, seed, check_only) -> Window:
        mix = self.cell.traffic
        chunk = int(mix["chunk_tokens"])
        win = Window()
        t0 = time.perf_counter()
        number = 0
        while True:
            reqs = traffic.cycle(mix, seed, number, self.vocab, self.stop)
            if check_only:
                n = int(mix["check"]["sampled"])
                reqs = [r for r in reqs if r.greedy] + [r for r in reqs if not r.greedy][:n]
            for r in reqs:
                kind = "greedy" if r.greedy else "sampled"
                eng = self.engines[kind]
                if kind == "sampled":
                    self._start_trace()
                if self.session is not None and self.session.tracing:
                    self.taps[kind].snaps.append(("prefill", len(r.prompt)))
                t_req = time.perf_counter()
                served = Served(r, np.zeros(0, np.int64))
                parts = []
                for part in eng.stream_fast(r.prompt, max_new_tokens=r.max_new,
                                            chunk_tokens=chunk, seed=r.seed):
                    served.chunk_times.append(time.perf_counter() - t_req)
                    parts.append(part)
                if parts:
                    served.tokens = np.concatenate(parts).astype(np.int64)
                win.served.append(served)
                if kind == "sampled":
                    win.sampled_tokens += eng.num_decoding_steps
                    win.sampled_steps += eng.num_large_model_steps
                    if self.session is not None:
                        self.session.maybe_stop(force=True)
            number += 1
            if check_only or time.perf_counter() - t0 >= seconds:
                break
        win.seconds = time.perf_counter() - t0
        if self.session is not None:
            self.session.maybe_stop(force=True)
        return win

    def _window_batched(self, seconds, seed, check_only) -> Window:
        mix = self.cell.traffic
        win = Window()
        t0 = time.perf_counter()
        while True:
            sampled, greedy = traffic.batch(mix, seed, win.batches, self.vocab, self.stop)
            if check_only:
                sampled = sampled[:int(mix["check"]["sampled"])]
            for kind, reqs in (("sampled", sampled), ("greedy", greedy)):
                if not reqs:
                    continue
                budgets = {r.max_new for r in reqs}
                if len(budgets) != 1:
                    raise ValueError("serve_device takes one budget a call: the mix's "
                                     "new_tokens must be fixed")
                eng = self.engines[kind]
                if kind == "sampled":
                    self._start_trace()
                out = eng.serve_device([r.prompt for r in reqs], max_new_tokens=budgets.pop(),
                                       seed=reqs[0].seed)
                for r, o in zip(reqs, out):
                    win.served.append(Served(r, np.asarray(o[len(r.prompt):], np.int64)))
                if kind == "sampled":
                    win.sampled_tokens += eng.num_decoding_steps
                    win.sampled_steps += eng.num_large_model_steps
            win.batches += 1
            if check_only or time.perf_counter() - t0 >= seconds:
                break
        win.seconds = time.perf_counter() - t0
        if self.session is not None:
            self.session.maybe_stop(force=True)
        return win

    def free(self) -> None:
        """Drop the program's state, so the reference has the card."""
        self.engines.clear()
        self.taps.clear()
        self.params.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def short(s: Served, stop) -> bool:
    """A request that came back with fewer tokens than its budget, and not
    because a stop token ended it."""
    return len(s.tokens) < s.request.max_new and not (
        len(s.tokens) and int(s.tokens[-1]) in stop)


def median_ms(values) -> Optional[float]:
    return statistics.median(values) * 1e3 if values else None
