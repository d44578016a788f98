"""The control comes out not correct, at a size a test run holds.

The control is the plain reference in the configuration's
`control_weights`, a precision below the one it serves, read at each
position of the same prompts and served greedy tokens: the gap of the token
it puts first. On the chip the same readings, at each cell's own size, come
from `perfbench/calibrate.py` (int8 for the bf16 SmolLM2, int4 for the int8
Yi-34B), where every seed's control failed. At this size (the tiny bf16
model's control is fp8: int8 flips nothing at these widths) a control can
stay within the limits (fp8 on seed 7 of seeds 3-14); each case below runs
three seeds on which it does not."""

import pytest
import torch

from perfbench.drive import Bench
from perfbench.judge import readings, samples
from perfbench.spec import load_cell


def _read(cell, bench, seed, device):
    win = bench.run_window(0.0, seed=seed, check_only=True)
    control = cell.config["control_weights"]
    r = readings(cell, seed, *samples(cell, win.served, seed), device, [control])
    return r, r[f"control_gap_max.{control}"], r[f"control_gap_mean.{control}"]


@pytest.mark.parametrize("name,seeds", [("tiny.single", (3, 4, 5)),
                                        ("tiny8.batched2", (3, 4, 5))])
def test_control_fails_and_the_program_passes(tiny, name, seeds):
    base, bench_json = tiny
    cell = load_cell(name, bench_json, base)
    lim = {k: v["limit"] for k, v in cell.limits.items()}
    bench = Bench(cell, 3, "cpu")
    for seed in seeds:
        bench.reseed(seed)
        r, c_max, c_mean = _read(cell, bench, seed, "cpu")
        assert r["greedy_tokens"] > 0
        assert r["gap_max"] < lim["gap_max"] and r["gap_mean"] < lim["gap_mean"], r
        assert c_max > lim["gap_max"] or c_mean > lim["gap_mean"], r


@pytest.mark.cuda
def test_control_fails_on_the_card(tiny, cuda_device):
    base, bench_json = tiny
    cell = load_cell("tiny8.single", bench_json, base)
    bench = Bench(cell, 3, cuda_device)
    bench.warm_up()
    r, c_max, _ = _read(cell, bench, 3, cuda_device)
    assert r["gap_max"] < cell.limits["gap_max"]["limit"] < c_max, r
    torch.cuda.synchronize()
