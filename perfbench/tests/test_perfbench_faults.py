"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, window, judge) of a tiny cell on
the CPU, skipping only the look for a card, once sound and once with each
fault of `perfbench/faults.py` a serving cell can have: a token altered
where it is produced, a step that returns its state unchanged, half of the
slots left out, and in the sampler an accept walk that takes every draft
token and top-p switched off. (The exchange between chips is not a fault of
a one-chip cell. A walk that takes only the draft tokens inside the nucleus
shows only at the cells' own widths, on the card: `PERF.md`.)"""

import time

import pytest
import torch

from perfbench import faults
from perfbench.result import measure
from perfbench.spec import load_cell

SEED = 2**31 + 977


def _run(tiny, name):
    base, bench = tiny
    return measure(load_cell(name, bench, base), SEED, 0.5, False, time.perf_counter(), None,
                   device="cpu")


def _broken(tiny, monkeypatch, fault, name):
    faults.plant(fault, monkeypatch.setattr)
    line = _run(tiny, name)
    assert not line["correct"], line["checks"]
    return line["checks"]


@pytest.mark.parametrize("name", ["tiny.single", "tiny8.single", "tiny.batched2",
                                  "tiny8.batched2"])
def test_sound_run_is_correct(tiny, name):
    line = _run(tiny, name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"gap_max", "gap_mean", "nucleus_excess", "logp_z",
                                   "short_requests"}


@pytest.mark.parametrize("name", ["tiny.single", "tiny8.batched2"])
def test_token_altered_where_produced(tiny, monkeypatch, name):
    checks = _broken(tiny, monkeypatch, "token_altered", name)
    assert checks["gap_max"]["value"] > checks["gap_max"]["limit"]


@pytest.mark.parametrize("name", ["tiny8.single", "tiny.batched2"])
def test_step_returns_its_state_unchanged(tiny, monkeypatch, name):
    _broken(tiny, monkeypatch, "state_unchanged", name)


def test_half_of_the_slots_left_out(tiny, monkeypatch):
    checks = _broken(tiny, monkeypatch, "half_slots", "tiny.batched2")
    assert checks["short_requests"]["value"] > 0


@pytest.mark.parametrize("fault", ["walk_accepts_all", "top_p_off"])
@pytest.mark.parametrize("name", ["tiny.single", "tiny8.batched2"])
def test_sampler_broken(tiny, monkeypatch, fault, name):
    checks = _broken(tiny, monkeypatch, fault, name)
    assert checks["nucleus_excess"]["value"] > checks["nucleus_excess"]["limit"]
    assert checks["gap_max"]["value"] <= checks["gap_max"]["limit"]   # greedy untouched


def test_unknown_fault():
    with pytest.raises(ValueError):
        faults.plant("no_such_fault")


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    from perfbench.run import main

    assert main(["--workload", "yi34b.single", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
