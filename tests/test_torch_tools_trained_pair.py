"""tests/test_trained_pair.py on the port's own pair: a draft / target pair
trained on the CPU by `sequoia_torch/tools/distill.py::make_correlated_pair`
(the same call as the JAX test's) must accept far above the
independent-random-weights floor, and measure -> plan -> run completes.
Apart from tests/test_torch_tools_distill.py so that each file stays near a
minute on one test worker (the pair's 600 training steps take most of
this one)."""

import numpy as np
import pytest
import torch

from sequoia_torch.engine.engine import SpecEngine
from sequoia_torch.planner.acceptance import dynamic_acceptance
from sequoia_torch.planner.dp import plan
from sequoia_torch.tools import distill
from sequoia_torch.trees.growmap import uniform_tree


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its eager runs are small, and
    with several test workers sharing the cores a many-threaded run of
    them is 10-100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return distill.make_correlated_pair(steps=300, seq_len=64, distill_draft=True, device="cpu")


def test_trained_pair_accepts(pair):
    draft, dcfg, target, tcfg = pair
    prompts = [np.arange(5, 15, dtype=np.int32)]
    vec = dynamic_acceptance(draft, dcfg, target, tcfg, prompts, width=6,
                             steps_per_prompt=24, max_length=128, temperature=0.5)
    assert vec[1] > 0.15, f"distilled draft should be accepted often: {vec}"
    eng = SpecEngine(draft, dcfg, target, tcfg, uniform_tree(4, 2), algorithm="sequoia",
                     max_length=160, temperature=0.5, top_p=0.9, prefill_chunk=16,
                     device="cpu")
    eng.generate(prompts[0], max_new_tokens=60, seed=0)
    rate = eng.num_decoding_steps / max(eng.num_large_model_steps, 1)
    assert rate > 1.15, f"accepted/step {rate} barely above autoregressive"


def test_measure_plan_run_loop(pair):
    """The full measure -> plan -> run loop on the trained pair."""
    draft, dcfg, target, tcfg = pair
    prompts = [np.arange(40, 50, dtype=np.int32)]
    vec = dynamic_acceptance(draft, dcfg, target, tcfg, prompts, width=4,
                             steps_per_prompt=16, max_length=128, temperature=0.5)
    vec = np.maximum(vec, 1e-4)
    vec[0] = 0.0
    gm, _ = plan(vec, [1, 2, 4, 8, 16], [1.0, 1.0, 1.01, 1.03, 1.06], 0.05, max_depth=6)
    assert 1 <= gm.size <= 16
    eng = SpecEngine(draft, dcfg, target, tcfg, gm, algorithm="sequoia", max_length=160,
                     temperature=0.5, top_p=0.9, prefill_chunk=16, device="cpu")
    out = eng.generate(prompts[0], max_new_tokens=24, seed=1)
    assert len(out) > len(prompts[0])
