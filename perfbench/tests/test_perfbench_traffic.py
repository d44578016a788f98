"""The general traffic generator, from a seed."""

import numpy as np
import pytest

from perfbench import traffic

SINGLE = {"kind": "single", "sampled_per_cycle": 6, "greedy_per_cycle": 2,
          "prompt_tokens": {"dist": "loguniform", "min": 128, "max": 1024},
          "new_tokens": {"dist": "loguniform", "min": 16, "max": 256}}
BATCHED = {"kind": "batched", "slots": 8, "sampled_per_batch": 6, "greedy_per_batch": 2,
           "prompt_tokens": {"dist": "loguniform", "min": 64, "max": 512},
           "new_tokens": {"dist": "fixed", "value": 192}}
BIG = 2**31 + 40503


def _cycle(seed, number=0, mix=SINGLE, vocab=1000, stop=(2,)):
    return traffic.cycle(mix, seed, number, vocab, stop)


def test_quantiles():
    assert traffic.quantiles({"dist": "fixed", "value": 5}, 3) == [5, 5, 5]
    assert traffic.quantiles({"dist": "uniform", "min": 0, "max": 8}, 4) == [1, 3, 5, 7]
    assert traffic.quantiles({"dist": "loguniform", "min": 128, "max": 1024}, 4) == \
        [166, 279, 470, 790]
    with pytest.raises(ValueError):
        traffic.quantiles({"dist": "zipf"}, 2)


def test_same_seed_same_requests_other_seed_other_order():
    a, b, c = _cycle(BIG), _cycle(BIG), _cycle(BIG + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.greedy == y.greedy and x.seed == y.seed
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("greedy,count", [(False, 6), (True, 2)])
def test_every_cycle_has_the_same_sizes(greedy, count):
    orders = set()
    for seed in (0, 7, BIG):
        for number in range(3):
            cyc = [r for r in _cycle(seed, number) if r.greedy == greedy]
            assert sorted(len(r.prompt) for r in cyc) == \
                traffic.quantiles(SINGLE["prompt_tokens"], count)
            assert sorted(r.max_new for r in cyc) == \
                traffic.quantiles(SINGLE["new_tokens"], count)
            orders.add(tuple(len(r.prompt) for r in _cycle(seed, number)))
    assert len(orders) > 1


def test_the_greedy_requests_span_the_range_in_any_order():
    lengths = traffic.quantiles(SINGLE["prompt_tokens"], 2)
    places = set()
    for seed in range(8):
        cyc = _cycle(seed)
        assert sorted(len(r.prompt) for r in cyc if r.greedy) == lengths
        places.add(tuple(k for k, r in enumerate(cyc) if r.greedy))
    assert len(places) > 1


def test_request_indices_and_seeds_are_distinct():
    reqs = _cycle(BIG, 0) + _cycle(BIG, 1)
    assert sorted(r.index for r in reqs) == list(range(16))
    assert len({r.seed for r in reqs}) == 16


def test_greedy_budget_of_its_own():
    mix = dict(SINGLE, greedy_new_tokens=64)
    cyc = _cycle(BIG, mix=mix)
    assert all((r.max_new == 64) == r.greedy for r in cyc)
    s, g = traffic.batch(dict(BATCHED, greedy_new_tokens=32), BIG, 0, 1000, (2,))
    assert {r.max_new for r in s} == {192} and {r.max_new for r in g} == {32}


def test_prompts_avoid_the_stop_tokens():
    ids = np.concatenate([x.prompt for x in _cycle(BIG, vocab=5, stop=(0, 2))])
    assert set(ids.tolist()) == {1, 3, 4}


def test_batches():
    s, g = traffic.batch(BATCHED, BIG, 0, 1000, (2,))
    s2, g2 = traffic.batch(BATCHED, BIG, 0, 1000, (2,))
    assert len(s) == 6 and len(g) == 2
    assert not any(r.greedy for r in s) and all(r.greedy for r in g)
    assert sorted(len(r.prompt) for r in s) == traffic.quantiles(BATCHED["prompt_tokens"], 6)
    assert sorted(len(r.prompt) for r in g) == traffic.quantiles(BATCHED["prompt_tokens"], 2)
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(s + g, s2 + g2))
    n1, _ = traffic.batch(BATCHED, BIG, 1, 1000, (2,))
    assert [r.index for r in s + g] == list(range(8)) and n1[0].index == 8


def test_warmup_requests_span_the_range():
    w = traffic.warmup_requests(SINGLE, 1000, (2,), 2, 8)
    assert [len(r.prompt) for r in w] == traffic.quantiles(SINGLE["prompt_tokens"], 2)
