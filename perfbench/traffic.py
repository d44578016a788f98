"""The general traffic generator: requests from a mix's parameters and a seed.

A mix (`traffic/<name>.json`) is one of two kinds, each made of units of
requests with the same sizes in every unit and for every seed:

- `single`: one client in a closed loop, sending its next request when the
  last has finished. A unit is a cycle of `sampled_per_cycle` sampled and
  `greedy_per_cycle` greedy requests, sent in an order the seed draws.
- `batched`: offline batches, each `sampled_per_batch` sampled requests and
  then `greedy_per_batch` greedy ones.

Each group of a unit (its sampled requests, its greedy ones) takes the
quantiles of `prompt_tokens` as its prompt lengths and those of `new_tokens`
as its budgets, paired and ordered by the seed. So the greedy requests span
the same range of sizes as the sampled ones. A greedy request's budget is
`greedy_new_tokens` where the mix gives it. Greedy requests are the ones
whose served tokens are compared logit by logit (`judge.py`).

Prompt tokens are uniform over the vocabulary less the stop tokens. A
distribution is `{"dist": "fixed", "value": v}`, `{"dist": "uniform", "min",
"max"}` or `{"dist": "loguniform", "min", "max"}`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    index: int            # its number in the run's traffic
    prompt: np.ndarray    # int64 [n]
    max_new: int
    greedy: bool
    seed: int             # the engine's sampling seed for this request


def quantiles(dist: dict, n: int) -> List[int]:
    """The n midpoint quantiles of a length distribution, as whole numbers."""
    kind = dist["dist"]
    if kind not in ("fixed", "uniform", "loguniform"):
        raise ValueError(f"unknown distribution {kind!r}")
    if kind == "fixed":
        return [int(dist["value"])] * n
    lo, hi = float(dist["min"]), float(dist["max"])
    qs = [(k + 0.5) / n for k in range(n)]
    if kind == "uniform":
        return [int(round(lo + q * (hi - lo))) for q in qs]
    return [int(round(lo * math.exp(q * math.log(hi / lo)))) for q in qs]


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), *tags])))


def prompt_tokens(rng: np.random.Generator, n: int, vocab: int,
                  stop: Sequence[int]) -> np.ndarray:
    """n token ids uniform over the vocabulary without the stop tokens."""
    stop = sorted(set(int(s) for s in stop))
    ids = rng.integers(0, vocab - len(stop), size=n, dtype=np.int64)
    for s in stop:   # shift past each stop id, in increasing order
        ids[ids >= s] += 1
    return ids


def _request_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index) % (1 << 62)


def _unit(mix: dict, seed: int, rng: np.random.Generator, base: int, counts,
          vocab: int, stop: Sequence[int]) -> Tuple[List[Request], List[Request]]:
    """One unit's (sampled, greedy) requests, indices from `base` on."""
    out = []
    for greedy, count in zip((False, True), counts):
        lengths = quantiles(mix["prompt_tokens"], count)
        budgets = quantiles(mix["new_tokens"], count)
        if greedy and "greedy_new_tokens" in mix:
            budgets = [int(mix["greedy_new_tokens"])] * count
        lo, bo = rng.permutation(count), rng.permutation(count)
        reqs = []
        for i in range(count):
            reqs.append(Request(base, prompt_tokens(rng, lengths[lo[i]], vocab, stop),
                                budgets[bo[i]], greedy, _request_seed(seed, base)))
            base += 1
        out.append(reqs)
    return out[0], out[1]


def cycle(mix: dict, seed: int, number: int, vocab: int, stop: Sequence[int]) -> List[Request]:
    """Cycle `number` of the closed loop, in the order its requests are sent."""
    rng = _rng(seed, 1, number)
    counts = (int(mix["sampled_per_cycle"]), int(mix["greedy_per_cycle"]))
    sampled, greedy = _unit(mix, seed, rng, number * sum(counts), counts, vocab, stop)
    reqs = sampled + greedy
    return [reqs[k] for k in rng.permutation(len(reqs))]


def batch(mix: dict, seed: int, number: int, vocab: int, stop: Sequence[int]):
    """Offline batch `number`: (its sampled requests, its greedy requests)."""
    counts = (int(mix["sampled_per_batch"]), int(mix["greedy_per_batch"]))
    return _unit(mix, seed, _rng(seed, 2, number), number * sum(counts), counts, vocab, stop)


def warmup_requests(mix: dict, vocab: int, stop: Sequence[int], count: int,
                    max_new: int) -> List[Request]:
    """Short requests for the set-up, from a fixed stream: the prompt lengths
    span the mix's range, so they run every prefill shape the window will."""
    rng = _rng(0, 3)
    lengths = quantiles(mix["prompt_tokens"], count)
    return [Request(-1 - i, prompt_tokens(rng, n, vocab, stop), max_new, False, i)
            for i, n in enumerate(lengths)]
