"""Acceptance-rate vector measurement: the planner's model-pair input.

Port of `sequoia_tpu/planner/acceptance.py`. Two independent methods, the
reference's pair (SURVEY.md §3.4):

- `static_acceptance`: the teacher-forced analytic expectation
  (`tests/fast_test.py:36-108`). Draft and target run once over
  ground-truth text (one causal forward per model per sequence: on the
  card, the tree attention kernel at Q = T rows over the main cache); per
  position, draft tokens are drawn without replacement and the acceptance
  mass `min(1, p/q)` is accumulated per rank, with residual updates on p
  and a renormalized q.
- `dynamic_acceptance`: the real engine on a depth-1 star growmap of width
  W, histogramming the accepted child's rank per step
  (`tests/test_accept.py:36-86` / `SpecTreeTest`). A measurement tool, not
  a timed entry point: it reads the host after every iteration.

Every random draw takes a `torch.Generator` seeded from `seed`; the streams
differ from JAX's keys, so a stochastic vector agrees with JAX's only
statistically (a greedy dynamic one exactly). The output format is the
reference artifact's: element 0 is 0.0, element k = P(rank-k child
accepted), length k+1.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.model import LlamaParams, forward
from ..kvcache.cache import KVCache
from ..ops import masks
from ..ops.sampling import residual, sample_categorical_probs, top_p_filter
from ..trees.growmap import uniform_tree
from ..utils import make_generator
from .dp import expected_accepted


def static_rates(gen: torch.Generator, target_logits: torch.Tensor,
                 draft_logits: torch.Tensor, k: int, temperature: float, top_p: float,
                 draft_top_p: float) -> torch.Tensor:
    """Acceptance mass per rank at each position, `[n, k]` f32, from the
    target's and the draft's logits `[n, V]` (JAX
    `_static_rates_for_logits`, the positions batched as rows): p is the
    nucleus-filtered target distribution, q the softmax of the filtered
    draft logits with each drawn token masked out in turn."""
    p = torch.softmax(top_p_filter(target_logits.float(), top_p, temperature) / temperature,
                      dim=-1)
    dl = top_p_filter(draft_logits.float(), draft_top_p, temperature)
    remaining = torch.ones(p.shape[0], device=p.device)
    rates = []
    for _ in range(k):
        q = torch.softmax(dl / temperature, dim=-1)
        tok = sample_categorical_probs(gen, q)[:, None]
        ratio = torch.clamp_max(p.gather(1, tok)[:, 0] / torch.clamp_min(
            q.gather(1, tok)[:, 0], 1e-30), 1.0)
        rates.append(remaining * ratio)
        p = torch.nan_to_num(residual(p, q), nan=0.0)
        dl = dl.scatter(1, tok, float("-inf"))
        remaining = remaining * (1.0 - ratio)
    return torch.stack(rates, dim=1)


def static_acceptance(
    draft_params: LlamaParams,
    draft_cfg: LlamaConfig,
    target_params: LlamaParams,
    target_cfg: LlamaConfig,
    sequences: Sequence[np.ndarray],
    *,
    k: int = 8,
    temperature: float = 0.6,
    top_p: float = 0.9,
    draft_top_p: float = 0.99,
    skip_prefix: int = 0,
    seed: int = 0,
    dtype=None,
) -> np.ndarray:
    """Teacher-forced acceptance vector over ground-truth `sequences`, on
    the params' device; the KV caches in `dtype` (None: each model's
    activation type, which the card's attention kernel reads)."""
    dev = target_params.embed.device
    gen = make_generator(seed, dev)
    total = torch.zeros(k, dtype=torch.float64, device=dev)
    count = 0
    for seq in sequences:
        seq = np.asarray(seq, np.int64).reshape(-1)
        T = len(seq)
        if T <= skip_prefix + 1:
            raise ValueError(f"a sequence of {T} tokens leaves no position past "
                             f"skip_prefix {skip_prefix}")
        tokens = torch.as_tensor(seq, device=dev)
        pos = torch.arange(T, device=dev)
        mask = masks.causal_mask(T, T, 0, dev)
        tl, _ = forward(target_params, target_cfg, tokens, pos, KVCache.init(
            target_cfg, T, dtype or target_params.embed.dtype, dev), 0, mask)
        dl, _ = forward(draft_params, draft_cfg, tokens, pos, KVCache.init(
            draft_cfg, T, dtype or draft_params.embed.dtype, dev), 0, mask)
        rates = static_rates(gen, tl[skip_prefix:], dl[skip_prefix:], k, temperature,
                             top_p, draft_top_p)
        total += rates.sum(dim=0, dtype=torch.float64)
        count += rates.shape[0]
    vec = total.cpu().numpy() / max(count, 1)
    return np.concatenate([[0.0], vec])


def dynamic_acceptance(
    draft_params: LlamaParams,
    draft_cfg: LlamaConfig,
    target_params: LlamaParams,
    target_cfg: LlamaConfig,
    prompts: Sequence[np.ndarray],
    *,
    width: int = 8,
    steps_per_prompt: int = 64,
    temperature: float = 0.6,
    top_p: float = 0.9,
    max_length: int = 256,
    seed: int = 0,
    algorithm: str = "sequoia",
) -> np.ndarray:
    """Accepted-child-rank histogram of real engine iterations on a depth-1
    star of `width` children, on the params' device. Returns `[0, p1, ...,
    pW]`, p_b = P(the rank-b child accepted) over the steps. Every
    verification algorithm can be measured, so a growmap is planned from a
    vector measured under the protocol that will run it: "sequoia" is
    SpecTreeTest's (`Tree/SpecTree.py:288`), "greedy" GreedyTreeTest's
    (`Tree/GreedyTree.py:267`), "greedys" top-W children against one
    sampled target token, "specinfer" with-replacement children and
    `p >= r q` rounds. Prompt i runs with seed `seed + i`."""
    from ..engine.engine import SpecEngine

    gm = uniform_tree(1, width)
    eng = SpecEngine(draft_params, draft_cfg, target_params, target_cfg, gm,
                     algorithm=algorithm, max_length=max_length, temperature=temperature,
                     top_p=top_p, device=target_params.embed.device)
    hist = np.zeros(width + 1, np.int64)
    total = 0
    for i, prompt in enumerate(prompts):
        state = eng.prefill(prompt, seed=seed + i)
        gtl = len(np.asarray(prompt).reshape(-1))
        for _ in range(steps_per_prompt):
            if not eng._fits(gtl):
                break
            stats = eng.iterate(state)
            rank, emitted, terminal = torch.stack(
                [stats.first_rank, stats.emitted, stats.terminal.long()]).tolist()
            gtl += emitted
            total += 1
            if rank >= 0:
                hist[rank + 1] += 1
            if terminal:
                break
    vec = hist.astype(np.float64) / max(total, 1)
    vec[0] = 0.0
    return vec


def calibrate_vector(
    vec: np.ndarray,
    probe_gm,
    measured_e: float,
    *,
    lo: float = 0.3,
    hi: float = 1.5,
    iters: int = 48,
) -> tuple[np.ndarray, float]:
    """Depth-calibrate an acceptance vector against a probe tree.

    Both methods above measure acceptance at depth 1 (fresh, AR-committed
    states). A deep tree planned from that vector compounds any per-edge
    optimism: on a distilled pair with rank-1 0.876, a depth-13 plan
    claimed E 9.79 and realized 5.98 (JAX package, TRAINED_E5_r04; the
    acceptance along accepted paths is path-conditioned, so the probe
    should match the plan's topology class, e.g. `uniform_tree(6, 2)`).

    Finds the scalar s such that `expected_accepted(probe_gm, s * vec)`
    equals `measured_e` (the probe tree's measured accepted/step) and
    returns (the calibrated vector, s). A measured E outside what the
    scales [lo, hi] can predict warns and returns the bracket's end."""
    vec = np.asarray(vec, np.float64)

    def pred(s: float) -> float:
        v = vec.copy()
        v[1:] = np.minimum(v[1:] * s, 1.0)
        return float(expected_accepted(probe_gm, v))

    p_lo, p_hi = pred(lo), pred(hi)
    if not (p_lo <= measured_e <= p_hi):
        warnings.warn(
            f"calibrate_vector: measured E {measured_e:.3f} outside the "
            f"bracket's predictable range [{p_lo:.3f}, {p_hi:.3f}] "
            f"(scales [{lo}, {hi}]); returning the clamped endpoint — "
            "the probe run looks anomalous, treat the calibrated plan "
            "with suspicion", stacklevel=2)

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if pred(mid) < measured_e:
            lo = mid
        else:
            hi = mid
    s = 0.5 * (lo + hi)
    out = vec.copy()
    out[1:] = np.minimum(out[1:] * s, 1.0)
    return out, s
