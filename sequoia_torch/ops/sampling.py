"""Sampling and residual math for lossless speculative decoding.

Port of `sequoia_tpu/ops/sampling.py`. Every random draw takes an explicit
`torch.Generator` (never the global RNG); all distribution math runs in f32.
The nucleus calls dispatch on the tensor's device: on CUDA they launch the
top-p kernels (`kernels/top_p.py`), on the CPU they run the plain bisection.

Reference semantics preserved:
- `residual` = normalize(relu(p - q))                    (`utils.py:5-8`)
- without-replacement draft sampling via an exponential race
  `(log U / q).topk(k)`                                  (`utils.py:10-18`);
  here the equivalent Gumbel-top-k on logits.
- top-p nucleus filtering at temperature T               (`utils.py:65-77`).
"""

from __future__ import annotations

import torch

from ..kernels.top_p import (
    top_p_threshold_from_logits,
    top_p_threshold_fused,
    top_p_threshold_plain,
)

_TINY = torch.finfo(torch.float32).tiny


def residual(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """normalize(relu(p - q)); NaN rows when p <= q everywhere (the
    reference treats that as terminal, `Tree/SpecTree.py:219-220`)."""
    r = torch.clamp_min(p - q, 0.0)
    return r / r.sum(dim=-1, keepdim=True)


def top_p_filter(logits: torch.Tensor, top_p: float, temperature: float) -> torch.Tensor:
    """Mask (to -inf) the tokens outside the nucleus, by a sort
    (`get_sampling_logits`, `utils.py:65-77`): keep a token while the
    probability mass sorted before it is <= top_p (the first token always
    stays). JAX computes it in XLA, with no kernel; static acceptance
    measurement uses it, no engine path does."""
    if top_p >= 1.0:
        return logits
    sort_idx = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(logits.gather(-1, sort_idx) / temperature, dim=-1)
    remove_sorted = (probs.cumsum(dim=-1) - probs) > top_p
    remove = torch.empty_like(remove_sorted).scatter_(-1, sort_idx, remove_sorted)
    return logits.masked_fill(remove, float("-inf"))


def top_p_threshold(probs: torch.Tensor, top_p: float, iters: int = 32) -> torch.Tensor:
    """Per-row nucleus cutoff by bisection, the plain version on any device
    (see `kernels/top_p.py::top_p_threshold_plain`)."""
    return top_p_threshold_plain(probs, top_p, iters)


def nucleus_cutoff(logits: torch.Tensor, top_p: float,
                   temperature: float) -> torch.Tensor:
    """Per-row inclusive nucleus cutoff c for softmax(logits/T), the only
    precomputed quantity the path walk needs (keep = softmax >= c; zeros
    when top_p >= 1). Kernel on CUDA, plain bisection on the CPU."""
    if top_p >= 1.0:
        return torch.zeros(logits.shape[:-1], dtype=torch.float32,
                           device=logits.device)
    return top_p_threshold_from_logits(logits.float().contiguous(), top_p,
                                       temperature)


def target_probs(logits: torch.Tensor, top_p: float,
                 temperature: float) -> torch.Tensor:
    """Verification distribution p: nucleus-filtered softmax at temperature
    (`Tree/SpecTree.py:196-198`). Sort-free."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    if top_p >= 1.0:
        return probs
    rows = probs.reshape(-1, probs.shape[-1]).contiguous()
    c = top_p_threshold_fused(rows, top_p).reshape(probs.shape[:-1])
    kept = torch.where(probs >= c[..., None], probs, torch.zeros((), device=probs.device))
    return kept / kept.sum(dim=-1, keepdim=True)


def draft_probs(draft_logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """q = softmax(draft_logits / T) (`Tree/SpecTree.py:149`)."""
    return torch.softmax(draft_logits.float() / temperature, dim=-1)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k indices in descending order (int64). The JAX side's
    two-stage block top-k works around slow TPU sorts; `torch.topk` is a
    selection, not a full sort, on the GPU."""
    if k == 1:
        return x.argmax(dim=-1, keepdim=True)
    return torch.topk(x, k, dim=-1).indices


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise `-log(-log U)`, U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return gumbel_from_uniform(u)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """`gumbel`'s transform of uniform draws `u` (f32), for callers that
    draw the uniforms themselves (one generator per slot)."""
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def wor_from_gumbel(logits: torch.Tensor, gumbel_noise: torch.Tensor,
                    temperature: float, num_samples: int) -> torch.Tensor:
    """Without-replacement race with caller-supplied gumbel noise: top-k of
    `logits/T + gumbel`. The softmax normalizer is constant per row, so the
    race on raw logits has the same distribution."""
    if gumbel_noise.shape != logits.shape:
        raise ValueError(f"gumbel {tuple(gumbel_noise.shape)} vs logits "
                         f"{tuple(logits.shape)}")
    return top_k_indices(logits.float() / temperature + gumbel_noise, num_samples)


def sample_without_replacement(generator: torch.Generator, logits: torch.Tensor,
                               temperature: float, num_samples: int) -> torch.Tensor:
    """`num_samples` distinct tokens per row from softmax(logits/T), in draw
    order (Gumbel-top-k, distributionally the reference's exponential race)."""
    g = gumbel(logits.shape, generator, logits.device)
    return wor_from_gumbel(logits, g, temperature, num_samples)


def sample_with_replacement(generator: torch.Generator, logits: torch.Tensor,
                            temperature: float, num_samples: int) -> torch.Tensor:
    """i.i.d. categorical draws (SpecInfer growth,
    `Tree/SpecInferTree.py:108`): `[..., num_samples]`, by Gumbel-max."""
    shape = (*logits.shape[:-1], num_samples, logits.shape[-1])
    return with_replacement_from_gumbel(logits, gumbel(shape, generator, logits.device),
                                        temperature)


def with_replacement_from_gumbel(logits: torch.Tensor, gumbel_noise: torch.Tensor,
                                 temperature: float) -> torch.Tensor:
    """`sample_with_replacement` with caller-supplied gumbel noise
    `[..., num_samples, vocab]`."""
    log_q = torch.log_softmax(logits.float() / temperature, dim=-1)
    return (log_q[..., None, :] + gumbel_noise).argmax(dim=-1)


def sample_argmax(logits: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Top-k tokens by logit (greedy growth, `utils.py:29-32`)."""
    return top_k_indices(logits, num_samples)


def sample_categorical_probs(generator: torch.Generator,
                             probs: torch.Tensor) -> torch.Tensor:
    """One draw per row from a probability vector (bonus-token sampling,
    `Tree/SpecTree.py:222`), by Gumbel-max on log(max(p, 1e-30)) as JAX's
    `categorical` does: a NaN or all-zero row gives an arbitrary token and
    never a device assert (callers check NaN separately), and nothing
    syncs with the host."""
    return categorical_from_gumbel(probs, gumbel(probs.shape, generator, probs.device))


def categorical_from_gumbel(probs: torch.Tensor, gumbel_noise: torch.Tensor) -> torch.Tensor:
    """`sample_categorical_probs` with caller-supplied gumbel noise of
    `probs`' shape."""
    safe = torch.where(torch.isnan(probs), torch.zeros((), device=probs.device), probs)
    logp = torch.log(torch.clamp_min(safe, 1e-30))
    return (logp + gumbel_noise).argmax(dim=-1)
