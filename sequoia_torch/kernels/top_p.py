"""Nucleus cutoff (top-p threshold): CUDA kernels and their plain versions.

Port of `sequoia_tpu/kernels/top_p.py`. Per row, the inclusive threshold t
with keep = p >= t, where c* = inf{c : sum(p[p > c]) <= top_p} is found by
32 bisection passes and the boundary token is resolved exactly (see
`top_p_threshold_plain`). `top_p_threshold_from_logits` computes
p = softmax(logits / T) itself; `top_p_threshold_fused` takes p.

On a CUDA tensor each function launches its kernel from `csrc/top_p.cu`
(or raises); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from . import build

ITERS = 32


def top_p_threshold_plain(probs: torch.Tensor, top_p: float,
                          iters: int = ITERS) -> torch.Tensor:
    """Bisection nucleus cutoff on probabilities `[..., V]` (the math of
    `sequoia_tpu/ops/sampling.py::top_p_threshold`): no sort; after the
    bisection, the candidate boundary token is the smallest probability
    above `lo`, kept iff the mass strictly above it fits in `top_p`. The
    threshold sits at the midpoint of the gap below (kept) or above
    (dropped) that value, so a consumer that recomputes the row's softmax
    with 1-ulp drift gets the same membership. Masses are summed in f64
    (JAX sums in f32), so the cut does not depend on the summation order:
    at V = 32000 and top_p = 0.99, f32 sums in two orders differ by about
    one tail probability."""
    lo = torch.zeros(probs.shape[:-1], dtype=probs.dtype, device=probs.device)
    hi = probs.amax(dim=-1)
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs > mid[..., None], probs, zero).sum(
            dim=-1, dtype=torch.float64)
        gt = mass > top_p
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    inf = torch.full((), float("inf"), dtype=probs.dtype, device=probs.device)
    cand = torch.where(probs > lo[..., None], probs, inf).amin(dim=-1)
    above_cand = probs > cand[..., None]
    mass_gt = torch.where(above_cand, probs, zero).sum(dim=-1, dtype=torch.float64)
    include_cand = mass_gt <= top_p
    below = torch.where(probs < cand[..., None], probs, -inf).amax(dim=-1)
    below = torch.where(torch.isfinite(below), below, zero)
    above = torch.where(above_cand, probs, inf).amin(dim=-1)
    above = torch.where(torch.isfinite(above), above, cand * 2.0)
    t_inc = 0.5 * (cand + below)
    t_inc = torch.where(t_inc > below, t_inc, cand)   # ulp-adjacent guard
    t_exc = 0.5 * (cand + above)
    t_exc = torch.where(t_exc > cand, t_exc, above)
    return torch.where(include_cand, t_inc, t_exc)


def top_p_threshold_from_logits_plain(logits: torch.Tensor, top_p: float,
                                      temperature: float) -> torch.Tensor:
    # Divide (not multiply by 1/T), as the kernel and the walk do.
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return top_p_threshold_plain(probs, top_p)


def boundary_disagreements(probs: torch.Tensor, t_a: torch.Tensor,
                           t_b: torch.Tensor, top_p: float,
                           tol: float = 1e-6) -> int:
    """Rows where thresholds `t_a` and `t_b` keep different nuclei of
    `probs` `[R, V]`. Two f32 softmaxes of one row differ by an ulp, which
    moves a mass near `top_p` by about 1e-7; so a row may differ only in
    its boundary token, and only when the mass strictly above that token
    is within `tol` of `top_p`. Raises ValueError on any other difference;
    returns the number of such ill-conditioned rows."""
    keep_a, keep_b = probs >= t_a[:, None], probs >= t_b[:, None]
    rows = (keep_a != keep_b).any(dim=1).nonzero().flatten().tolist()
    for r in rows:
        diff = (keep_a[r] != keep_b[r]).nonzero().flatten()
        if diff.numel() != 1:
            raise ValueError(f"row {r}: nuclei differ in {diff.numel()} tokens")
        p_row = probs[r].double()
        above = p_row[p_row > p_row[diff[0]]].sum().item()
        if abs(above - top_p) > tol:
            raise ValueError(f"row {r}: nuclei differ at token {diff.item()} with "
                             f"mass {above} above it, not within {tol} of {top_p}")
    return len(rows)


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected [rows, vocab], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    lib = build.load()
    if x.shape[1] > lib.sequoia_top_p_max_vocab():
        raise NotImplementedError(
            f"{name}: vocab {x.shape[1]} exceeds the register-resident row "
            f"({lib.sequoia_top_p_max_vocab()})")


def top_p_threshold_from_logits(logits: torch.Tensor, top_p: float,
                                temperature: float) -> torch.Tensor:
    """Per-row threshold on softmax(logits / T); logits f32 `[R, V]` ->
    `[R]` f32. The probability matrix never reaches device memory."""
    if logits.device.type == "cpu":
        return top_p_threshold_from_logits_plain(logits, top_p, temperature)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    _check_rows(logits, "top_p_threshold_from_logits")
    R, V = logits.shape
    out = torch.empty(R, dtype=torch.float32, device=logits.device)
    lib = build.load()
    rc = lib.sequoia_top_p_from_logits(
        logits.data_ptr(), out.data_ptr(), R, V, float(top_p),
        float(temperature), torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "top_p_threshold_from_logits")
    build.launches["top_p_threshold_from_logits"] += 1
    return out


def top_p_threshold_fused(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Per-row threshold on probabilities f32 `[R, V]` -> `[R]` f32."""
    if probs.device.type == "cpu":
        return top_p_threshold_plain(probs, top_p)
    if probs.device.type != "cuda":
        raise ValueError(f"unsupported device {probs.device}")
    _check_rows(probs, "top_p_threshold_fused")
    R, V = probs.shape
    out = torch.empty(R, dtype=torch.float32, device=probs.device)
    lib = build.load()
    rc = lib.sequoia_top_p_fused(
        probs.data_ptr(), out.data_ptr(), R, V, float(top_p),
        torch.cuda.current_stream(probs.device).cuda_stream)
    build.check(rc, "top_p_threshold_fused")
    build.launches["top_p_threshold_fused"] += 1
    return out
