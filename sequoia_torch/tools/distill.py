"""Train correlated draft/target pairs offline.

Port of `sequoia_tpu/tools/distill.py`, the port's training path. Random
weights accept almost nothing (rate ~1/vocab); the reference downloads a
pretrained pair (68m + llama-2-7b). With no network, a small target is
*trained* on the bundled pre-tokenized corpus and a smaller draft trained on
the same data or distilled from the target: a correlated pair, so the
measure -> plan -> serve loop runs on real statistics.

The logits of a batch are one `core/model.py::forward_batched` over its rows
as slots (JAX vmaps `forward`), so attention is one launch of the batched
tree-attention kernel a layer on the card, differentiated through
`kernels/tree_attention.py::TreeAttentionFunction`. The optimizer is
`torch.optim.AdamW`, whose defaults are optax.adamw's; the batches come from
`np.random.default_rng(seed)` as in JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.init import random_params
from ..core.model import LayerParams, LlamaParams, forward_batched
from ..kvcache.cache import KVCache
from ..ops import masks
from ..utils import resolve_device


def _batch_logits(params, cfg, tokens):  # tokens: [B, T]
    """Logits `[B, T, V]` f32: each row a slot of one write-mode
    `forward_batched` over a fresh batched f32 cache of T rows, offset 0,
    causal mask."""
    B, T = tokens.shape
    dev = tokens.device
    pos = torch.arange(T, device=dev).expand(B, T)
    mask = masks.causal_mask(T, T, 0, device=dev).expand(B, T, T)
    kv = KVCache.init(cfg, T, torch.float32, device=dev, batch=B)
    logits, _ = forward_batched(params, cfg, tokens, pos, kv,
                                torch.zeros(B, dtype=torch.long, device=dev), mask)
    return logits


def _masked_mean(x, loss_mask):
    if loss_mask is None:
        return x.mean()
    return (x * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)


def lm_loss(params, cfg, tokens, loss_mask=None):
    """Next-token cross-entropy over a [B, T] batch. `loss_mask` ([B, T-1],
    0/1) drops padded positions (zero-padded rollout rows must not train
    the models on trailing token-0 context)."""
    logits = _batch_logits(params, cfg, tokens)[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return _masked_mean(nll, loss_mask)


def distill_loss(params, cfg, teacher_logits, tokens, temperature=1.0,
                 loss_mask=None):
    """KL(teacher || student) on teacher logits (soft distillation), up to
    the teacher's entropy: -sum t log s."""
    logits = _batch_logits(params, cfg, tokens)[:, :-1]
    t = torch.softmax(teacher_logits[:, :-1] / temperature, dim=-1)
    logp = torch.log_softmax(logits / temperature, dim=-1)
    kl = -(t * logp).sum(dim=-1)
    return _masked_mean(kl, loss_mask)


def _leaves(params: LlamaParams):
    return [params.embed, *params.layers, params.final_norm, params.lm_head]


def _params(leaves) -> LlamaParams:
    return LlamaParams(embed=leaves[0], layers=LayerParams(*leaves[1:10]),
                       final_norm=leaves[10], lm_head=leaves[11])


def train_lm(
    cfg: LlamaConfig,
    data: np.ndarray,  # i32 [N, T] token rows (vocab must fit cfg.vocab_size)
    *,
    steps: int = 300,
    batch_size: int = 8,
    lr: Union[float, Callable[[int], float]] = 3e-3,  # or a schedule of the step
    seed: int = 0,
    teacher: Optional[Tuple[LlamaParams, LlamaConfig]] = None,
    init: Optional[LlamaParams] = None,
    distill_temperature: float = 1.0,
    mix_ce: float = 0.0,  # weight of the hard-label CE added to the KL
    lengths: Optional[np.ndarray] = None,  # i32 [N] true row lengths; loss
                                           # masked past length-1 (padding)
    device=None,
    losses: Optional[list] = None,
) -> LlamaParams:
    """AdamW-train a model on `data` (CE), or distill from `teacher`.

    `distill_temperature` < 1 sharpens the teacher before matching,
    weighting the mode agreement that T<1 sampling-time acceptance tests;
    `mix_ce` adds hard-label CE on the corpus. Float weights only (the
    kernels of quantized weights have no backward). `init` (default
    `random_params(cfg, seed)` in f32) is copied, not trained in place.
    `device` None is the CUDA card; `losses`, a list, receives each step's
    loss as a 0-d device tensor (no host read a step). The params returned
    require no grad, so engines and graph captures can take them."""
    data = np.asarray(data, np.int32)
    assert data.max() < cfg.vocab_size
    dev = resolve_device(device)
    start = init if init is not None else random_params(cfg, seed, dtype=torch.float32,
                                                        device=dev)
    leaves = [t.detach().to(device=dev, dtype=torch.float32).clone().requires_grad_(True)
              for t in _leaves(start)]
    params = _params(leaves)
    schedule = lr if callable(lr) else (lambda _: lr)
    opt = torch.optim.AdamW(leaves, lr=schedule(0), weight_decay=0.01)

    if teacher is not None:
        t_params, t_cfg = teacher

        def loss_fn(batch, lmask):
            with torch.no_grad():
                tlogits = _batch_logits(t_params, t_cfg, batch)
            loss = distill_loss(params, cfg, tlogits, batch,
                                temperature=distill_temperature, loss_mask=lmask)
            if mix_ce:
                loss = loss + mix_ce * lm_loss(params, cfg, batch, loss_mask=lmask)
            return loss
    else:
        def loss_fn(batch, lmask):
            return lm_loss(params, cfg, batch, loss_mask=lmask)

    T = data.shape[1]
    if lengths is not None:
        lengths = np.asarray(lengths, np.int32)
        assert lengths.shape == (len(data),)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = rng.integers(0, len(data), size=batch_size)
        batch = torch.as_tensor(data[idx], dtype=torch.long, device=dev)
        lmask = None
        if lengths is not None:
            lmask = torch.as_tensor(np.arange(T - 1)[None, :] < (lengths[idx] - 1)[:, None],
                                    dtype=torch.float32, device=dev)
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        loss = loss_fn(batch, lmask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
    return _params([t.detach() for t in leaves])


def corpus_from_reference(
    path: Optional[str] = None,
    vocab_size: int = 512,
    seq_len: int = 64,
    limit: int = 200,
) -> np.ndarray:
    """Bundled c4_small token rows remapped into a small vocab. The mod-remap
    destroys the original token identities but keeps the *sequential
    structure* (the same deterministic stream for draft and target), which is
    all acceptance-rate correlation needs. Default path: the repo's bundled
    copy (`data/datasets.py::C4_SMALL`)."""
    from ..data.datasets import C4_SMALL, load_pretokenized_jsonl

    ds = load_pretokenized_jsonl(path or C4_SMALL, seq_len=seq_len, limit=limit)
    return (ds.ids % vocab_size).astype(np.int32)


def _shape_cfg(base, layers: int, hidden: int):
    """Derive a config of the given depth/width from `base`: heads scale
    with hidden at head_dim 32, ffn at 2x hidden."""
    return dataclasses.replace(
        base, num_layers=layers, hidden_size=hidden,
        intermediate_size=2 * hidden, num_heads=max(hidden // 32, 1),
        num_kv_heads=max(hidden // 32, 1),
    )


def make_correlated_pair(
    *,
    steps: int = 300,
    seq_len: int = 64,
    seed: int = 0,
    distill_draft: bool = False,
    corpus_limit: int = 200,
    target_shape: Optional[Tuple[int, int]] = None,  # (layers, hidden)
    draft_shape: Optional[Tuple[int, int]] = None,
    draft_steps: Optional[int] = None,
    device=None,
    report: Optional[dict] = None,
):
    """Train a (draft, target) pair on the bundled corpus. Returns
    `(draft_params, draft_cfg, target_params, target_cfg)` (f32).

    `target_shape` / `draft_shape` override the default 4L-128h / 2L-64h
    pair (a deeper target brings the measured accepted/step into the
    regime of a real pair); `draft_steps` trains or distills the draft
    longer than the target (draft quality is what acceptance is made of).
    `device` None is the CUDA card. `report`, a dict, receives for
    "target" and "draft" the step losses (floats, read once at the end of
    each training) and the training's wall seconds up to that read."""
    from ..core.config import get_config

    t_cfg = get_config("test-small")   # 4 layers, 128 hidden, vocab 512
    d_cfg = get_config("test-tiny")    # 2 layers, 64 hidden, vocab 256
    d_cfg = dataclasses.replace(d_cfg, vocab_size=t_cfg.vocab_size)
    if target_shape is not None:
        t_cfg = _shape_cfg(t_cfg, *target_shape)
    if draft_shape is not None:
        d_cfg = _shape_cfg(d_cfg, *draft_shape)
    data = corpus_from_reference(vocab_size=t_cfg.vocab_size, seq_len=seq_len,
                                 limit=corpus_limit)

    def train(name, cfg, **kw):
        t0 = time.perf_counter()
        losses = [] if report is not None else None
        params = train_lm(cfg, data, device=device, losses=losses, **kw)
        if report is not None:
            report[name] = {"losses": torch.stack(losses).tolist(),
                            "seconds": time.perf_counter() - t0}
        return params

    target = train("target", t_cfg, steps=steps, seed=seed)
    ds = draft_steps if draft_steps is not None else steps
    teacher = (target, t_cfg) if distill_draft else None
    draft = train("draft", d_cfg, steps=ds, seed=seed + 1, teacher=teacher)
    return draft, d_cfg, target, t_cfg
