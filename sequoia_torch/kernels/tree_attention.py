"""Tree attention over main cache ∪ tree scratch: CUDA kernel and plain
version.

Port of `sequoia_tpu/kernels/tree_attention.py::tree_attention`. Queries
`[Q, H, D]` attend the main cache `[M, Hkv, D]` under a bool mask `[Q, M]`
and the tree scratch `[S, Hkv, D]` under a bool mask `[Q, S]` (S may be 0)
in ONE softmax; query head h reads KV head h // (H // Hkv). Scores and the
softmax run in f32; probabilities are cast to V's dtype for the value
product, accumulated in f32; the output has q's dtype. Masked scores are
the finite -1e30, so a fully masked region contributes zero, not NaN.

On a CUDA tensor `tree_attention` launches the kernel of
`csrc/tree_attention.cu` (or raises); on a CPU tensor it runs
`tree_attention_plain`.
"""

from __future__ import annotations

import torch

from . import build

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tree_attention_plain(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float):
    """Einsum/softmax over `cat(main, scratch)`, step by step."""
    Q, H, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(Q, Hkv, g, D)
    keys = torch.cat([k, sk], dim=0)                        # [M+S, Hkv, D]
    vals = torch.cat([v, sv], dim=0)
    mask = torch.cat([main_mask, scr_mask], dim=1)          # [Q, M+S]
    scores = torch.einsum("qhgd,mhd->hgqm", qg.float(), keys.float()) * scale
    scores = scores.masked_fill(~mask[None, None], NEG)
    probs = torch.softmax(scores, dim=-1).to(vals.dtype)
    out = torch.einsum("hgqm,mhd->qhgd", probs.float(), vals.float())
    return out.reshape(Q, H, D).to(q.dtype)


def _check(q, k, v, main_mask, sk, sv, scr_mask):
    Q, H, D = q.shape
    M, Hkv, Dk = k.shape
    S = sk.shape[0]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"tree_attention: unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v), ("sk", sk), ("sv", sv)):
        if t.dtype != q.dtype:
            raise TypeError(f"tree_attention: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("main_mask", main_mask), ("scr_mask", scr_mask)):
        if t.dtype != torch.bool:
            raise TypeError(f"tree_attention: {name} must be bool, got {t.dtype}")
    if D not in HEAD_DIMS or Dk != D or H % Hkv:
        raise ValueError(f"tree_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}"
                         f" (head dim must be one of {HEAD_DIMS})")
    if v.shape != k.shape or sk.shape != (S, Hkv, D) or sv.shape != sk.shape:
        raise ValueError("tree_attention: k/v/sk/sv shapes disagree")
    if main_mask.shape != (Q, M) or scr_mask.shape != (Q, S):
        raise ValueError(f"tree_attention: masks {tuple(main_mask.shape)}, "
                         f"{tuple(scr_mask.shape)} for Q={Q} M={M} S={S}")
    for name, t in (("q", q), ("k", k), ("v", v), ("main_mask", main_mask),
                    ("sk", sk), ("sv", sv), ("scr_mask", scr_mask)):
        if t.device != q.device:
            raise ValueError(f"tree_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"tree_attention: {name} must be contiguous")
    for name, t in (("k", k), ("v", v), ("sk", sk), ("sv", sv)):
        if t.numel() and t.data_ptr() % 16:   # the kernel loads 16 bytes at a time
            raise ValueError(f"tree_attention: {name} is not 16-byte aligned")


def tree_attention(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float):
    """attn `[Q, H, D]` = softmax over main ∪ scratch (see module doc)."""
    if q.device.type == "cpu":
        return tree_attention_plain(q, k, v, main_mask, sk, sv, scr_mask,
                                    scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, main_mask, sk, sv, scr_mask)
    Q, H, D = q.shape
    M, Hkv, _ = k.shape
    S = sk.shape[0]
    out = torch.empty_like(q)
    lib = build.load()
    rc = lib.sequoia_tree_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), main_mask.data_ptr(),
        sk.data_ptr(), sv.data_ptr(), scr_mask.data_ptr(), out.data_ptr(),
        Q, H, Hkv, D, M, S, float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "tree_attention")
    build.launches["tree_attention"] += 1
    return out
