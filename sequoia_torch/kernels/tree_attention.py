"""Tree attention over main cache ∪ tree scratch: CUDA kernel and plain
version.

Port of `sequoia_tpu/kernels/tree_attention.py::tree_attention`. Queries
`[Q, H, D]` attend the main cache `[M, Hkv, D]` under a bool mask `[Q, M]`
and the tree scratch `[S, Hkv, D]` under a bool mask `[Q, S]` (S may be 0)
in ONE softmax; query head h reads KV head h // (H // Hkv). Scores and the
softmax run in f32; probabilities are cast to V's dtype for the value
product, accumulated in f32; the output has q's dtype. Masked scores are
the finite -1e30, so a fully masked region contributes zero, not NaN.

With `ks` / `vs` (f32 `[M, Hkv]`) the main cache is quantized, as the JAX
model reads it (`sequoia_tpu/core/model.py:263-338, 361-377`): int8 rows
`[M, Hkv, D]`, or packed int4 rows, head-paired `[M, Hkv/2, D]` or dsplit
`[M, Hkv, D/2]` (`kvcache/cache.py::KVCache4`), told apart by shape. The
integer rows are cast exactly to q's dtype; a main score is
`dot * scale * ks[m, h // g]` before the mask; main and scratch share the one
softmax; a main probability is multiplied by `vs[m, h // g]` and then cast
to q's dtype for the value product. The scratch is always float. A row
never written has scale 0 and is masked by every caller.

On a CUDA tensor `tree_attention` launches the kernel of
`csrc/tree_attention.cu` (or raises); on a CPU tensor it runs
`tree_attention_plain`.
"""

from __future__ import annotations

import torch

from . import build
from ..kvcache.cache import unpack_kv_rows4

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Main-cache formats: the kernel's code and the wrapper's launch counter.
_FORMAT_CODE = {"float": 0, "int8": 1, "int4_head": 2, "int4_dsplit": 3}
_COUNTER = {"float": "tree_attention", "int8": "tree_attention_kv8",
            "int4_head": "tree_attention_kv4_head",
            "int4_dsplit": "tree_attention_kv4_dsplit"}


def cache_format(k: torch.Tensor, Hkv: int, D: int) -> str:
    """`float`, `int8`, `int4_head` or `int4_dsplit`, from the dtype and
    shape of one layer's main-cache rows `k`."""
    if k.dtype != torch.int8:
        return "float"
    if k.shape[1:] == (Hkv, D):
        return "int8"
    if Hkv % 2 == 0 and k.shape[1:] == (Hkv // 2, D):
        return "int4_head"
    if D % 2 == 0 and k.shape[1:] == (Hkv, D // 2):
        return "int4_dsplit"
    raise ValueError(f"tree_attention: int8 cache rows {tuple(k.shape)} fit no "
                     f"format for Hkv={Hkv} D={D}")


def tree_attention_plain(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                         ks=None, vs=None):
    """Einsum/softmax over `cat(main, scratch)`, step by step."""
    Q, H, D = q.shape
    Hkv = sk.shape[1]
    g = H // Hkv
    M = k.shape[0]
    qg = q.reshape(Q, Hkv, g, D).float()
    fmt = cache_format(k, Hkv, D)
    if fmt.startswith("int4"):
        k, v = (unpack_kv_rows4(t, packing=fmt[5:]) for t in (k, v))
    if fmt != "float":                     # integers, exact in q's dtype
        k, v = k.to(q.dtype), v.to(q.dtype)
    scores = torch.einsum("qhgd,mhd->hgqm", qg, k.float()) * scale
    if fmt != "float":
        scores = scores * ks.T[:, None, None, :]
    scores = scores.masked_fill(~main_mask[None, None], NEG)
    scores_scr = torch.einsum("qhgd,shd->hgqs", qg, sk.float()) * scale
    scores_scr = scores_scr.masked_fill(~scr_mask[None, None], NEG)
    full = torch.softmax(torch.cat([scores, scores_scr], dim=-1), dim=-1)
    probs, probs_scr = full[..., :M], full[..., M:]
    if fmt != "float":
        probs = probs * vs.T[:, None, None, :]
    out = (torch.einsum("hgqm,mhd->qhgd", probs.to(q.dtype).float(), v.float())
           + torch.einsum("hgqs,shd->qhgd", probs_scr.to(q.dtype).float(), sv.float()))
    return out.reshape(Q, H, D).to(q.dtype)


def _check(q, k, v, main_mask, sk, sv, scr_mask, ks, vs) -> str:
    Q, H, D = q.shape
    M = k.shape[0]
    S, Hkv = sk.shape[0], sk.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"tree_attention: unsupported dtype {q.dtype}")
    if D not in HEAD_DIMS or H % Hkv:
        raise ValueError(f"tree_attention: q {tuple(q.shape)} vs scratch "
                         f"{tuple(sk.shape)} (head dim must be one of {HEAD_DIMS})")
    fmt = cache_format(k, Hkv, D)
    floats = [("sk", sk), ("sv", sv)]
    tensors = [("q", q), ("k", k), ("v", v), ("main_mask", main_mask),
               ("sk", sk), ("sv", sv), ("scr_mask", scr_mask)]
    if fmt == "float":
        if ks is not None or vs is not None:
            raise ValueError("tree_attention: scales given with a float cache")
        if k.shape != (M, Hkv, D):
            raise ValueError("tree_attention: k/v/sk/sv shapes disagree")
        floats += [("k", k), ("v", v)]
    else:
        if ks is None or vs is None:
            raise ValueError("tree_attention: an integer cache needs ks and vs")
        for name, t in (("ks", ks), ("vs", vs)):
            if t.dtype != torch.float32 or t.shape != (M, Hkv):
                raise ValueError(f"tree_attention: {name} must be float32 "
                                 f"[{M}, {Hkv}], got {t.dtype} {tuple(t.shape)}")
        tensors += [("ks", ks), ("vs", vs)]
    for name, t in floats:
        if t.dtype != q.dtype:
            raise TypeError(f"tree_attention: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("main_mask", main_mask), ("scr_mask", scr_mask)):
        if t.dtype != torch.bool:
            raise TypeError(f"tree_attention: {name} must be bool, got {t.dtype}")
    if v.shape != k.shape or v.dtype != k.dtype or sk.shape != (S, Hkv, D) \
            or sv.shape != sk.shape:
        raise ValueError("tree_attention: k/v/sk/sv shapes disagree")
    if main_mask.shape != (Q, M) or scr_mask.shape != (Q, S):
        raise ValueError(f"tree_attention: masks {tuple(main_mask.shape)}, "
                         f"{tuple(scr_mask.shape)} for Q={Q} M={M} S={S}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"tree_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"tree_attention: {name} must be contiguous")
    # The kernel loads 16 bytes at a time (8 where a dsplit row has only 8).
    for name, t in (("k", k), ("v", v), ("sk", sk), ("sv", sv)):
        row_bytes = t.shape[-1] * t.element_size()
        if t.numel() and t.data_ptr() % min(16, row_bytes):
            raise ValueError(f"tree_attention: {name} is not 16-byte aligned")
    return fmt


def tree_attention(q, k, v, main_mask, sk, sv, scr_mask, *, scale: float,
                   ks=None, vs=None):
    """attn `[Q, H, D]` = softmax over main ∪ scratch (see module doc)."""
    if q.device.type == "cpu":
        return tree_attention_plain(q, k, v, main_mask, sk, sv, scr_mask,
                                    scale=scale, ks=ks, vs=vs)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fmt = _check(q, k, v, main_mask, sk, sv, scr_mask, ks, vs)
    Q, H, D = q.shape
    M = k.shape[0]
    S, Hkv = sk.shape[0], sk.shape[1]
    out = torch.empty_like(q)
    lib = build.load()
    rc = lib.sequoia_tree_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        main_mask.data_ptr(), sk.data_ptr(), sv.data_ptr(), scr_mask.data_ptr(),
        out.data_ptr(), Q, H, Hkv, D, M, S, float(scale), _DTYPE_CODE[q.dtype],
        _FORMAT_CODE[fmt], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, _COUNTER[fmt])
    build.launches[_COUNTER[fmt]] += 1
    return out
