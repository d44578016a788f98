"""Teacher-forced perplexity evaluation.

Port of `sequoia_tpu/tools/perplexity.py`: token-level negative
log-likelihood over a `TokenDataset`, a chunked write-mode pass of
`core/model.py::forward` a row, on the params' device (the CUDA card unless
they lie on the CPU). It is the quality yardstick of quantization: compare
`evaluate(...)` of bf16 weights with `quant/quantize.py::quantize_model`'s
int8 and int4, and the float KV cache with the int8 / int4 ones
(`kv_quant`). The int8 delta should be about zero, the int4 delta the
stated bit-width cost.

Where JAX jits one `lax.scan` a row, the port runs the chunks eagerly; the
NLL sum and the count stay on the device, read once a row.

CLI: `python -m sequoia_torch.tools.perplexity --model <hf_dir> --data
x.jsonl [--quant int8] [--device cpu]`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.model import LlamaParams, forward
from ..kvcache.cache import KVCache, KVCache4, KVCache8
from ..ops import masks

KV_CACHES = {"int8": KVCache8, "int4": KVCache4, None: KVCache, "none": KVCache}


@dataclasses.dataclass
class PerplexityResult:
    nll: float          # mean negative log-likelihood per predicted token
    perplexity: float   # exp(nll)
    tokens: int         # number of predicted tokens scored


def _chunked_nll_fn(cfg: LlamaConfig, seq_len: int, chunk: int,
                    kv_quant: Optional[str] = None):
    """Returns fn(params, tokens [T] int, length) -> (sum_nll f32, count
    int64), 0-d tensors on the params' device: a prefill-style chunked
    forward accumulating next-token NLL, positions past `length` masked out
    of the loss. `kv_quant` scores with an int8 / int4 KV cache, so later
    chunks attend over quantized history (JAX `_chunked_nll_fn`)."""
    kv_cls = KV_CACHES[kv_quant]
    chunk = min(chunk, seq_len)
    n_chunks = (seq_len + chunk - 1) // chunk
    padded = n_chunks * chunk

    @torch.no_grad()
    def run(params, tokens, length):
        dev = params.embed.device
        kv = kv_cls.init(cfg, padded, params.embed.dtype, device=dev)
        # +1 so the shifted next-token slice of the LAST chunk is whole (JAX
        # pads the same way, where dynamic_slice would clamp its start).
        toks = torch.zeros(padded + 1, dtype=torch.long, device=dev)
        toks[:seq_len] = torch.as_tensor(tokens, device=dev)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        cnt = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(n_chunks):
            off = i * chunk
            pos = off + torch.arange(chunk, device=dev)
            mask = masks.causal_mask(chunk, padded, off, device=dev)
            logits, kv = forward(params, cfg, toks[off:off + chunk], pos, kv, off, mask)
            logp = torch.log_softmax(logits.float(), dim=-1)
            # logits at absolute position p predict token p+1.
            nxt = toks[off + 1:off + 1 + chunk]
            tok_lp = logp.gather(1, nxt[:, None])[:, 0]
            valid = (pos + 1) < length  # predicts a real (non-pad) token
            acc -= torch.where(valid, tok_lp, 0.0).sum()
            cnt += valid.sum()
        return acc, cnt

    return run


def evaluate(
    params: LlamaParams,
    cfg: LlamaConfig,
    ids: np.ndarray,       # [n, seq_len] int32 padded tokens
    lengths: np.ndarray,   # [n] true lengths
    *,
    chunk: int = 128,
    limit: Optional[int] = None,
    kv_quant: Optional[str] = None,
) -> PerplexityResult:
    ids = np.asarray(ids)
    lengths = np.asarray(lengths)
    if limit is not None:
        ids, lengths = ids[:limit], lengths[:limit]
    fn = _chunked_nll_fn(cfg, ids.shape[1], chunk, kv_quant)
    total, count = 0.0, 0
    for row, ln in zip(ids, lengths):
        if ln < 2:
            continue
        acc, cnt = fn(params, row.astype(np.int64), int(ln))
        total += float(acc)   # the row's one host read
        count += int(cnt)
    nll = total / max(count, 1)
    return PerplexityResult(nll=nll, perplexity=float(np.exp(nll)), tokens=count)


def main(argv=None) -> None:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True, help="HF checkpoint dir")
    ap.add_argument("--data", required=True,
                    help="pre-tokenized JSONL (c4_small style)")
    ap.add_argument("--quant", default="none", choices=["none", "int8", "int4"])
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--limit", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for small checks")
    args = ap.parse_args(argv)

    from ..core.init import load_hf_checkpoint
    from ..data.datasets import load_pretokenized_jsonl
    from ..utils import resolve_device

    device = resolve_device(args.device)
    params, cfg = load_hf_checkpoint(args.model, dtype=torch.bfloat16, device=device)
    if args.quant != "none":
        from ..quant.quantize import quantize_model

        params = quantize_model(params, bits={"int8": 8, "int4": 4}[args.quant])
    ds = load_pretokenized_jsonl(args.data, seq_len=args.seq_len)
    res = evaluate(params, cfg, ds.ids, ds.lengths,
                   chunk=args.chunk, limit=args.limit)
    print(_json.dumps({
        "model": args.model, "quant": args.quant,
        "nll": round(res.nll, 5), "perplexity": round(res.perplexity, 4),
        "tokens": res.tokens,
    }))


if __name__ == "__main__":
    main()
