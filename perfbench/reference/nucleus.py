"""The reference's rule for sampling at temperature T with top-p P.

The distribution is softmax(logits / T) cut to its nucleus: the most
probable tokens, in order, up to and including the one at which their mass
reaches P, renormalised. A token is in it exactly when the mass of the tokens
more probable than it is below P. The sampler the configuration states draws
every token it serves from this distribution, whatever it drafted.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TokenStats:
    excess: torch.Tensor    # [N] mass strictly above the token, less P (< 0: in the nucleus)
    inside: torch.Tensor    # [N] bool: the token is in the nucleus
    surprise: torch.Tensor  # [N] -log q(token) - H(q), 0 where not inside
    variance: torch.Tensor  # [N] the variance of -log q under q


def token_stats(logits: torch.Tensor, tokens: torch.Tensor, temperature: float,
                top_p: float, block: int = 256) -> TokenStats:
    """`logits` `[N, V]` float32, `tokens` `[N]`: each row's nucleus q and
    where the row's token lies in it, a block of rows at a time."""
    parts = []
    for a in range(0, logits.shape[0], block):
        probs = torch.softmax(logits[a:a + block].double() / temperature, dim=-1)
        tok = tokens[a:a + block].to(probs.device)[:, None]
        p_tok = probs.gather(1, tok)
        excess = (probs * (probs > p_tok)).sum(dim=-1) - top_p
        ordered = probs.sort(dim=-1, descending=True).values
        before = ordered.cumsum(dim=-1) - ordered
        cut = ordered.masked_fill(before >= top_p, 2.0).min(dim=-1, keepdim=True).values
        keep = probs >= cut
        q = torch.where(keep, probs, torch.zeros((), dtype=probs.dtype, device=probs.device))
        q = q / q.sum(dim=-1, keepdim=True)
        logq = torch.where(keep, q.clamp_min(1e-300).log(), torch.zeros_like(q))
        entropy = -(q * logq).sum(dim=-1)
        variance = (q * logq * logq).sum(dim=-1) - entropy * entropy
        inside = keep.gather(1, tok)[:, 0]
        surprise = torch.where(inside, -logq.gather(1, tok)[:, 0] - entropy,
                               torch.zeros_like(entropy))
        parts.append((excess, inside, surprise, variance.clamp_min(0.0)))
    return TokenStats(*(torch.cat(x) for x in zip(*parts)))
