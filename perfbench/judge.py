"""How `correct` is decided: the tokens served, against the plain reference.

Once the window has closed and the program's state is freed, a sample of the
requests the window finished, drawn from the seed, goes to the plain
reference of the target's family (`reference/<model_type>.py`): one float32
forward of the target over each prompt with its served tokens. Two
samples, each holding the longest request of its kind:

- greedy requests: a greedy token is the target's best, so its gap below
  the reference's best logit at its position is rounding alone. Compared:
  `gap_max`, the widest gap over the sample's tokens, and `gap_mean`, the
  mean gap. A wrong token lies far below; weights served in fewer bits than
  the configuration states flip many near ties, each by a wider gap.
- sampled requests, served by the configuration's sampler (the draft's
  tree, the target's verify, top-p and the accept walk): every token it
  commits is drawn from the target's tempered nucleus
  (`reference/nucleus.py`). Compared: `nucleus_excess`, the largest mass
  above a served token less P (over 0: a token outside the nucleus), and
  `logp_z`, the size of the served tokens' summed surprise `-log q - H(q)`
  over its standard deviation: that of a standard normal for tokens drawn
  from q, large for tokens drawn from elsewhere inside the nucleus, or
  more often from its top.

With `short_requests`, the requests of the window that came back with fewer
tokens than their budget and not ended by a stop token, these are the
numbers a cell's limits file (`limits/<cell>.json`) may name; a run
compares those it names, each with its limit.

`readings` gives the greedy numbers for a control too: the reference itself
in a lower precision (the configuration's `control_weights`), at each
position the gap of the token the control puts first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .drive import Served, short
from .reference.nucleus import token_stats


def sample(served: Sequence[Served], greedy: bool, count: int, seed: int) -> List[Served]:
    """`count` requests of one kind that served tokens: the longest, and the
    rest drawn from the seed."""
    pool = [s for s in served if s.request.greedy == greedy and len(s.tokens)]
    if not pool or count <= 0:
        return []
    longest = max(range(len(pool)),
                  key=lambda i: (len(pool[i].request.prompt) + len(pool[i].tokens), -i))
    rest = [i for i in range(len(pool)) if i != longest]
    rng = np.random.default_rng([int(seed), 4, int(greedy)])
    picked = rng.permutation(rest)[:max(0, count - 1)].tolist()
    return [pool[i] for i in [longest, *sorted(picked)]]


def samples(cell, served: Sequence[Served], seed: int):
    """The (greedy, sampled) samples a run judges (the mix's `check`)."""
    check = cell.traffic["check"]
    return (sample(served, True, int(check["greedy"]), seed),
            sample(served, False, int(check["sampled"]), seed))


def readings(cell, seed: int, greedy: Sequence[Served], sampled: Sequence[Served],
             device, controls: Sequence[str] = ()) -> Dict[str, Optional[float]]:
    """Every number of the module doc for these samples, in logits (gaps),
    probability (excess) and standard deviations (z) of the float32
    reference; for each weight format of `controls`, `control_gap_max.<fmt>`
    and `control_gap_mean.<fmt>` of that control's first choices."""
    out: Dict[str, Optional[float]] = {
        "gap_max": None, "gap_mean": None, "nucleus_excess": None, "logp_z": None,
        "greedy_tokens": 0, "sampled_tokens": 0}
    picked = list(greedy) + list(sampled)
    if not picked:
        return out
    config, target = cell.config, cell.models["target"]
    formats = [config["weights"]["target"], *controls]
    seqs, rows = [], []
    for s in picked:
        p = np.asarray(s.request.prompt, np.int64)
        seqs.append(torch.as_tensor(np.concatenate([p, s.tokens[:-1]])))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(s.tokens)))
    logits = target.reference().logits(target.dims, seed, "target", formats, seqs, rows,
                                       device, controls_over=len(greedy))
    if greedy:
        gaps = [[] for _ in formats]
        for i, s in enumerate(greedy):
            ref = logits[0][i]
            best = ref.max(dim=-1).values
            firsts = [torch.as_tensor(s.tokens, device=ref.device)]
            firsts += [logits[f][i].argmax(dim=-1) for f in range(1, len(formats))]
            for f, tok in enumerate(firsts):
                gaps[f].append(best - ref.gather(1, tok[:, None])[:, 0])
        gaps = [torch.cat(g) for g in gaps]
        out["gap_max"], out["gap_mean"] = float(gaps[0].max()), float(gaps[0].mean())
        for c, g in zip(controls, gaps[1:]):
            out[f"control_gap_max.{c}"] = float(g.max())
            out[f"control_gap_mean.{c}"] = float(g.mean())
        out["greedy_tokens"] = int(gaps[0].numel())
    if sampled:
        s_cfg = config["sampling"]
        ref = torch.cat(logits[0][len(greedy):])
        tok = torch.cat([torch.as_tensor(s.tokens) for s in sampled])
        st = token_stats(ref, tok, float(s_cfg["temperature"]), float(s_cfg["top_p"]))
        out["nucleus_excess"] = float(st.excess.max())
        var = float(st.variance[st.inside].sum())
        out["logp_z"] = abs(float(st.surprise.sum())) / math.sqrt(var) if var > 0 else 0.0
        out["sampled_tokens"] = int(tok.numel())
    return out


def judge(cell, seed: int, win, stop, device) -> dict:
    """The checks of one run: each number its limits file gives a limit,
    with that limit."""
    lim = {k: v for k, v in cell.limits.items() if isinstance(v, dict) and "limit" in v}
    values = {"short_requests": sum(short(s, stop) for s in win.served)}
    if any(k != "short_requests" for k in lim):
        values.update(readings(cell, seed, *samples(cell, win.served, seed), device))
    unknown = set(lim) - set(values)
    if unknown:
        raise KeyError(f"limits of {cell.name} name unknown numbers {sorted(unknown)}")
    return {name: {"value": values[name], "limit": lim[name]["limit"]} for name in lim}
