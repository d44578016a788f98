"""Faults planted in the program under test, for the benchmark's own checks.

Each fault is a change to the timed path that a sound program never makes.
The fault tests (the CPU, tiny cells) and `calibrate.py --fault` (the card,
a cell's own size: the upper readings of the limits) plant one with
`plant(name, put)` before the engines are built, so that the captured
graphs hold it. `put(owner, attribute, value)` is `setattr`, or a test's
`monkeypatch.setattr`.

- `token_altered`: the last token each step commits is replaced by the next
  id, where it is produced.
- `state_unchanged`: a step leaves the committed tokens as they were.
- `half_slots`: the upper half of the slots counts as finished.
- `walk_accepts_all`: the accept walk's uniforms are -1, so it accepts every
  draft token, in the target's nucleus or not.
- `walk_in_nucleus`: the uniforms are 0, so it accepts every draft token
  the target's nucleus holds: tokens drawn from the draft, not the target.
- `top_p_off`: the nucleus cut-off is 0, so the target keeps its whole
  distribution.
"""

from __future__ import annotations

import torch

from sequoia_torch.engine import batched as batched_mod
from sequoia_torch.engine import engine as engine_mod
from sequoia_torch.engine.batched import BatchedSpecEngine
from sequoia_torch.engine.engine import SpecEngine

FAULTS = ("token_altered", "state_unchanged", "half_slots", "walk_accepts_all",
          "walk_in_nucleus", "top_p_off")
_FINALIZE = ((SpecEngine, "_finalize"), (BatchedSpecEngine, "_bfinalize"))
_WALK = ((SpecEngine, "_walk"), (BatchedSpecEngine, "_bwalk"))


def _alter_last(tokens: torch.Tensor, gtl: torch.Tensor, vocab: int) -> None:
    idx = (gtl - 1).clamp_min(0).reshape(tokens.shape[:-1] + (1,))
    tokens.scatter_(-1, idx, (tokens.gather(-1, idx) + 1) % vocab)


def _after_finalize(orig, fault):
    def broken(self, state, *a):
        before = state.tokens.clone() if fault == "state_unchanged" else None
        out = orig(self, state, *a)
        if before is None:
            _alter_last(state.tokens, state.gtl, self.vocab)
        else:
            state.tokens.copy_(before)
        return out
    return broken


def _walk_with(orig, value: float):
    def broken(self, tokens_tree, draft_logits, target_logits, r):
        return orig(self, tokens_tree, draft_logits, target_logits, torch.full_like(r, value))
    return broken


def _no_cutoff(logits, top_p, temperature):
    return torch.zeros(logits.shape[:-1], dtype=torch.float32, device=logits.device)


def plant(name: str, put=setattr) -> None:
    """Plant fault `name` (one of `FAULTS`) in the engine classes."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    if name in ("token_altered", "state_unchanged"):
        for cls, attr in _FINALIZE:
            put(cls, attr, _after_finalize(getattr(cls, attr), name))
    elif name == "half_slots":
        orig = BatchedSpecEngine._slot_finished

        def broken(self):
            fin = orig(self).clone()
            fin[self.batch_size // 2:] = True
            return fin

        put(BatchedSpecEngine, "_slot_finished", broken)
    elif name.startswith("walk_"):
        value = -1.0 if name == "walk_accepts_all" else 0.0
        for cls, attr in _WALK:
            put(cls, attr, _walk_with(getattr(cls, attr), value))
    else:
        for mod in (engine_mod, batched_mod):
            put(mod, "nucleus_cutoff", _no_cutoff)
