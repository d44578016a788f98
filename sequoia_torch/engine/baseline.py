"""Autoregressive baseline decoder (the reference `--Mode baseline`,
`tests/testbed.py:99-143`): one target forward per token. The denominator
of every speedup, and the greedy parity check of the speculative engine.

Port of `sequoia_tpu/engine/baseline.py::ARBaseline`. One difference on
purpose: the prefill's tail chunk shrinks to `max_length`, as
`SpecEngine.prefill` does. The JAX baseline rounds the prompt up to a whole
chunk past `max_length`, and its window write then clamps and overwrites
committed rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.model import LlamaParams, forward
from ..kvcache.cache import KVCache
from ..ops import masks
from ..ops.sampling import sample_categorical_probs, target_probs
from ..utils import make_generator


@dataclass
class ARState:
    tokens: torch.Tensor       # long [max_length]
    n: torch.Tensor            # long 0-d committed length
    kv: KVCache
    last_logits: torch.Tensor  # f32 [vocab] logits at the last committed token
    gen: torch.Generator
    terminal: torch.Tensor     # bool 0-d


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def prefill_chunks(plen: int, chunk: int, max_length: int):
    """`(offset, width)` of each prefill chunk: whole chunks, and a tail
    chunk that never passes `max_length`."""
    padded_len = min(_round_up(plen, chunk), max_length)
    out, off = [], 0
    while off < plen:
        c = min(chunk, padded_len - off)
        out.append((off, c))
        off += c
    return out


class ARBaseline:
    def __init__(
        self,
        params: LlamaParams,
        cfg: LlamaConfig,
        *,
        max_length: int = 256,
        temperature: float = 0.6,
        top_p: float = 0.9,
        greedy: bool = False,
        prefill_chunk: int = 128,
        kv_quant=None,
        device=None,
    ) -> None:
        from ..utils import resolve_device

        if kv_quant not in (None, "none"):
            raise NotImplementedError("quantized KV caches are not ported yet")
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"params on {params.embed.device}, engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_length = max_length
        self.temperature = temperature
        self.top_p = top_p
        self.greedy = greedy
        self.prefill_chunk = min(prefill_chunk, max_length)
        self._stop = torch.as_tensor(list(cfg.stop_tokens), dtype=torch.long,
                                     device=self.device)
        self._k_idx = torch.arange(max_length, device=self.device)
        # One-row scratch for the step's new K/V (zeroed once, rewritten
        # every step before it is read).
        self._scratch = KVCache.init(cfg, 1, params.embed.dtype, self.device)
        self._scr_mask = torch.ones((1, 1), dtype=torch.bool, device=self.device)
        self._slot0 = torch.zeros((1,), dtype=torch.long, device=self.device)

    def _prefill_chunk(self, state: ARState, chunk: torch.Tensor, offset: int,
                       prompt_len: int) -> None:
        C = chunk.shape[0]
        positions = offset + torch.arange(C, device=self.device)
        mask = masks.causal_mask(C, self.max_length, offset, self.device)
        logits, _ = forward(self.params, self.cfg, chunk, positions, state.kv,
                            offset, mask)
        last = prompt_len - 1 - offset
        if 0 <= last < C:
            state.last_logits = logits[last]
        state.tokens[offset:offset + C] = chunk

    def _sample(self, gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return logits.argmax(dim=-1)
        p = target_probs(logits[None], self.top_p, self.temperature)[0]
        return sample_categorical_probs(gen, p)

    def step(self, state: ARState) -> torch.Tensor:
        """One decode step, in place on `state`; returns the token (0-d).
        Split-cache step: the main cache is read-only in the forward, the
        new row lands in a 1-row scratch and is committed after."""
        token = self._sample(state.gen, state.last_logits)
        state.tokens.index_copy_(0, state.n[None], token[None])
        mask = (self._k_idx < state.n)[None, :]
        logits, scr = forward(
            self.params, self.cfg, token[None], state.n[None], state.kv,
            state.n, mask, scratch=self._scratch, scratch_offset=0,
            scratch_mask=self._scr_mask,
        )
        state.kv.commit_rows(scr, self._slot0, state.n)
        state.n = state.n + 1
        state.last_logits = logits[0]
        state.terminal = state.terminal | (token == self._stop).any()
        return token

    def prefill(self, prompt: np.ndarray, seed: int = 0) -> ARState:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        if not 1 <= plen <= self.max_length:
            raise ValueError(f"prompt length {plen} vs max_length {self.max_length}")
        state = ARState(
            tokens=torch.zeros(self.max_length, dtype=torch.long, device=self.device),
            n=torch.tensor(plen, dtype=torch.long, device=self.device),
            kv=KVCache.init(self.cfg, self.max_length, self.params.embed.dtype,
                            self.device),
            last_logits=torch.zeros(self.cfg.vocab_size, dtype=torch.float32,
                                    device=self.device),
            gen=make_generator(seed, self.device),
            terminal=torch.zeros((), dtype=torch.bool, device=self.device),
        )
        C = self.prefill_chunk
        padded = np.zeros(_round_up(plen, C), np.int64)
        padded[:plen] = prompt
        padded = torch.as_tensor(padded, device=self.device)
        for off, c in prefill_chunks(plen, C, self.max_length):
            self._prefill_chunk(state, padded[off:off + c], off, plen)
        return state

    def _check_budget(self, plen: int, max_new_tokens: int) -> None:
        if plen + max_new_tokens > self.max_length:
            raise ValueError(f"prompt {plen} + {max_new_tokens} new tokens "
                             f"exceeds max_length {self.max_length}")

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 128,
                 seed: int = 0) -> np.ndarray:
        """Decode until a stop token or the budget; the host reads the
        terminal flag once per step. Returns prompt + generated tokens."""
        state = self.prefill(prompt, seed)
        plen = int(np.asarray(prompt).size)
        self._check_budget(plen, max_new_tokens)
        n = plen
        for _ in range(max_new_tokens):
            self.step(state)
            n += 1
            if bool(state.terminal):
                break
        return state.tokens[:n].cpu().numpy().astype(np.int32)

    def generate_fast(self, prompt: np.ndarray, max_new_tokens: int = 128,
                      seed: int = 0) -> np.ndarray:
        """Same loop as `generate`: the JAX version keeps the loop on the
        device; here that waits for CUDA-graph capture of the step."""
        return self.generate(prompt, max_new_tokens, seed)

    def stream(self, prompt: np.ndarray, max_new_tokens: int = 128, seed: int = 0):
        """Yield one committed token (np int32 `[1]`) per decode step."""
        state = self.prefill(prompt, seed)
        self._check_budget(int(np.asarray(prompt).size), max_new_tokens)
        for _ in range(max_new_tokens):
            tok = self.step(state)
            yield tok.reshape(1).cpu().numpy().astype(np.int32)
            if bool(state.terminal):
                break
