"""Autoregressive baseline decoder (the reference `--Mode baseline`,
`tests/testbed.py:99-143`): one target forward per token. The denominator
of every speedup, and the greedy parity check of the speculative engine.

Port of `sequoia_tpu/engine/baseline.py::ARBaseline`. One difference on
purpose: the prefill's tail chunk shrinks to `max_length`, as
`SpecEngine.prefill` does. The JAX baseline rounds the prompt up to a whole
chunk past `max_length`, and its window write then clamps and overwrites
committed rows.

The state lives in buffers the baseline allocates once (`prefill` resets
them), and a step reads nothing back to the host, so `generate_fast`
captures one step into a CUDA graph (`engine/graphs.py`) and replays it
`min(BLOCK_STEPS, remaining budget)` times per host read of `(produced, terminal)`,
where JAX runs `_loop_impl`'s `lax.while_loop`. A step after a stop token is
a predicated no-op (`n` and the logits keep their values; writes land at
slot `n`). On the CPU the same block runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.model import LlamaParams, forward
from ..kvcache.cache import KV_CACHES, KVCache
from ..ops import masks
from ..ops.sampling import sample_categorical_probs, target_probs
from ..quant.qtensor import w8a8_setting
from ..utils import make_generator
from .graphs import GraphSet

# Most steps a `generate_fast` block replays before the host reads. A
# block that a stop token ends early replays the rest of its steps as
# no-ops, each as long as a live one; a host read costs about 0.13 ms at 7B
# on an H100 (PERF.md, chip_smoke.py's `block_costs`).
BLOCK_STEPS = 2


@dataclass
class ARState:
    """Views of the baseline's buffers; `prefill` resets them, so a new
    `prefill` ends the request of every earlier state."""
    tokens: torch.Tensor       # long [max_length]
    n: torch.Tensor            # long 0-d committed length
    kv: KVCache                # or KVCache8 / KVCache4
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

        if kv_quant not in KV_CACHES:
            raise ValueError(f"kv_quant must be one of none, int8, int4; got {kv_quant!r}")
        self.kv_quant = None if kv_quant == "none" else kv_quant
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
        # The request's buffers, allocated once and reset by `prefill`.
        dev = self.device
        self._gen = make_generator(0, dev)
        self._tokens = torch.zeros(max_length, dtype=torch.long, device=dev)
        self._n = torch.zeros((), dtype=torch.long, device=dev)
        self._kv = KV_CACHES[self.kv_quant].init(cfg, max_length, params.embed.dtype, device=dev)
        self._last_logits = torch.zeros(cfg.vocab_size, dtype=torch.float32, device=dev)
        self._terminal = torch.zeros((), dtype=torch.bool, device=dev)
        # The device loop's counters: tokens since the loop began, its budget.
        self._produced = torch.zeros((), dtype=torch.long, device=dev)
        self._budget = torch.zeros((), dtype=torch.long, device=dev)
        self._always = torch.ones((), dtype=torch.bool, device=dev)
        # The step's CUDA graph; on the CPU the same step runs eagerly.
        self._graphs = GraphSet(dev, self._gen) if dev.type == "cuda" else None

    def _prefill_chunk(self, state: ARState, chunk: torch.Tensor, offset: int,
                       prompt_len: int) -> None:
        C = chunk.shape[0]
        positions = offset + torch.arange(C, device=self.device)
        mask = masks.causal_mask(C, self.max_length, offset, self.device)
        logits, _ = forward(self.params, self.cfg, chunk, positions, state.kv,
                            offset, mask)
        last = prompt_len - 1 - offset
        if 0 <= last < C:
            state.last_logits.copy_(logits[last])
        state.tokens[offset:offset + C] = chunk

    def _sample(self, gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return logits.argmax(dim=-1)
        p = target_probs(logits[None], self.top_p, self.temperature)[0]
        return sample_categorical_probs(gen, p)

    def _step(self, state: ARState, live: torch.Tensor) -> torch.Tensor:
        """One decode step, in place on `state`; returns the token (0-d).
        Split-cache step: the main cache is read-only in the forward, the
        new row lands in a 1-row scratch and is committed after. `live`
        (bool 0-d) false makes it a no-op: the token and K/V row land at
        slot `n`, which stays uncommitted."""
        token = self._sample(state.gen, state.last_logits)
        state.tokens.index_copy_(0, state.n.reshape(1), token.reshape(1))
        mask = (self._k_idx < state.n)[None, :]
        logits, scr = forward(
            self.params, self.cfg, token.reshape(1), state.n.reshape(1), state.kv,
            state.n, mask, scratch=self._scratch, scratch_offset=0,
            scratch_mask=self._scr_mask,
        )
        state.kv.commit_rows(scr, self._slot0, state.n)
        state.last_logits.copy_(torch.where(live, logits[0], state.last_logits))
        state.terminal.copy_(state.terminal | (live & (token == self._stop).any()))
        state.n.add_(live.long())
        return token

    def step(self, state: ARState) -> torch.Tensor:
        """One decode step, launched eagerly; returns the token (0-d)."""
        return self._step(state, self._always)

    def _step_counted(self, state: ARState) -> None:
        """A step under the device loop's predicate (JAX `_loop_impl`'s
        `cond`: not terminal, under the budget), counting its token."""
        live = ~state.terminal & (self._produced < self._budget)
        self._step(state, live)
        self._produced.add_(live.long())

    def prefill(self, prompt: np.ndarray, seed: int = 0) -> ARState:
        """Chunked prefill; resets and reuses the buffers (and reseeds the
        generator with `seed`): the returned state replaces every earlier
        one."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        if not 1 <= plen <= self.max_length:
            raise ValueError(f"prompt length {plen} vs max_length {self.max_length}")
        self._gen.manual_seed(int(seed))
        state = ARState(
            tokens=self._tokens.zero_(), n=self._n.fill_(plen), kv=self._kv.zero_(),
            last_logits=self._last_logits.zero_(), gen=self._gen,
            terminal=self._terminal.zero_(),
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

    def _ensure_graph(self, state: ARState) -> None:
        """Capture the counted step for the current matmul routes, after one
        warm-up step that is a no-op (budget 0; it writes at slot `n`, so
        `n` must be below `max_length`). On the card only."""
        def capture(g):
            self._budget.zero_()
            with g.warmup():
                self._step_counted(state)
            g.capture("step", lambda: self._step_counted(state))

        self._graphs.ensure(w8a8_setting(), capture)

    def graph_report(self) -> dict:
        """{"step": capture seconds, replays, launches per replay}; empty on
        the CPU or before the first capture."""
        return self._graphs.report() if self._graphs is not None else {}

    def generate_fast(self, prompt: np.ndarray, max_new_tokens: int = 128,
                      seed: int = 0) -> np.ndarray:
        """`generate` with the loop on the device (JAX `generate_fast`):
        blocks of `min(BLOCK_STEPS, remaining)` replayed steps, one host read
        each.
        The same tokens as `generate` for one seed."""
        state = self.prefill(prompt, seed)
        plen = int(np.asarray(prompt).size)
        self._check_budget(plen, max_new_tokens)
        if self._graphs is not None and max_new_tokens > 0:
            self._ensure_graph(state)
        self._produced.zero_()
        self._budget.fill_(max_new_tokens)
        produced, terminal = 0, False
        while not terminal and produced < max_new_tokens:
            k = min(BLOCK_STEPS, max_new_tokens - produced)
            if self._graphs is None:
                for _ in range(k):
                    self._step_counted(state)
            else:
                self._graphs.replay("step", k)
            produced, terminal = torch.stack(
                [self._produced, state.terminal.long()]).tolist()  # one host read
        return state.tokens[:plen + produced].cpu().numpy().astype(np.int32)

    def stream(self, prompt: np.ndarray, max_new_tokens: int = 128, seed: int = 0):
        """Yield one committed token (np int32 `[1]`) per decode step."""
        state = self.prefill(prompt, seed)
        self._check_budget(int(np.asarray(prompt).size), max_new_tokens)
        for _ in range(max_new_tokens):
            tok = self.step(state)
            yield tok.reshape(1).cpu().numpy().astype(np.int32)
            if bool(state.terminal):
                break
