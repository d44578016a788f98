"""Speculative-decoding engine: growmap-driven tree growth, one-pass tree
verification, and the device-side accept walk.

Port of `sequoia_tpu/engine/engine.py::SpecEngine` (all four algorithms,
`walk="node"`). One iteration = draft growth level by level into a tree
scratch, one target forward over the whole tree, the accept walk, the
commit of tokens and K/V rows, and a width-1 draft re-draft of the new
root. Everything inside an iteration stays on the device (offsets are
device tensors); the host reads two scalars per iteration, the emitted
count and the terminal flag. JAX fuses the iteration into one jitted call;
here it is a sequence of eager launches, and CUDA-graph capture of the
iteration waits for a later slice.

Slot/step invariants (identical to the reference):
- committed tokens occupy slots `[0, gtl)`; tree node i sits at slot
  `ts + i`, `ts = gtl - 1` (root = last committed token);
- the target verify forward has width `tree_size`; its rows (the root
  included) land in a scratch, and the main caches are read-only during
  grow and verify;
- after acceptance, the accepted rows are committed to both main caches
  and a width-1 draft forward on the bonus token seeds the next root.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import LlamaConfig
from ..core.model import LlamaParams, forward
from ..kvcache.cache import KVCache
from ..ops import masks
from ..ops.sampling import (
    gumbel,
    nucleus_cutoff,
    sample_argmax,
    sample_categorical_probs,
    sample_with_replacement,
    target_probs,
    wor_from_gumbel,
)
from ..trees.accept import (
    PathResult,
    resolve_path,
    stochastic_path_walk_node,
    token_match_accept,
)
from ..trees.growmap import GrowMap
from ..utils import make_generator, resolve_device
from .baseline import prefill_chunks

ALGORITHMS = ("sequoia", "specinfer", "greedy", "greedys")


@dataclass
class DecodeState:
    tokens: torch.Tensor             # long [max_length] committed + live tree slots
    gtl: torch.Tensor                # long 0-d committed length (root = slot gtl-1)
    draft_kv: KVCache
    target_kv: KVCache
    root_draft_logits: torch.Tensor  # f32 [vocab] draft logits at the root
    gen: torch.Generator
    terminal: torch.Tensor           # bool 0-d


class StepStats(NamedTuple):
    emitted: torch.Tensor     # long 0-d: tokens committed this iteration
    terminal: torch.Tensor    # bool 0-d
    first_rank: torch.Tensor  # long 0-d: sibling rank of the first accepted child, or -1


class _PhaseClock:
    """Per-phase device time: CUDA events on the card (read after the
    iteration's one host sync, so timing adds no sync), the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: Optional[str] = None) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def seconds(self) -> dict:
        """{phase: seconds}; a phase runs from its mark to the next."""
        out = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) / 1e3 if self.cuda else b - a
        return out


class SpecEngine:
    """Single-request speculative decoding over a static growmap."""

    def __init__(
        self,
        draft_params: LlamaParams,
        draft_cfg: LlamaConfig,
        target_params: LlamaParams,
        target_cfg: LlamaConfig,
        growmap: GrowMap,
        *,
        algorithm: str = "sequoia",
        max_length: int = 256,
        temperature: float = 0.6,
        top_p: float = 0.9,
        prefill_chunk: int = 128,
        mesh=None,
        shard_draft: bool = False,
        kv_quant: Optional[str] = None,
        walk: str = "node",
        device=None,
    ) -> None:
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}; known: {ALGORITHMS}")
        if walk != "node":
            raise NotImplementedError(f"walk={walk!r} is not ported yet (only 'node')")
        if mesh is not None or shard_draft:
            raise NotImplementedError("tensor parallelism is not ported yet")
        if kv_quant not in (None, "none"):
            raise NotImplementedError("quantized KV caches are not ported yet")
        if draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError("draft and target vocabularies differ")
        if algorithm in ("sequoia", "specinfer", "greedys") and temperature <= 0.0:
            raise ValueError("stochastic algorithms need T > 0")
        self.device = resolve_device(device)
        for name, p in (("draft", draft_params), ("target", target_params)):
            if p.embed.device != self.device:
                raise ValueError(f"{name} params on {p.embed.device}, engine on {self.device}")
        self.draft_params = draft_params
        self.target_params = target_params
        self.draft_cfg = draft_cfg
        self.target_cfg = target_cfg
        self.growmap = growmap
        self.algorithm = algorithm
        self.walk = walk
        self.max_length = max_length
        self.temperature = temperature
        self.top_p = top_p
        self.prefill_chunk = min(prefill_chunk, max_length)
        self.vocab = target_cfg.vocab_size
        self.stop_tokens = tuple(target_cfg.stop_tokens)

        gm, dev = growmap, self.device
        self.tree_size = gm.size
        self.max_depth = int(gm.depth.max()) if gm.size > 1 else 0
        self._md = max(self.max_depth, 1)  # path buffer length
        # Static device tensors of the topology.
        self._anc = torch.as_tensor(gm.ancestors, device=dev)
        self._succ_np = gm.successors_padded()
        self._succ = torch.as_tensor(self._succ_np, dtype=torch.long, device=dev)
        self._depth = torch.as_tensor(gm.depth, dtype=torch.long, device=dev)
        self._child_rank = torch.as_tensor(gm.child_rank(), dtype=torch.long, device=dev)
        self._level_roots = [torch.as_tensor(r, dtype=torch.long, device=dev) for r in gm.roots]
        self._level_gather = [torch.as_tensor(gm.sample_gather_index(i), device=dev)
                              for i in range(gm.num_grow_steps)]
        self._level_widths = gm.level_widths
        self._level_starts = gm.level_starts
        self._level_max_k = [max(b) for b in gm.branches]
        # Scratch masks of each grow level (static: the root's draft K/V is
        # in the main cache, so scratch column 0 is dropped).
        self._grow_scr_masks = []
        for s, w in zip(self._level_starts, self._level_widths):
            _, scr = masks.split_tree_masks(self._anc[s:s + w], 0, 1, root_in_main=True)
            self._grow_scr_masks.append(scr)
        self._k_idx = torch.arange(max_length, device=dev)
        self._stop = torch.as_tensor(list(self.stop_tokens), dtype=torch.long, device=dev)
        # Tree scratches, zeroed once and rewritten row by row before any
        # row is read (draft scratch row 0 is never written and stays 0).
        self._dscratch = KVCache.init(draft_cfg, gm.size, draft_params.embed.dtype, dev)
        self._tscratch = KVCache.init(target_cfg, gm.size, target_params.embed.dtype, dev)
        # Counters (reference metric: tests/testbed.py:94).
        self.num_decoding_steps = 0
        self.num_large_model_steps = 0

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------

    def prefill(self, prompt: np.ndarray, seed: int = 0) -> DecodeState:
        """Chunked prefill of both caches. The tail chunk shrinks so no
        write passes `max_length` (`sequoia_tpu/engine/engine.py:279-284`)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        if plen < 1 or plen + self.tree_size > self.max_length:
            raise ValueError(f"prompt length {plen} does not fit max_length "
                             f"{self.max_length} with a {self.tree_size}-node tree")
        dev = self.device
        state = DecodeState(
            tokens=torch.zeros(self.max_length, dtype=torch.long, device=dev),
            gtl=torch.tensor(plen, dtype=torch.long, device=dev),
            draft_kv=KVCache.init(self.draft_cfg, self.max_length,
                                  self.draft_params.embed.dtype, dev),
            target_kv=KVCache.init(self.target_cfg, self.max_length,
                                   self.target_params.embed.dtype, dev),
            root_draft_logits=torch.zeros(self.vocab, dtype=torch.float32, device=dev),
            gen=make_generator(seed, dev),
            terminal=torch.zeros((), dtype=torch.bool, device=dev),
        )
        C = self.prefill_chunk
        padded = np.zeros(((plen + C - 1) // C) * C, np.int64)
        padded[:plen] = prompt
        padded = torch.as_tensor(padded, device=dev)
        for off, c in prefill_chunks(plen, C, self.max_length):
            chunk = padded[off:off + c]
            positions = off + torch.arange(c, device=dev)
            mask = masks.causal_mask(c, self.max_length, off, dev)
            d_logits, _ = forward(self.draft_params, self.draft_cfg, chunk,
                                  positions, state.draft_kv, off, mask)
            forward(self.target_params, self.target_cfg, chunk, positions,
                    state.target_kv, off, mask)
            if 0 <= plen - 1 - off < c:
                state.root_draft_logits = d_logits[plen - 1 - off]
            state.tokens[off:off + c] = chunk
        return state

    # ------------------------------------------------------------------
    # One speculative iteration: grow, verify, finalize
    # ------------------------------------------------------------------

    def _draft_grow_sample(self, gen, level, logits_roots, gumbel_rows):
        """Children of one growth level, flat `[level_width]` in node order
        (`collective_grow_static` sampling, `Tree/SpecTree.py:103-104`)."""
        max_k = self._level_max_k[level]
        if self.algorithm == "sequoia":
            samples = wor_from_gumbel(logits_roots, gumbel_rows, self.temperature, max_k)
        elif self.algorithm == "specinfer":
            samples = sample_with_replacement(gen, logits_roots, self.temperature, max_k)
        else:  # greedy growth by top-k logits (greedy / greedyS)
            samples = sample_argmax(logits_roots, max_k)
        return samples.reshape(-1)[self._level_gather[level]]

    def _grow(self, state: DecodeState):
        """Draft growth, level by level. Tree K/V rows go into the draft
        scratch (slot i = node i); the main draft cache stays read-only.
        The tree tokens are also written into `state.tokens` at their slots
        (in place; slots past the committed prefix). Returns
        `(tokens_tree, draft_logits)`."""
        dev, size = self.device, self.tree_size
        ts = state.gtl - 1
        draft_logits = torch.zeros(size, self.vocab, dtype=torch.float32, device=dev)
        draft_logits[0] = state.root_draft_logits
        tokens_tree = torch.zeros(size, dtype=torch.long, device=dev)
        tokens_tree[0] = state.tokens[ts]
        # One gumbel block for every level's race (sequoia).
        g_all = None
        if self.algorithm == "sequoia" and self.growmap.num_grow_steps > 0:
            total_rows = sum(len(r) for r in self.growmap.roots)
            g_all = gumbel((total_rows, self.vocab), state.gen, dev)
        row_off = 0
        main_mask_row = (self._k_idx <= ts)[None, :]
        for lvl in range(self.growmap.num_grow_steps):
            w, start = self._level_widths[lvl], self._level_starts[lvl]
            nr = len(self.growmap.roots[lvl])
            g_rows = None
            if g_all is not None:
                g_rows = g_all[row_off:row_off + nr]
                row_off += nr
            new_tokens = self._draft_grow_sample(
                state.gen, lvl, draft_logits[self._level_roots[lvl]], g_rows)
            tokens_tree[start:start + w] = new_tokens
            state.tokens.index_copy_(0, ts + start + torch.arange(w, device=dev), new_tokens)
            positions = ts + self._depth[start:start + w]
            lvl_logits, _ = forward(
                self.draft_params, self.draft_cfg, new_tokens, positions,
                state.draft_kv, ts + start, main_mask_row.expand(w, -1),
                scratch=self._dscratch, scratch_offset=start,
                scratch_mask=self._grow_scr_masks[lvl],
            )
            draft_logits[start:start + w] = lvl_logits
        return tokens_tree, draft_logits

    def _verify(self, state: DecodeState, tokens_tree: torch.Tensor) -> torch.Tensor:
        """Target forward over the whole tree; its rows (root included: the
        bonus token never went through the target) land in the target
        scratch. Returns the target logits `[size, vocab]`."""
        ts = state.gtl - 1
        main_mask = (self._k_idx < ts)[None, :].expand(self.tree_size, -1)
        logits, _ = forward(
            self.target_params, self.target_cfg, tokens_tree, ts + self._depth,
            state.target_kv, ts, main_mask, scratch=self._tscratch,
            scratch_offset=0, scratch_mask=self._anc,
        )
        return logits

    def _finalize(self, state: DecodeState, tokens_tree, draft_logits,
                  target_logits) -> StepStats:
        """Accept walk, bonus token, commit of tokens and scratch rows, and
        the width-1 re-draft of the new root; updates `state` in place."""
        dev, md = self.device, self._md
        gtl = state.gtl
        ts = gtl - 1
        stochastic = self.algorithm in ("sequoia", "specinfer")
        if stochastic:
            r = torch.rand(self.tree_size, generator=state.gen, device=dev)
            is_sequoia = self.algorithm == "sequoia"
            cut = nucleus_cutoff(target_logits, self.top_p, self.temperature)
            walk = stochastic_path_walk_node(
                target_logits, draft_logits, tokens_tree, r, self._succ_np,
                self.temperature, cut, self.stop_tokens, md,
                strict=is_sequoia, mask_rejected_draft=is_sequoia,
            )
            path = PathResult(walk.path, walk.accept_count, walk.final_node,
                              walk.terminal)
            res = walk.p_final_row
            bonus = sample_categorical_probs(state.gen, res)
            terminal = path.terminal | torch.isnan(res).any()
        else:
            if self.algorithm == "greedy":
                verify_tok = target_logits.argmax(dim=-1)
            else:  # greedys
                p = target_probs(target_logits, self.top_p, self.temperature)
                verify_tok = sample_categorical_probs(state.gen, p)
            acc = token_match_accept(verify_tok, tokens_tree, self._succ)
            path = resolve_path(acc.accepted_child, tokens_tree, self.stop_tokens, md)
            bonus = acc.target_token[path.final_node]
            terminal = path.terminal
        has_bonus = ~terminal
        # A stop token emitted as the bonus also terminates.
        terminal = terminal | (has_bonus & (bonus == self._stop).any())
        count = path.accept_count
        emitted = count + has_bonus.long()

        # Commit accepted tokens + bonus at [gtl, gtl + md + 1).
        path_c = path.path.clamp_min(0)
        ar = torch.arange(md + 1, device=dev)
        block = torch.cat([tokens_tree[path_c], torch.zeros(1, dtype=torch.long, device=dev)])
        block = torch.where(ar < count, block, torch.zeros_like(block))
        block = torch.where((ar == count) & has_bonus, bonus, block)
        state.tokens.index_copy_(0, gtl + ar, block)

        # K/V commit, scratch rows -> main caches, in place. Target: fresh
        # rows for the root and every accepted node go to [ts, ts+1+md).
        # Draft: the root is already in main (last re-draft); the accepted
        # path goes to [gtl, gtl+md). Padding rows land at slots >= the new
        # committed length and are rewritten before they are ever read.
        zero1 = torch.zeros(1, dtype=torch.long, device=dev)
        state.target_kv.commit_rows(self._tscratch, torch.cat([zero1, path_c]), ts)
        state.draft_kv.commit_rows(self._dscratch, path_c, gtl)

        new_gtl = gtl + emitted
        new_ts = new_gtl - 1
        root_logits, _ = forward(
            self.draft_params, self.draft_cfg, state.tokens[new_ts][None],
            new_ts[None], state.draft_kv, new_ts, (self._k_idx <= new_ts)[None, :],
        )
        first = path.path[0]
        first_rank = torch.where(first >= 0, self._child_rank[first.clamp_min(0)],
                                 torch.full_like(first, -1))
        state.gtl = new_gtl
        state.root_draft_logits = root_logits[0]
        state.terminal = state.terminal | terminal
        return StepStats(emitted=emitted, terminal=state.terminal, first_rank=first_rank)

    def iterate(self, state: DecodeState, clock: Optional[_PhaseClock] = None) -> StepStats:
        """One speculative iteration, in place on `state`. With a clock,
        marks the phases `draft_run` (growth incl. sampling), `target_run`
        (verify forward) and `accept_kv` (walk, commit, re-draft), the
        reference's `benchmark=True` split (`Tree/SpecTree.py:99-241`)."""
        mark = clock.mark if clock is not None else (lambda name=None: None)
        mark("draft_run")
        tokens_tree, draft_logits = self._grow(state)
        mark("target_run")
        target_logits = self._verify(state, tokens_tree)
        mark("accept_kv")
        stats = self._finalize(state, tokens_tree, draft_logits, target_logits)
        mark()
        return stats

    # ------------------------------------------------------------------
    # Generation loops (the host reads emitted + terminal once per iteration)
    # ------------------------------------------------------------------

    def _fits(self, gtl: int) -> bool:
        return (gtl - 1 + self.tree_size <= self.max_length
                and gtl + self.max_depth + 1 <= self.max_length)

    def _run(self, prompt, max_new_tokens: int, seed: int, phase_totals=None):
        """Iterate until a stop token, the budget, or a full buffer; yields
        `(state, gtl_before, emitted)` after each iteration."""
        state = self.prefill(prompt, seed=seed)
        gtl = int(np.asarray(prompt).size)
        produced = 0
        self.num_decoding_steps = 0
        self.num_large_model_steps = 0
        while produced < max_new_tokens and self._fits(gtl):
            clock = _PhaseClock(self.device) if phase_totals is not None else None
            stats = self.iterate(state, clock)
            emitted, terminal = torch.stack(
                [stats.emitted, stats.terminal.long()]).tolist()  # one host read
            if clock is not None:
                for k, v in clock.seconds().items():
                    phase_totals[k] = phase_totals.get(k, 0.0) + v
            yield state, gtl, emitted
            produced += emitted
            gtl += emitted
            self.num_decoding_steps += emitted
            self.num_large_model_steps += 1
            if terminal:
                break

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 128,
                 seed: int = 0) -> np.ndarray:
        """Generate until a stop token / the budget / a full buffer.
        Returns the committed sequence (prompt + generated), int32."""
        state, gtl = None, int(np.asarray(prompt).size)
        for state, before, emitted in self._run(prompt, max_new_tokens, seed):
            gtl = before + emitted
        if state is None:
            return np.asarray(prompt, np.int32).reshape(-1)
        return state.tokens[:gtl].cpu().numpy().astype(np.int32)

    def generate_fast(self, prompt: np.ndarray, max_new_tokens: int = 128,
                      seed: int = 0) -> np.ndarray:
        """Same loop as `generate`: the JAX version runs the loop on the
        device; here that waits for CUDA-graph capture of the iteration."""
        return self.generate(prompt, max_new_tokens, seed)

    def generate_benchmark(self, prompt: np.ndarray, max_new_tokens: int = 128,
                           seed: int = 0):
        """Generation with per-phase device times (CUDA events on the card);
        returns `(tokens, {phase: total_seconds})`."""
        totals = {"draft_run": 0.0, "target_run": 0.0, "accept_kv": 0.0}
        state, gtl = None, int(np.asarray(prompt).size)
        for state, before, emitted in self._run(prompt, max_new_tokens, seed, totals):
            gtl = before + emitted
        if state is None:
            return np.asarray(prompt, np.int32).reshape(-1), totals
        return state.tokens[:gtl].cpu().numpy().astype(np.int32), totals

    def stream(self, prompt: np.ndarray, max_new_tokens: int = 128, seed: int = 0):
        """Yield the newly committed tokens (np int32) after each iteration."""
        for state, before, emitted in self._run(prompt, max_new_tokens, seed):
            yield state.tokens[before:before + emitted].cpu().numpy().astype(np.int32)
