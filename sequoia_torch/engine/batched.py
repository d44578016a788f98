"""Batched speculative decoding and continuous batching.

Port of `sequoia_tpu/engine/batched.py`. JAX batches by `jax.vmap` over the
whole fused iteration; the port's kernels are launches on raw pointers,
which `torch.func.vmap` cannot batch, so the slot axis is explicit below the
engines: the caches are `[L, B, M, ...]` (`kvcache/cache.py`, batch = the
slot axis), `core/model.py::forward_batched` runs the projections once on
all slots' rows and attention as one launch of the batched tree-attention
kernel, and the accept walks (pure tensor code) run under
`torch.func.vmap`, their noise drawn beforehand as tensors. Every slot
grows, verifies, walks and commits its own tree.

Each slot draws from its own generator, seeded `seed + request id` when
its request is admitted, in the order and shapes of the single-request
`SpecEngine` / `ARBaseline`: a slot's tokens are those of a single-request
run with that seed (JAX folds the request id into a key; the port's
streams differ from JAX's anyway).

A slot iteration is predicated as in the single engine's device loop: a
slot is live while it is active (holds a request), not terminal, under the
budget and while its next tree fits (`limit`: the buffer, or in
`serve_device` the buffer less the `prefill_chunk` tail rows). A slot that
is not live emits nothing and keeps its committed tokens; its writes land
at rows past its committed length, cut to its last row
(`kvcache.cache.slot_rows`), and its cache is dead until a new request
refills it. JAX freezes such slots with a where-merge.

Loops, as in JAX: `generate_batch` and `serve` read the host after every
iteration; `generate_batch_fast`, `serve_fast` and `serve_device` replay the
captured phases (`engine/graphs.py`: grow, verify, finalize, and
`serve_device`'s admission step) in blocks, one host read a block, until
enough slots have finished; then the host harvests and admits.
`serve_device` (one XLA program in JAX) runs as waves of replayed graphs:
admission chunk steps at width `admit_width` (gather -> chunk forward ->
scatter), a decode block loop until `harvest_batch` active slots finish,
then the harvest and admission on the device (index copies), scheduled by
the host from the block's one read.

Spans (`trace.py`, while tracing): `serve` a `serve_device` call,
`admit.plan` an admission step's table and its copy to the card,
`replay.admit` the step, `harvest`, `decode` a block loop with its
`block`s (their `replay.<phase>`s) and `host_read`s; the counters
`admit_entries` (W a step) and `admit_valid` (the entries that carry a
prompt chunk).

Under a mesh (`SpecEngine`'s `mesh`), the tp axis shards each forward as
in the single engine, and the dp axis holds replicas: dp rank r serves its
contiguous share of the slots (`parallel/sharding.py::dp_share`; JAX
`shard_batched_state`), and of the requests of a queue, each request
seeded by its index in the whole input; the outputs are gathered over the
dp group in input order.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..core.model import forward_batched
from ..kvcache.cache import KV_CACHES, KVCache, KVCache4
from ..parallel.sharding import dp_share
from ..ops.sampling import (
    categorical_from_gumbel,
    draft_probs,
    gumbel_from_uniform,
    nucleus_cutoff,
    sample_argmax,
    target_probs,
    with_replacement_from_gumbel,
    wor_from_gumbel,
)
from ..quant.qtensor import w8a8_setting
from ..trees.accept import (
    PathResult,
    at_index,
    node_residual,
    resolve_path,
    stochastic_accept_decisions,
    stochastic_path_walk,
    stochastic_path_walk_node,
    stochastic_path_walk_unrolled,
    token_match_accept,
)
from ..utils import make_generator
from .baseline import BLOCK_STEPS, ARBaseline, _round_up, prefill_chunks
from .engine import BLOCK_ITERATIONS, SpecEngine, StepStats
from .graphs import GraphSet


def choose_serving_mode(spec_iter_s: float, expected_accepted: float,
                        ar_step_s: float) -> str:
    """AR-crossover policy (JAX `choose_serving_mode`): from measured costs
    of one batched speculative iteration, its accepted tokens per step and
    one batched AR step, the mode that emits more tokens per second; a tie
    goes to AR."""
    spec_tps = expected_accepted / max(spec_iter_s, 1e-12)
    ar_tps = 1.0 / max(ar_step_s, 1e-12)
    return "spec" if spec_tps > ar_tps else "ar"


def _uniform(gens, shape, device) -> torch.Tensor:
    """`[B, *shape]` uniform f32 draws, slot b's from `gens[b]` (the draw a
    single-request engine with that generator makes)."""
    return torch.stack([torch.rand(shape, generator=g, device=device, dtype=torch.float32)
                        for g in gens])


def _put(tokens: torch.Tensor, pos: torch.Tensor, values: torch.Tensor,
         live: torch.Tensor) -> None:
    """tokens[b, pos[b]] = values[b] for live slots, in place; a slot that is
    not live keeps its tokens (its positions, cut to the buffer, may repeat
    and may fall on committed tokens)."""
    pos = pos.clamp_max(tokens.shape[1] - 1)
    tokens.scatter_(1, pos, torch.where(live[:, None], values, tokens.gather(1, pos)))


class _SlotLoop:
    """The host side shared by both batched engines: the loop counters, the
    block loop with one host read a block, and continuous batching.

    An engine provides `_slot_finished()` (device bool `[B]`), `_slot_pos()`
    (committed length `[B]`), `_iteration()` (one predicated iteration),
    `_ensure_slot_graphs()`, `_fill(prompts, seed, fused)`,
    `_insert(prompt, slot, seed)`, `_block_len(...)` and `_tokens_buffer()`."""

    def _init_slots(self, batch_size: int) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        dev = self.device
        self.batch_size = batch_size
        self._gens = [make_generator(0, dev) for _ in range(batch_size)]
        self._bproduced = torch.zeros(batch_size, dtype=torch.long, device=dev)
        self._bactive = torch.zeros(batch_size, dtype=torch.bool, device=dev)
        self._bsteps = torch.zeros((), dtype=torch.long, device=dev)
        self._bbudget = torch.zeros((), dtype=torch.long, device=dev)
        self._blimit = torch.full((), self.max_length, dtype=torch.long, device=dev)
        self._bgraphs = GraphSet(dev, self._gens) if dev.type == "cuda" else None
        self._active = [False] * batch_size
        self._limit = self.max_length

    def _arm_slots(self, budget: int, limit: int, active: Sequence[bool]) -> None:
        self._bproduced.zero_()
        self._bsteps.zero_()
        self._bbudget.fill_(budget)
        self._blimit.fill_(limit)
        self._budget_host, self._limit = budget, limit
        self._set_active(active)

    def _set_active(self, active: Sequence[bool]) -> None:
        self._active = list(active)
        self._bactive.copy_(torch.as_tensor(self._active, dtype=torch.bool))

    def _read_slots(self):
        """One host read: (finished, produced, committed length) per slot and
        the iterations run since the loop was armed."""
        B = self.batch_size
        with trace.span("host_read"):
            vals = torch.cat([self._slot_finished().long(), self._bproduced, self._slot_pos(),
                              self._bsteps.reshape(1)]).tolist()
        return [bool(x) for x in vals[:B]], vals[B:2 * B], vals[2 * B:3 * B], vals[3 * B]

    def _run_slots(self, until: int, eager: bool):
        """Blocks of predicated iterations until at least `until` active slots
        have finished or none is live; one host read a block (eager: a block
        is one iteration, launched, not replayed). Returns (finished,
        produced, steps) as the last read saw them."""
        with trace.span("decode"):
            fin, prod, pos, steps = self._read_slots()
            while True:
                live = [b for b in range(self.batch_size) if self._active[b] and not fin[b]]
                done = sum(1 for b in range(self.batch_size) if self._active[b] and fin[b])
                if done >= until or not live:
                    return fin, prod, steps
                k = 1 if eager else self._block_len(live, prod, pos)
                with trace.span("block"):
                    for _ in range(k):
                        if eager or self._bgraphs is None:
                            self._iteration()
                        else:
                            for name in self._DECODE_GRAPHS:
                                self._bgraphs.replay(name)
                fin, prod, pos, steps = self._read_slots()

    def _generate_slots(self, prompts, max_new_tokens: int, seed: int, eager: bool):
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        if len(prompts) != self.batch_size:
            raise ValueError(f"{len(prompts)} prompts for {self.batch_size} slots")
        self._fill(prompts, seed, fused=True)
        self._arm_slots(max_new_tokens, self.max_length, [True] * self.batch_size)
        if not eager:
            self._ensure_slot_graphs()
        fin, prod, steps = self._run_slots(self.batch_size, eager)
        tokens = self._tokens_buffer().cpu().numpy()
        kept = [min(p, max_new_tokens) for p in prod]
        self.num_large_model_steps = steps
        self.num_decoding_steps = sum(kept)
        return [tokens[b, :len(p) + kept[b]].astype(np.int32) for b, p in enumerate(prompts)]

    def _serve_slots(self, prompts: Iterable, max_new_tokens: int, seed: int, eager: bool,
                     fused: bool = True):
        """Continuous batching (JAX `serve` / `serve_fast`): run until a slot
        finishes (all of them once the queue is empty), harvest it, refill it
        from the queue. Outputs in input order."""
        queue = list(enumerate(np.asarray(p, np.int64).reshape(-1) for p in prompts))
        results: List[Optional[np.ndarray]] = [None] * len(queue)
        B = self.batch_size
        slot_req, slot_plen, first = [-1] * B, [0] * B, []
        for s in range(B):
            if queue:
                rid, prompt = queue.pop(0)
                slot_req[s], slot_plen[s] = rid, len(prompt)
                first.append(prompt)
            else:
                first.append(np.zeros(1, np.int64))
        self._fill(first, seed, fused=fused)
        self._arm_slots(max_new_tokens, self.max_length, [r >= 0 for r in slot_req])
        if not eager and any(self._active):
            self._ensure_slot_graphs()
        decoded, steps = 0, 0
        while any(r >= 0 for r in slot_req):
            until = 1 if queue else sum(self._active)
            fin, prod, steps = self._run_slots(until, eager)
            tokens = None
            for s in range(B):
                rid = slot_req[s]
                if rid < 0 or not fin[s]:
                    continue
                if tokens is None:
                    tokens = self._tokens_buffer().cpu().numpy()
                kept = min(prod[s], max_new_tokens)
                decoded += kept
                results[rid] = tokens[s, :slot_plen[s] + kept].astype(np.int32)
                if queue:
                    nrid, nprompt = queue.pop(0)
                    slot_req[s], slot_plen[s] = nrid, len(nprompt)
                    self._insert(nprompt, s, seed + nrid)
                else:
                    slot_req[s] = -1
                    self._active[s] = False
                    self._set_active(self._active)
        self.num_decoding_steps = decoded
        self.num_large_model_steps = steps
        return results


@dataclass
class BatchState:
    """Views of a batched engine's slot buffers (the JAX `DecodeState` with a
    slot axis; the caches carry it on axis 1)."""
    tokens: torch.Tensor             # long [B, M]
    gtl: torch.Tensor                # long [B] committed length
    draft_kv: KVCache                # [L, B, M, ...]
    target_kv: KVCache               # or KVCache8 / KVCache4
    root_draft_logits: torch.Tensor  # f32 [B, vocab]
    terminal: torch.Tensor           # bool [B]

    def put(self, sub: "BatchState", idx: torch.Tensor) -> None:
        """Write the width-W state `sub` into slots `idx` (distinct), in place."""
        for name in ("tokens", "gtl", "root_draft_logits", "terminal"):
            getattr(self, name).index_copy_(0, idx, getattr(sub, name))
        self.draft_kv.put_slots(sub.draft_kv, idx)
        self.target_kv.put_slots(sub.target_kv, idx)

    def take(self, idx: torch.Tensor, out: "BatchState") -> None:
        """Slots `idx` into the width-W state `out`, in place."""
        for name in ("tokens", "gtl", "root_draft_logits", "terminal"):
            torch.index_select(getattr(self, name), 0, idx, out=getattr(out, name))
        self.draft_kv.take_slots(idx, out.draft_kv)
        self.target_kv.take_slots(idx, out.target_kv)


class BatchedSpecEngine(_SlotLoop, SpecEngine):
    """`SpecEngine` over `batch_size` independent requests (JAX
    `BatchedSpecEngine`). The single-request entry points stay as they are;
    the batched ones are `prefill_batch`, `insert_slot`, `generate_batch`,
    `generate_batch_fast`, `serve`, `serve_fast`, `serve_device` and
    `serve_auto`.

    `harvest_batch`: finished slots a `serve_device` decode wave waits for
    before it harvests and admits. `admit_width`: slots an admission chunk
    forward runs over (default min(batch, 4)). Neither changes a request's
    tokens, only the schedule."""

    _DECODE_GRAPHS = ("grow", "verify", "finalize")

    def __init__(self, *args, batch_size: int = 4, harvest_batch: int = 1,
                 admit_width: Optional[int] = None, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if harvest_batch < 1:
            raise ValueError(f"harvest_batch must be >= 1, got {harvest_batch}")
        if admit_width is not None and admit_width < 1:
            raise ValueError(f"admit_width must be >= 1, got {admit_width}")
        # The whole batch over the dp axis; this rank's slots are its share.
        self.global_batch_size = batch_size
        if self._axes is not None:
            if batch_size < self._axes.dp:
                raise ValueError(f"batch_size {batch_size} < dp = {self._axes.dp}")
            share = dp_share(batch_size, self._axes.dp, self._axes.dp_rank)
            batch_size = share.stop - share.start
        self._init_slots(batch_size)
        B, dev, M = batch_size, self.device, self.max_length
        self.harvest_batch = harvest_batch
        self.admit_width = min(B, 4) if admit_width is None else min(admit_width, B)
        self._bstate = self._new_state(B)
        self._bformat = None
        self._bdscratch = KVCache.init(self._dkv_cfg, self.tree_size,
                                       self.draft_params.embed.dtype, dev, batch=B)
        self._btscratch = KVCache.init(self._tkv_cfg, self.tree_size,
                                       self.target_params.embed.dtype, dev, batch=B)
        self._blive = torch.zeros(B, dtype=torch.bool, device=dev)
        self._bgrow_scr = [m.expand(B, -1, -1).contiguous() for m in self._grow_scr_masks]
        self._banc = self._anc.expand(B, -1, -1).contiguous()
        # serve_device's admission step: its inputs (one upload a step) and,
        # below the full width, the width-W state it gathers and scatters.
        W = self.admit_width
        self._adm = torch.zeros(W, self.prefill_chunk + 4, dtype=torch.long, device=dev)
        self._sub = None
        self.num_prefill_steps = 0
        self.serving_mode = None
        self.w8a8_choice = None

    # ------------------------------------------------------------------
    # Slot buffers
    # ------------------------------------------------------------------

    def _new_state(self, B: int, target_kv=None) -> BatchState:
        dev, M = self.device, self.max_length
        return BatchState(
            tokens=torch.zeros(B, M, dtype=torch.long, device=dev),
            gtl=torch.zeros(B, dtype=torch.long, device=dev),
            draft_kv=KVCache.init(self._dkv_cfg, M, self.draft_params.embed.dtype, dev,
                                  batch=B),
            target_kv=target_kv,
            root_draft_logits=torch.zeros(B, self.vocab, dtype=torch.float32, device=dev),
            terminal=torch.zeros(B, dtype=torch.bool, device=dev))

    def _target_cache_of(self, B: int):
        if self.kv_quant == "int4":
            return KVCache4.init(self._tkv_cfg, self.max_length, packing=self._kv4_packing,
                                 device=self.device, batch=B)
        return KV_CACHES[self.kv_quant].init(self._tkv_cfg, self.max_length,
                                             self.target_params.embed.dtype,
                                             device=self.device, batch=B)

    def _state(self) -> BatchState:
        """The slot buffers for the current cache format (the batched target
        cache is made once per format, as the single engine's)."""
        if self._bformat != self._format():
            self._bstate.target_kv = None   # free the old cache first
            self._sub = None
            self._bstate.target_kv = self._target_cache_of(self.batch_size)
            self._bformat = self._format()
        return self._bstate

    def _reset_state(self) -> BatchState:
        st = self._state()
        for t in (st.tokens, st.gtl, st.root_draft_logits, st.terminal):
            t.zero_()
        st.draft_kv.zero_()
        st.target_kv.zero_()
        return st

    def _tokens_buffer(self) -> torch.Tensor:
        return self._bstate.tokens

    def _slot_pos(self) -> torch.Tensor:
        return self._bstate.gtl

    # ------------------------------------------------------------------
    # Prefill and admission
    # ------------------------------------------------------------------

    def prefill_batch(self, prompts: Sequence[np.ndarray], seed: int = 0,
                      fused: bool = True) -> BatchState:
        """Prefill `batch_size` prompts into the slot buffers, slot i seeded
        `seed + i`. `fused` (default): every chunk is one batched forward of
        all slots (one weight stream per chunk), mixed lengths padded to the
        longest (rows past a slot's prompt are garbage at rows >= its
        committed length, rewritten before they are read, as in JAX);
        otherwise the single-request prefill slot by slot."""
        self._fill(prompts, seed, fused)
        return self._bstate

    def _fill(self, prompts, seed: int, fused: bool) -> None:
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        B, C, M, dev = self.batch_size, self.prefill_chunk, self.max_length, self.device
        if len(prompts) != B:
            raise ValueError(f"{len(prompts)} prompts for {B} slots")
        plens = [len(p) for p in prompts]
        if min(plens) < 1 or max(plens) + self.tree_size > M:
            raise ValueError(f"prompt lengths {plens} do not fit max_length {M} with a "
                             f"{self.tree_size}-node tree")
        if not fused:
            st = self._state()
            for i, p in enumerate(prompts):
                self._insert(p, i, seed + i)
            return
        st = self._reset_state()
        for i, g in enumerate(self._gens):
            g.manual_seed(int(seed) + i)
        width = min(_round_up(max(plens), C), M)
        toks = np.zeros((B, width), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        toks = torch.as_tensor(toks, device=dev)
        k_idx = torch.arange(M, device=dev)
        for off, c in prefill_chunks(max(plens), C, M):
            chunk = toks[:, off:off + c]
            positions = (off + torch.arange(c, device=dev)).expand(B, c)
            mask = (k_idx[None, None, :] <= positions[:, :, None])
            offs = torch.full((B,), off, dtype=torch.long, device=dev)
            d_logits, _ = forward_batched(self.draft_params, self.draft_cfg, chunk, positions,
                                          st.draft_kv, offs, mask, tp=self._dtp)
            forward_batched(self.target_params, self.target_cfg, chunk, positions,
                            st.target_kv, offs, mask, tp=self._ttp)
            for b, plen in enumerate(plens):
                if 0 <= plen - 1 - off < c:
                    st.root_draft_logits[b].copy_(d_logits[b, plen - 1 - off])
            st.tokens[:, off:off + c] = chunk
        st.gtl.copy_(torch.as_tensor(plens, device=dev))

    def insert_slot(self, bstate: BatchState, prompt: np.ndarray, slot: int,
                    seed: int = 0) -> BatchState:
        """Continuous batching's admit: the single-request prefill of
        `prompt`, copied into `slot` (JAX `insert_slot`); the slot's
        generator is reseeded with `seed`."""
        self._insert(prompt, slot, seed)
        return bstate

    def _insert(self, prompt, slot: int, seed: int) -> None:
        st = self._state()
        one = self.prefill(prompt, seed=seed)
        st.tokens[slot].copy_(one.tokens)
        st.gtl[slot] = int(np.asarray(prompt).size)
        st.draft_kv.copy_slot(slot, one.draft_kv)
        st.target_kv.copy_slot(slot, one.target_kv)
        st.root_draft_logits[slot].copy_(one.root_draft_logits)
        st.terminal[slot] = False
        self._bproduced[slot] = 0
        self._gens[slot].manual_seed(int(seed))

    # ------------------------------------------------------------------
    # One batched iteration: grow, verify, finalize
    # ------------------------------------------------------------------

    def _slot_finished(self) -> torch.Tensor:
        """Slots whose loop is over (JAX `_slot_finished`; the active mask
        aside): terminal, over the budget, or the next tree would pass the
        limit."""
        st, lim = self._bstate, self._blimit
        fits = (st.gtl - 1 + self.tree_size <= lim) & (st.gtl + self.max_depth + 1 <= lim)
        return st.terminal | (self._bproduced >= self._bbudget) | ~fits

    def _bgrow(self, st: BatchState):
        """Draft growth of every slot (`SpecEngine._grow` with a slot axis);
        the slots' liveness for this iteration is fixed here."""
        self._blive.copy_(self._bactive & ~self._slot_finished())
        B, dev, size, V = self.batch_size, self.device, self.tree_size, self.vocab
        ts = (st.gtl - 1).clamp_min(0)
        draft_logits = torch.zeros(B, size, V, dtype=torch.float32, device=dev)
        draft_logits[:, 0] = st.root_draft_logits
        tokens_tree = torch.zeros(B, size, dtype=torch.long, device=dev)
        tokens_tree[:, :1] = st.tokens.gather(1, ts[:, None])
        g_all = None
        if self.algorithm == "sequoia" and self.growmap.num_grow_steps > 0:
            total_rows = sum(len(r) for r in self.growmap.roots)
            g_all = gumbel_from_uniform(_uniform(self._gens, (total_rows, V), dev))
        row_off = 0
        k_idx = self._k_idx
        for lvl in range(self.growmap.num_grow_steps):
            w, start = self._level_widths[lvl], self._level_starts[lvl]
            nr, max_k = len(self.growmap.roots[lvl]), self._level_max_k[lvl]
            roots = draft_logits.index_select(1, self._level_roots[lvl])
            if self.algorithm == "sequoia":
                samples = wor_from_gumbel(roots, g_all[:, row_off:row_off + nr],
                                          self.temperature, max_k)
                row_off += nr
            elif self.algorithm == "specinfer":
                g = gumbel_from_uniform(_uniform(self._gens, (nr, max_k, V), dev))
                samples = with_replacement_from_gumbel(roots, g, self.temperature)
            else:
                samples = sample_argmax(roots, max_k)
            new_tokens = samples.reshape(B, -1)[:, self._level_gather[lvl]]
            tokens_tree[:, start:start + w] = new_tokens
            positions = ts[:, None] + self._depth[start:start + w]
            main = (k_idx[None, None, :] <= ts[:, None, None]).expand(B, w, -1)
            lvl_logits, _ = forward_batched(
                self.draft_params, self.draft_cfg, new_tokens, positions, st.draft_kv,
                ts + start, main, scratch=self._bdscratch, scratch_offset=start,
                scratch_mask=self._bgrow_scr[lvl], tp=self._dtp)
            draft_logits[:, start:start + w] = lvl_logits
        return tokens_tree, draft_logits

    def _bverify(self, st: BatchState, tokens_tree: torch.Tensor) -> torch.Tensor:
        """Target forward over every slot's tree (`SpecEngine._verify`)."""
        B, size = self.batch_size, self.tree_size
        ts = (st.gtl - 1).clamp_min(0)
        main = (self._k_idx[None, None, :] < ts[:, None, None]).expand(B, size, -1)
        logits, _ = forward_batched(
            self.target_params, self.target_cfg, tokens_tree, ts[:, None] + self._depth,
            st.target_kv, ts, main, scratch=self._btscratch, scratch_offset=0,
            scratch_mask=self._banc, tp=self._ttp)
        return logits

    def _bwalk(self, tokens_tree, draft_logits, target_logits, r):
        """The stochastic accept walk of `self.walk` of every slot: the
        top-p kernels run once on all slots' rows, the walk itself under
        `torch.func.vmap`. Returns the paths and the bonus distributions."""
        T, md, B = self.temperature, self._md, self.batch_size
        is_sequoia = self.algorithm == "sequoia"
        if self.walk == "staged":
            p = target_probs(target_logits, self.top_p, T)

            def staged(p, dl, tt, r):
                accepted = stochastic_accept_decisions(
                    p, dl, tt, r, self._staged, T, strict=is_sequoia,
                    mask_rejected_draft=is_sequoia)
                path = resolve_path(accepted, tt, self._stop, md)
                children = at_index(self._succ, path.final_node)
                res = node_residual(at_index(p, path.final_node),
                                    draft_probs(at_index(dl, path.final_node), T),
                                    tt[children.clamp_min(0)], children >= 0,
                                    mask_rejected_draft=is_sequoia)
                return path, res

            return torch.func.vmap(staged)(p, draft_logits, tokens_tree, r)
        cut = nucleus_cutoff(target_logits.reshape(B * self.tree_size, -1), self.top_p,
                             T).reshape(B, self.tree_size)
        if self.walk == "node":
            walk = partial(stochastic_path_walk_node, ranks=self._walk_ranks)
        elif self.walk == "path":
            walk = partial(stochastic_path_walk, trips=self._edge_trips)
        else:
            walk = stochastic_path_walk_unrolled

        def one(tl, dl, tt, r, c):
            w = walk(tl, dl, tt, r, self._succ, T, c, self._stop, md, is_sequoia, is_sequoia)
            return PathResult(w.path, w.accept_count, w.final_node, w.terminal), w.p_final_row

        return torch.func.vmap(one)(target_logits, draft_logits, tokens_tree, r, cut)

    def _bfinalize(self, st: BatchState, tokens_tree, draft_logits,
                   target_logits) -> StepStats:
        """Accept walk, bonus, commit and re-draft of every slot
        (`SpecEngine._finalize_counted` with a slot axis), counting the
        live slots' tokens and the iteration."""
        B, dev, md, M, V = self.batch_size, self.device, self._md, self.max_length, self.vocab
        live = self._blive
        gtl = st.gtl
        ts = (gtl - 1).clamp_min(0)
        if self.algorithm in ("sequoia", "specinfer"):
            r = _uniform(self._gens, (self.tree_size,), dev)
            path, res = self._bwalk(tokens_tree, draft_logits, target_logits, r)
            bonus = categorical_from_gumbel(
                res, gumbel_from_uniform(_uniform(self._gens, (V,), dev)))
            terminal = path.terminal | torch.isnan(res).any(dim=-1)
        else:
            if self.algorithm == "greedy":
                verify_tok = target_logits.argmax(dim=-1)
            else:  # greedys
                p = target_probs(target_logits, self.top_p, self.temperature)
                verify_tok = categorical_from_gumbel(
                    p, gumbel_from_uniform(_uniform(self._gens, (self.tree_size, V), dev)))

            def match(tok, tt):
                acc = token_match_accept(tok, tt, self._succ)
                return resolve_path(acc.accepted_child, tt, self._stop, md)

            path = torch.func.vmap(match)(verify_tok, tokens_tree)
            bonus = verify_tok.gather(1, path.final_node[:, None])[:, 0]
            terminal = path.terminal
        has_bonus = ~terminal
        terminal = terminal | (has_bonus & (bonus[:, None] == self._stop).any(dim=-1))
        count = path.accept_count
        emitted = (count + has_bonus.long()) * live.long()
        dead = (~live).long()

        # Commit accepted tokens + bonus at [gtl, gtl + md + 1) of live slots.
        path_c = path.path.clamp_min(0)
        ar = torch.arange(md + 1, device=dev)
        block = torch.cat([tokens_tree.gather(1, path_c),
                           torch.zeros(B, 1, dtype=torch.long, device=dev)], dim=1)
        block = torch.where(ar < count[:, None], block, torch.zeros_like(block))
        block = torch.where((ar == count[:, None]) & has_bonus[:, None], bonus[:, None], block)
        _put(st.tokens, gtl[:, None] + ar, block, live)

        # K/V commit, scratch rows -> main caches (as the single engine).
        zero1 = torch.zeros(B, 1, dtype=torch.long, device=dev)
        st.target_kv.commit_rows(self._btscratch, torch.cat([zero1, path_c], dim=1), ts + dead)
        st.draft_kv.commit_rows(self._bdscratch, path_c, gtl)

        new_gtl = gtl + emitted
        new_ts = (new_gtl - 1).clamp_min(0)
        slot = new_ts + dead
        root_logits, _ = forward_batched(
            self.draft_params, self.draft_cfg, st.tokens.gather(1, new_ts[:, None]),
            new_ts[:, None], st.draft_kv, slot,
            self._k_idx[None, None, :] <= slot[:, None, None], tp=self._dtp)
        first = path.path[:, 0]
        first_rank = torch.where(first >= 0, self._child_rank[first.clamp_min(0)],
                                 torch.full_like(first, -1))
        st.root_draft_logits.copy_(torch.where(live[:, None], root_logits[:, 0],
                                               st.root_draft_logits))
        st.terminal.copy_(st.terminal | (live & terminal))
        st.gtl.copy_(new_gtl)
        self._bproduced.add_(emitted)
        self._bsteps.add_(live.any().long())
        return StepStats(emitted=emitted, terminal=st.terminal, first_rank=first_rank)

    def iterate_batch(self, bstate: BatchState) -> StepStats:
        """One predicated batched iteration, launched eagerly (the counters
        of the last `_arm_slots` decide which slots are live)."""
        tt, dl = self._bgrow(bstate)
        return self._bfinalize(bstate, tt, dl, self._bverify(bstate, tt))

    def _iteration(self) -> None:
        self.iterate_batch(self._bstate)

    def _block_len(self, live, prod, pos) -> int:
        """Iterations in the next block: as many as the live slot that could
        run longest may still need (an iteration commits 1 to max_depth + 1
        tokens, and the next tree must fit the limit), at most
        BLOCK_ITERATIONS; a block that outlasts every slot replays no-ops."""
        step = self.max_depth + 1
        last = min(self._limit + 1 - self.tree_size, self._limit - step)
        need = [min(1 + (last - pos[b]) // step, -(-(self._budget_host - prod[b]) // step))
                for b in live]
        return max(1, min(max(need), BLOCK_ITERATIONS))

    # ------------------------------------------------------------------
    # CUDA graphs
    # ------------------------------------------------------------------

    def _ensure_slot_graphs(self, admit: bool = False) -> None:
        """Capture grow, verify and finalize over the slot buffers for the
        current cache format and routes (and with `admit`, serve_device's
        admission step, added to them once), each after a warm-up that
        writes nothing a slot reads: an iteration with no live slot, an
        admission step with no valid entry (its rows go to the tail zone,
        which only serve_device reserves). On the card only."""
        g = self._bgraphs
        if g is None:
            return
        st = self._state()

        def capture(g):
            self._graph_collectives(g)
            active = self._bactive.clone()
            self._bactive.zero_()
            try:
                with g.warmup():
                    self.iterate_batch(st)
            finally:
                self._bactive.copy_(active)
            tt, dl = g.capture("grow", lambda: self._bgrow(st))
            tl = g.capture("verify", lambda: self._bverify(st, tt))
            g.capture("finalize", lambda: self._bfinalize(st, tt, dl, tl))

        g.ensure(self._format() + w8a8_setting(), capture)
        if admit and "admit" not in g.graphs:
            self._adm.zero_()
            self._adm[:, self.prefill_chunk] = self.max_length - self.prefill_chunk
            self._adm[:, -1] = torch.arange(self.admit_width, device=self.device)
            try:
                with g.warmup():
                    self._admit_step(st)
                g.capture("admit", lambda: self._admit_step(st))
            except BaseException:
                g.reset(None)
                raise

    def graph_report(self) -> dict:
        """{phase: capture seconds, replays, launches per replay} of the
        batched graphs (empty on the CPU or before the first capture)."""
        return self._bgraphs.report() if self._bgraphs is not None else {}

    # ------------------------------------------------------------------
    # Loops
    # ------------------------------------------------------------------

    def _over_dp(self, prompts, seed: int, run) -> List[np.ndarray]:
        """`run(prompts, seed)` on this dp rank's contiguous share of the
        prompts, seeded from the share's first index (request i keeps seed
        `seed + i`), and the outputs of every dp rank gathered in input order;
        the step counters summed (tokens) and maxed (iterations) over the
        ranks. Without a dp axis, `run` on every prompt."""
        prompts = list(prompts)
        if self._axes is None or self._axes.dp == 1:
            return run(prompts, seed)
        share = dp_share(len(prompts), self._axes.dp, self._axes.dp_rank)
        local, counts = [], (0, 0)
        if share.stop > share.start:
            local = run(prompts[share], seed + share.start)
            counts = (self.num_decoding_steps, self.num_large_model_steps)
        parts = [None] * self._axes.dp
        dist.all_gather_object(parts, (local, counts), group=self._axes.dp_group)
        self.num_decoding_steps = sum(c[0] for _, c in parts)
        self.num_large_model_steps = max(c[1] for _, c in parts)
        return [out for part, _ in parts for out in part]

    def generate_batch(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 128,
                       seed: int = 0) -> List[np.ndarray]:
        """Decode a fixed batch (`batch_size` prompts, over every dp rank)
        to completion, one eager iteration and one host read at a time; one
        committed sequence (prompt + generated) per slot."""
        return self._over_dp(prompts, seed, lambda p, s: self._generate_slots(
            p, max_new_tokens, s, eager=True))

    def generate_batch_fast(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 128,
                            seed: int = 0) -> List[np.ndarray]:
        """`generate_batch` with the loop on the device: blocks of replayed
        iterations, one host read a block."""
        return self._over_dp(prompts, seed, lambda p, s: self._generate_slots(
            p, max_new_tokens, s, eager=False))

    def serve(self, prompts: Iterable[np.ndarray], max_new_tokens: int = 128,
              seed: int = 0) -> List[np.ndarray]:
        """Continuous batching over a prompt queue, the host reading after
        every eager iteration; slots are filled by the single-request
        prefill. Request i is seeded `seed + i`. Outputs in input order."""
        return self._over_dp(prompts, seed, lambda p, s: self._serve_slots(
            p, max_new_tokens, s, eager=True, fused=False))

    def serve_fast(self, prompts: Iterable[np.ndarray], max_new_tokens: int = 128,
                   seed: int = 0) -> List[np.ndarray]:
        """`serve` with the decode loop on the device (blocks of replays until
        a slot finishes) and a fused first fill. The same outputs."""
        return self._over_dp(prompts, seed, lambda p, s: self._serve_slots(
            p, max_new_tokens, s, eager=False))

    def serve_auto(self, prompts: Iterable[np.ndarray], *, spec_iter_s: float,
                   ar_step_s: float, expected_accepted: float,
                   ar_engine: Optional["BatchedAREngine"] = None,
                   max_new_tokens: int = 128, seed: int = 0,
                   spec_iter_s_w8a8: Optional[float] = None,
                   w8a8_accept_delta: Optional[float] = None) -> List[np.ndarray]:
        """Continuous batching with the AR-crossover policy (JAX
        `serve_auto`): speculation when E[accept] / spec_iter > 1 / ar_step
        (`choose_serving_mode`), else batched AR (`ar_engine`, or one made
        from this engine's target). With `spec_iter_s_w8a8` the w8a8 switch
        is set by predicted tokens per second (`quant/eroute.py`), and the
        chosen precision's (E, t) decide the mode. Speculation runs
        `serve_device` when every prompt clears its tail reserve
        (`max_length - prefill_chunk - tree_size`), else `serve_fast`."""
        self.w8a8_choice = None
        if spec_iter_s_w8a8 is not None:
            from ..quant.eroute import route_w8a8

            self.w8a8_choice = route_w8a8(spec_iter_s, spec_iter_s_w8a8, expected_accepted,
                                          w8a8_accept_delta)
            if self.w8a8_choice.use_w8a8:
                spec_iter_s = spec_iter_s_w8a8
                expected_accepted = self.w8a8_choice.e_w8a8
        self.serving_mode = choose_serving_mode(spec_iter_s, expected_accepted, ar_step_s)
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        if self.serving_mode == "spec":
            limit = self.max_length - self.prefill_chunk - self.tree_size
            if prompts and all(1 <= len(p) <= limit for p in prompts):
                return self.serve_device(prompts, max_new_tokens=max_new_tokens, seed=seed)
            return self.serve_fast(prompts, max_new_tokens=max_new_tokens, seed=seed)
        if self.mesh is not None:
            raise ValueError("serve_auto chose batched AR, whose engines take no mesh")
        if ar_engine is None:
            ar_engine = BatchedAREngine(
                self.target_params, self.target_cfg, batch_size=self.batch_size,
                max_length=self.max_length, temperature=self.temperature, top_p=self.top_p,
                prefill_chunk=self.prefill_chunk, kv_quant=self.kv_quant, device=self.device)
        out = ar_engine.serve_fast(prompts, max_new_tokens=max_new_tokens, seed=seed)
        self.num_decoding_steps = ar_engine.num_decoding_steps
        self.num_large_model_steps = ar_engine.num_large_model_steps
        return out

    # ------------------------------------------------------------------
    # serve_device: admission, decode and harvest as waves on the device
    # ------------------------------------------------------------------

    def _admit_step(self, st: BatchState) -> None:
        """One admission chunk step (JAX `_admit_prefill_step[_narrow]`) over
        the `admit_width` slots of `self._adm` (`[W, C + 4]`: chunk tokens,
        offset, prompt length, valid, slot). Below the full width the slots
        are gathered into the width-W state, stepped and scattered back; at
        the full width entry w is slot w, stepped in place. An invalid entry
        writes its K/V rows at the tail zone [M - C, M), which no mask of
        serve_device reads, and keeps its tokens, length and root logits."""
        C, M, V, W = self.prefill_chunk, self.max_length, self.vocab, self.admit_width
        chunk, off, plen = self._adm[:, :C], self._adm[:, C], self._adm[:, C + 1]
        valid, idx = self._adm[:, C + 2].bool(), self._adm[:, C + 3]
        sub = st
        if W < self.batch_size:
            if self._sub is None:
                self._sub = self._new_state(W, self._target_cache_of(W))
            sub = self._sub
            st.take(idx, sub)
        dev = self.device
        positions = off[:, None] + torch.arange(C, device=dev)
        mask = self._k_idx[None, None, :] <= positions[:, :, None]
        d_logits, _ = forward_batched(self.draft_params, self.draft_cfg, chunk, positions,
                                      sub.draft_kv, off, mask, tp=self._dtp)
        forward_batched(self.target_params, self.target_cfg, chunk, positions, sub.target_kv,
                        off, mask, tp=self._ttp)
        last = plen - 1 - off
        root = d_logits.gather(1, last.clamp(0, C - 1)[:, None, None].expand(W, 1, V))[:, 0]
        in_chunk = valid & (last >= 0) & (last < C)
        sub.root_draft_logits.copy_(torch.where(in_chunk[:, None], root, sub.root_draft_logits))
        _put(sub.tokens, positions, chunk, valid)
        sub.gtl.copy_(torch.where(valid, torch.minimum(off + C, plen), sub.gtl))
        if sub is not st:
            st.put(sub, idx)

    def serve_device(self, prompts: Iterable[np.ndarray], max_new_tokens: int = 128,
                     seed: int = 0) -> List[np.ndarray]:
        """`_serve_device` over the dp axis (`_over_dp`)."""
        prompts = list(prompts)
        if not prompts:
            raise ValueError("serve_device needs at least one prompt")
        with trace.span("serve"):
            return self._over_dp(prompts, seed, lambda p, s: self._serve_device(
                p, max_new_tokens, s))

    def _serve_device(self, prompts: Iterable[np.ndarray], max_new_tokens: int = 128,
                      seed: int = 0) -> List[np.ndarray]:
        """Continuous batching with admission, decode, harvest and the
        admission prefill on the device (JAX `serve_device`, one XLA
        program there), as waves of replayed graphs: admission chunk steps
        until every admitted slot is prefilled, decode blocks until
        `harvest_batch` active slots (all, once the queue is empty) have
        finished, then the harvest (each finished slot's tokens copied into
        its request's output row) and the admission of the next requests.
        Request i is seeded `seed + i`.

        The tail `prefill_chunk` rows `[M - C, M)` are the scratch zone of
        the admission steps' invalid entries, so a request finishes once its
        next tree would pass `M - C`: up to `prefill_chunk` tokens earlier
        than in `serve_fast` near the buffer's end."""
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        n_q = len(prompts)
        if n_q < 1:
            raise ValueError("serve_device needs at least one prompt")
        B, C, M, W, dev = (self.batch_size, self.prefill_chunk, self.max_length,
                           self.admit_width, self.device)
        limit = M - C
        for p in prompts:
            if len(p) < 1 or len(p) + self.tree_size > limit:
                raise ValueError(f"prompt length {len(p)}: serve_device needs 1 <= length "
                                 f"<= {limit - self.tree_size} (the tail {C} rows are the "
                                 f"admission steps' scratch zone)")
        st = self._reset_state()
        slot_req = [-1] * B
        prefilling, ppos = [False] * B, [0] * B
        for s in range(min(B, n_q)):
            slot_req[s], prefilling[s] = s, True
            self._gens[s].manual_seed(int(seed) + s)
        next_q = min(B, n_q)
        self._arm_slots(max_new_tokens, limit, [False] * B)
        self._ensure_slot_graphs(admit=True)
        out_tokens = torch.zeros(n_q, M, dtype=torch.long, device=dev)
        out_prod = [0] * n_q
        pf_steps, steps = 0, 0
        while any(r >= 0 for r in slot_req):
            # 1. Admission: chunk steps over at most W prefilling slots.
            while True:
                need = [s for s in range(B) if prefilling[s] and slot_req[s] >= 0]
                if not need:
                    break
                stepping = need if W >= B else need[:W]
                entries = list(range(B)) if W >= B else (
                    stepping + [s for s in range(B) if s not in stepping][:W - len(stepping)])
                with trace.span("admit.plan"):
                    adm = np.zeros((W, C + 4), np.int64)
                    for w, s in enumerate(entries):
                        adm[w, C + 3] = s
                        if s in stepping:
                            p = prompts[slot_req[s]]
                            piece = p[ppos[s]:ppos[s] + C]
                            adm[w, :len(piece)] = piece
                            adm[w, C], adm[w, C + 1], adm[w, C + 2] = ppos[s], len(p), 1
                        else:
                            adm[w, C], adm[w, C + 1] = M - C, -1
                    self._adm.copy_(torch.from_numpy(adm))
                if self._bgraphs is None:
                    self._admit_step(st)
                else:
                    self._bgraphs.replay("admit")
                pf_steps += 1
                trace.count("admit_entries", W)
                trace.count("admit_valid", len(stepping))
                for s in stepping:
                    ppos[s] += C
                    prefilling[s] = ppos[s] < len(prompts[slot_req[s]])
            # 2. Decode until `harvest_batch` active slots have finished.
            self._set_active([r >= 0 for r in slot_req])
            n_active = sum(self._active)
            until = n_active if next_q >= n_q else min(self.harvest_batch, n_active)
            fin, prod, steps = self._run_slots(until, eager=False)
            # 3. Harvest and admit, on the device, in slot order (JAX's rank).
            with trace.span("harvest"):
                done = [s for s in range(B) if self._active[s] and fin[s]]
                out_tokens.index_copy_(
                    0, torch.as_tensor([slot_req[s] for s in done], dtype=torch.long, device=dev),
                    st.tokens.index_select(0, torch.as_tensor(done, dtype=torch.long, device=dev)))
                admitted = []
                for s in done:
                    out_prod[slot_req[s]] = min(prod[s], max_new_tokens)
                    if next_q < n_q:
                        slot_req[s], prefilling[s], ppos[s] = next_q, True, 0
                        self._gens[s].manual_seed(int(seed) + next_q)
                        admitted.append(s)
                        next_q += 1
                    else:
                        slot_req[s] = -1
                if admitted:
                    new = torch.as_tensor(admitted, dtype=torch.long, device=dev)
                    for t in (st.gtl, self._bproduced):
                        t.index_fill_(0, new, 0)
                    st.terminal.index_fill_(0, new, False)
        tokens = out_tokens.cpu().numpy()
        self.num_large_model_steps = steps
        self.num_prefill_steps = pf_steps
        self.num_decoding_steps = sum(out_prod)
        return [tokens[i, :len(p) + out_prod[i]].astype(np.int32) for i, p in enumerate(prompts)]


class BatchedAREngine(_SlotLoop, ARBaseline):
    """Batched autoregressive decoding (JAX `BatchedAREngine`): the honest
    baseline of batched speculation and `serve_auto`'s engine past the AR
    crossover. One predicated step of every slot is captured as one CUDA
    graph; a slot finishes at a stop token, its budget or a full buffer."""

    _DECODE_GRAPHS = ("step",)

    def __init__(self, *args, batch_size: int = 4, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._init_slots(batch_size)
        B, dev, M = batch_size, self.device, self.max_length
        dtype = self.params.embed.dtype
        self._btokens = torch.zeros(B, M, dtype=torch.long, device=dev)
        self._bn = torch.zeros(B, dtype=torch.long, device=dev)
        self._bkv = KV_CACHES[self.kv_quant].init(self.cfg, M, dtype, device=dev, batch=B)
        self._blast = torch.zeros(B, self.cfg.vocab_size, dtype=torch.float32, device=dev)
        self._bterminal = torch.zeros(B, dtype=torch.bool, device=dev)
        self._bscratch = KVCache.init(self.cfg, 1, dtype, dev, batch=B)
        self._bscr_mask = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
        self._bzero = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.num_decoding_steps = 0
        self.num_large_model_steps = 0

    def _tokens_buffer(self) -> torch.Tensor:
        return self._btokens

    def _slot_pos(self) -> torch.Tensor:
        return self._bn

    def _slot_finished(self) -> torch.Tensor:
        return self._bterminal | (self._bproduced >= self._bbudget) | (self._bn >= self._blimit)

    def _fill(self, prompts, seed: int, fused: bool = False) -> None:
        """Per-slot prefill, slot i seeded `seed + i` (JAX prefills slot by
        slot too)."""
        if len(prompts) != self.batch_size:
            raise ValueError(f"{len(prompts)} prompts for {self.batch_size} slots")
        for i, p in enumerate(prompts):
            self._insert(p, i, seed + i)

    def _insert(self, prompt, slot: int, seed: int) -> None:
        one = self.prefill(prompt, seed)
        self._btokens[slot].copy_(one.tokens)
        self._bn[slot] = int(np.asarray(prompt).size)
        self._bkv.copy_slot(slot, one.kv)
        self._blast[slot].copy_(one.last_logits)
        self._bterminal[slot] = False
        self._bproduced[slot] = 0
        self._gens[slot].manual_seed(int(seed))

    def _bstep(self) -> None:
        """One predicated step of every slot (`ARBaseline._step_counted` with
        a slot axis): sample, a split-mode forward of the B tokens, commit."""
        dev = self.device
        live = self._bactive & ~self._slot_finished()
        n = self._bn
        if self.greedy:
            token = self._blast.argmax(dim=-1)
        else:
            p = target_probs(self._blast, self.top_p, self.temperature)
            token = categorical_from_gumbel(
                p, gumbel_from_uniform(_uniform(self._gens, (self.cfg.vocab_size,), dev)))
        _put(self._btokens, n[:, None], token[:, None], live)
        mask = self._k_idx[None, None, :] < n[:, None, None]
        logits, scr = forward_batched(
            self.params, self.cfg, token[:, None], n[:, None], self._bkv, n, mask,
            scratch=self._bscratch, scratch_offset=0, scratch_mask=self._bscr_mask)
        self._bkv.commit_rows(scr, self._bzero, n)
        self._blast.copy_(torch.where(live[:, None], logits[:, 0], self._blast))
        self._bterminal.copy_(self._bterminal
                              | (live & (token[:, None] == self._stop).any(dim=-1)))
        self._bn.add_(live.long())
        self._bproduced.add_(live.long())
        self._bsteps.add_(live.any().long())

    def _iteration(self) -> None:
        self._bstep()

    def _block_len(self, live, prod, pos) -> int:
        need = [min(self._budget_host - prod[b], self._limit - pos[b]) for b in live]
        return max(1, min(max(need), BLOCK_STEPS))

    def _ensure_slot_graphs(self) -> None:
        """Capture the batched step (after a warm-up step with no live
        slot) for the current matmul routes. On the card only."""
        if self._bgraphs is None:
            return

        def capture(g):
            active = self._bactive.clone()
            self._bactive.zero_()
            try:
                with g.warmup():
                    self._bstep()
            finally:
                self._bactive.copy_(active)
            g.capture("step", self._bstep)

        self._bgraphs.ensure(w8a8_setting(), capture)

    def graph_report(self) -> dict:
        return self._bgraphs.report() if self._bgraphs is not None else {}

    def generate_batch_fast(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 128,
                            seed: int = 0) -> List[np.ndarray]:
        """Decode `batch_size` prompts to completion, blocks of replayed
        steps, one host read a block."""
        return self._generate_slots(prompts, max_new_tokens, seed, eager=False)

    def serve_fast(self, prompts: Iterable[np.ndarray], max_new_tokens: int = 128,
                   seed: int = 0) -> List[np.ndarray]:
        """Continuous batching, AR mode (JAX `BatchedAREngine.serve_fast`).
        Request i is seeded `seed + i`. Outputs in input order."""
        return self._serve_slots(prompts, max_new_tokens, seed, eager=False)
