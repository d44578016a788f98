"""Speculative-decoding engine: growmap-driven tree growth, one-pass tree
verification, and the device-side accept walk.

Port of `sequoia_tpu/engine/engine.py::SpecEngine` (all four algorithms,
and the four accept walks of the stochastic ones). One iteration = draft
growth level by level into a tree scratch, one target forward over the
whole tree, the accept walk, the commit of tokens and target K/V rows, and
a causal draft re-draft of the committed block. Nothing inside an
iteration reads a value back to the host: offsets are device tensors, and
every lookup at a device index is an `index_select` (a 0-d tensor index
would be a host read). The state lives in buffers the engine allocates
once (`prefill` resets and reuses them), so the three phases capture into
CUDA graphs (`engine/graphs.py`).

Two kinds of loop, as in JAX:
- `generate`, `stream`, `generate_benchmark`: the host reads the emitted
  count and the terminal flag after every iteration (`generate_benchmark`
  through `iterate_phased`, which on the card replays the three phase
  graphs with CUDA events between them);
- `generate_fast`, `stream_fast`: JAX runs its `lax.while_loop` on the
  device; here the host replays blocks of k iterations and reads
  `(produced, steps, terminal)` once per block. k is chosen on the host so
  that k iterations of `max_depth + 1` tokens each still fit the buffer and
  cannot pass the budget; an iteration after a stop token, or past the
  budget, is a predicated no-op on the device (nothing emitted, the counters
  and `gtl` unchanged, writes only at slots >= `gtl`). On the CPU the same
  blocks run eagerly.

Spans (`trace.py`; recorded only while tracing, and no host read or sync
of their own): `request` over a `*_fast` call, `prefill` (with device
time; the counter `prefill_tokens` its prompt tokens), `loop` a device
loop, `block` its iterations (the counter `draft_forwards` the draft
forwards they run, as `iterate` and `iterate_phased` count theirs),
`host_read` its one read a block, `chunk_out` a chunk's copy to the host;
`GraphSet.replay` adds `replay.<phase>` (device time, no profiler markers).

Slot/step invariants (identical to the reference):
- committed tokens occupy slots `[0, gtl)`; tree node i sits at slot
  `ts + i`, `ts = gtl - 1` (root = last committed token);
- the target verify forward has width `tree_size`; its rows (the root
  included) land in a scratch, and the main caches are read-only during
  grow and verify;
- grow runs a draft forward on every level but the last, whose leaves'
  draft logits nothing reads (their rows stay 0);
- after acceptance, the accepted target rows are committed from the
  scratch, and one causal draft forward of width `max_depth + 1` over the
  committed block `[gtl, gtl + max_depth + 1)` writes the draft K/V of
  every accepted node and of the bonus into the main cache and seeds the
  next root's logits; its padding rows land at slots >= the new committed
  length.

Tensor parallelism (`mesh=`, a (dp, tp) `DeviceMesh` of
`parallel/sharding.py::make_mesh`), as in JAX: the caller passes the
target's shard (`shard_params`) and, with `shard_draft`, the draft's; the
engine makes each sharded model's caches with this rank's `Hkv/tp` KV
heads and runs its forwards on the mesh's tp group. The forward gathers the
logits, so every rank runs the draft, the walk and the samplers on the same
tensors with identically seeded generators and takes the same decisions.
On the card the graph entry points capture the NCCL collectives into the
same graphs; a gloo group there runs only the eager entry points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..core.config import LlamaConfig
from ..core.model import LlamaParams, OffloadLayers, forward
from ..kvcache.cache import KV_CACHES, KVCache, KVCache4
from ..parallel.collectives import all_reduce_sum
from ..parallel.sharding import (
    check_tp_divisibility,
    kv4_packing,
    mesh_axes,
    out_features,
    shard_config,
)
from ..ops import masks
from ..ops.sampling import (
    draft_probs,
    gumbel,
    nucleus_cutoff,
    sample_argmax,
    sample_categorical_probs,
    sample_with_replacement,
    target_probs,
    wor_from_gumbel,
)
from ..quant.qtensor import w8a8_setting
from ..trees.accept import (
    PathResult,
    at_index,
    edge_trips,
    node_residual,
    ranks_per_trip,
    resolve_path,
    staged_plan,
    stochastic_accept_decisions,
    stochastic_path_walk,
    stochastic_path_walk_node,
    stochastic_path_walk_unrolled,
    token_match_accept,
)
from ..trees.growmap import GrowMap
from ..utils import make_generator, resolve_device
from .baseline import prefill_chunks
from .graphs import GraphSet

ALGORITHMS = ("sequoia", "specinfer", "greedy", "greedys")
# The stochastic algorithms' accept walks (JAX `SpecEngine(walk=...)`); all
# four take the same decisions on the same draws, and differ in the work:
# "node" one trip per visited node (the default), "path" one per tested
# edge, "unrolled" every trip testing all ranks, "staged" a decision for
# every parent at once.
WALKS = ("node", "path", "unrolled", "staged")
# Most iterations a `*_fast` block replays before the host reads the
# counters. A block that a stop token ends early replays the rest of its
# iterations as no-ops, each as long as a live one; a host read costs about
# 0.13 ms at 7B on an H100 (PERF.md, chip_smoke.py's `block_costs`).
BLOCK_ITERATIONS = 2


@dataclass
class DecodeState:
    """Views of the engine's buffers; `prefill` resets them, so a new
    `prefill` ends the request of every earlier state."""
    tokens: torch.Tensor             # long [max_length] committed + live tree slots
    gtl: torch.Tensor                # long 0-d committed length (root = slot gtl-1)
    draft_kv: KVCache
    target_kv: KVCache               # or KVCache8 / KVCache4 (kv_quant)
    root_draft_logits: torch.Tensor  # f32 [vocab] draft logits at the root
    gen: torch.Generator
    terminal: torch.Tensor           # bool 0-d


class StepStats(NamedTuple):
    emitted: torch.Tensor     # long 0-d: tokens committed this iteration
    terminal: torch.Tensor    # bool 0-d
    first_rank: torch.Tensor  # long 0-d: sibling rank of the first accepted child, or -1


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
        if walk not in WALKS:
            raise ValueError(f"unknown walk {walk!r}; known: {WALKS}")
        if shard_draft and mesh is None:
            raise ValueError("shard_draft needs a mesh")
        if kv_quant not in KV_CACHES:
            raise ValueError(f"kv_quant must be one of none, int8, int4; got {kv_quant!r}")
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
        self._init_mesh(mesh, shard_draft)
        # Optional int8 / int4 target KV cache (per-row scales): the rows the
        # verify and the AR step read are a half / a quarter of the bf16
        # bytes. The draft's cache and both tree scratches stay float. The
        # int4 packing pairs heads where the pairs split over tp (Hkv even,
        # (Hkv / 2) % tp == 0), else "dsplit" (JAX's rule).
        self.kv_quant = None if kv_quant == "none" else kv_quant
        self._kv4_packing = kv4_packing(target_cfg.num_kv_heads, self.tp)
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
        # Draft forwards an iteration: each grow level but the last, and the
        # re-draft.
        self._draft_forwards = max(gm.num_grow_steps - 1, 0) + 1
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
        self._dscratch = KVCache.init(self._dkv_cfg, gm.size, draft_params.embed.dtype, dev)
        self._tscratch = KVCache.init(self._tkv_cfg, gm.size, target_params.embed.dtype, dev)
        # The request's buffers, allocated once and reset by `prefill`; the
        # target cache is made on the first prefill of each cache format.
        self._gen = make_generator(0, dev)
        self._tokens = torch.zeros(max_length, dtype=torch.long, device=dev)
        self._gtl = torch.zeros((), dtype=torch.long, device=dev)
        self._root_logits = torch.zeros(self.vocab, dtype=torch.float32, device=dev)
        self._terminal = torch.zeros((), dtype=torch.bool, device=dev)
        self._draft_kv = KVCache.init(self._dkv_cfg, max_length, draft_params.embed.dtype, dev)
        self._target_kv, self._target_format = None, None
        # The device loop's counters (JAX `_generate_loop_impl`'s carry):
        # tokens and iterations since the loop began, and its token budget.
        self._produced = torch.zeros((), dtype=torch.long, device=dev)
        self._steps = torch.zeros((), dtype=torch.long, device=dev)
        self._budget = torch.zeros((), dtype=torch.long, device=dev)
        self._always = torch.ones((), dtype=torch.bool, device=dev)
        # The walks' static trip plans, built once (a host copy inside an
        # iteration would run every iteration).
        self._walk_ranks = ranks_per_trip(self._succ_np, self._md + 1)
        self._edge_trips = edge_trips(self._succ_np, self._md)
        self._staged = staged_plan(self._succ_np, dev) if walk == "staged" else None
        # The phases' CUDA graphs; on the CPU the same phases run eagerly.
        self._graphs = GraphSet(dev, [self._gen]) if dev.type == "cuda" else None
        # Counters (reference metric: tests/testbed.py:94).
        self.num_decoding_steps = 0
        self.num_large_model_steps = 0

    def _init_mesh(self, mesh, shard_draft: bool) -> None:
        """The tp groups of the two models and the configs their caches are
        made from (this rank's KV heads where the model is sharded)."""
        self.mesh, self.shard_draft = mesh, shard_draft
        self.tp, self._axes = 1, None
        self._ttp = self._dtp = None
        self._tkv_cfg, self._dkv_cfg = self.target_cfg, self.draft_cfg
        if mesh is None:
            return
        if not hasattr(mesh, "get_group"):
            raise TypeError(f"mesh must be a (dp, tp) DeviceMesh (parallel/sharding.py::"
                            f"make_mesh), got {type(mesh).__name__}")
        self._axes = ax = mesh_axes(mesh)
        self.tp = ax.tp
        models = [("target", self.target_params, self.target_cfg)]
        if shard_draft:
            models.append(("draft", self.draft_params, self.draft_cfg))
        for name, p, cfg in models:
            check_tp_divisibility(cfg, ax.tp)
            if isinstance(p.layers, OffloadLayers):
                raise ValueError(f"{name}: host-offloaded params are the single-card path; "
                                 "tensor parallelism takes device-resident params")
            kv_cols = cfg.num_kv_heads * cfg.head_dim_ // ax.tp
            if out_features(p.layers.wk) != kv_cols:
                raise ValueError(f"{name} params are not this rank's tp={ax.tp} shard "
                                 "(parallel/sharding.py::shard_params)")
        self._ttp = ax.tp_group
        self._tkv_cfg = shard_config(self.target_cfg, ax.tp)
        if shard_draft:
            self._dtp = ax.tp_group
            self._dkv_cfg = shard_config(self.draft_cfg, ax.tp)

    def _graph_collectives(self, graphs: GraphSet) -> None:
        """Before `graphs` capture under a mesh: the tp collectives must be
        NCCL's (a gloo collective cannot be captured), and one eager
        collective creates NCCL's communicator outside the capture."""
        if self._ttp is None:
            return
        backend = dist.get_backend(self._ttp)
        if backend != "nccl":
            raise RuntimeError(
                f"the CUDA-graph entry points capture the tp collectives, which needs "
                f"an NCCL group; this mesh's tp group is {backend}: use the eager "
                "entry points (generate, stream, generate_batch, serve) instead")
        all_reduce_sum(torch.zeros(1, device=self.device), self._ttp)
        torch.cuda.synchronize(self.device)
        graphs.error_mode = "thread_local"

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------

    def _format(self):
        return (self.kv_quant, self._kv4_packing if self.kv_quant == "int4" else None)

    def _target_cache(self):
        """The target's main cache for the current format, made once per
        format (`_kv4_packing` may change between requests)."""
        if self._target_format != self._format():
            self._target_kv = None   # free the old cache first
            if self.kv_quant == "int4":
                self._target_kv = KVCache4.init(self._tkv_cfg, self.max_length,
                                                packing=self._kv4_packing, device=self.device)
            else:
                self._target_kv = KV_CACHES[self.kv_quant].init(
                    self._tkv_cfg, self.max_length, self.target_params.embed.dtype,
                    device=self.device)
            self._target_format = self._format()
        return self._target_kv.zero_()

    def prefill(self, prompt: np.ndarray, seed: int = 0) -> DecodeState:
        """Chunked prefill of both caches. The tail chunk shrinks so no
        write passes `max_length` (`sequoia_tpu/engine/engine.py:279-284`).
        Resets and reuses the engine's buffers (and reseeds its generator
        with `seed`): the returned state replaces every earlier one."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        if plen < 1 or plen + self.tree_size > self.max_length:
            raise ValueError(f"prompt length {plen} does not fit max_length "
                             f"{self.max_length} with a {self.tree_size}-node tree")
        dev = self.device
        with trace.span("prefill", device=dev):
            trace.count("prefill_tokens", plen)
            self._gen.manual_seed(int(seed))
            state = DecodeState(
                tokens=self._tokens.zero_(), gtl=self._gtl.fill_(plen),
                draft_kv=self._draft_kv.zero_(), target_kv=self._target_cache(),
                root_draft_logits=self._root_logits.zero_(), gen=self._gen,
                terminal=self._terminal.zero_(),
            )
            self._arm(self.max_length)
            C = self.prefill_chunk
            padded = np.zeros(((plen + C - 1) // C) * C, np.int64)
            padded[:plen] = prompt
            padded = torch.as_tensor(padded, device=dev)
            for off, c in prefill_chunks(plen, C, self.max_length):
                chunk = padded[off:off + c]
                positions = off + torch.arange(c, device=dev)
                mask = masks.causal_mask(c, self.max_length, off, dev)
                d_logits, _ = forward(self.draft_params, self.draft_cfg, chunk,
                                      positions, state.draft_kv, off, mask, tp=self._dtp)
                forward(self.target_params, self.target_cfg, chunk, positions,
                        state.target_kv, off, mask, tp=self._ttp)
                if 0 <= plen - 1 - off < c:
                    state.root_draft_logits.copy_(d_logits[plen - 1 - off])
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
        """Draft growth, level by level. Each level but the last runs the
        draft on its children, for the next level's logits: their K/V rows
        go into the draft scratch (slot i = node i); the main draft cache
        stays read-only. The last level's children are leaves, whose draft
        logits no walk reads: it runs no forward and their rows stay 0
        (`_finalize`'s re-draft writes an accepted leaf's K/V). The tree
        tokens are also written into `state.tokens` at their slots (in
        place; slots past the committed prefix). Returns
        `(tokens_tree, draft_logits)`."""
        dev, size = self.device, self.tree_size
        ts = state.gtl - 1
        draft_logits = torch.zeros(size, self.vocab, dtype=torch.float32, device=dev)
        draft_logits[0] = state.root_draft_logits
        tokens_tree = torch.zeros(size, dtype=torch.long, device=dev)
        tokens_tree[:1] = state.tokens.index_select(0, ts.reshape(1))
        # One gumbel block for every level's race (sequoia).
        g_all = None
        if self.algorithm == "sequoia" and self.growmap.num_grow_steps > 0:
            total_rows = sum(len(r) for r in self.growmap.roots)
            g_all = gumbel((total_rows, self.vocab), state.gen, dev)
        row_off = 0
        main_mask_row = (self._k_idx <= ts)[None, :]
        last = self.growmap.num_grow_steps - 1
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
            if lvl == last:
                break
            positions = ts + self._depth[start:start + w]
            lvl_logits, _ = forward(
                self.draft_params, self.draft_cfg, new_tokens, positions,
                state.draft_kv, ts + start, main_mask_row.expand(w, -1),
                scratch=self._dscratch, scratch_offset=start,
                scratch_mask=self._grow_scr_masks[lvl], tp=self._dtp,
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
            scratch_offset=0, scratch_mask=self._anc, tp=self._ttp,
        )
        return logits

    def _finalize(self, state: DecodeState, tokens_tree, draft_logits,
                  target_logits, live: torch.Tensor) -> StepStats:
        """Accept walk, bonus token, commit of tokens and target scratch
        rows, and the draft's re-draft of the committed block; updates
        `state` in place.
        `live` (bool 0-d) false makes the iteration a no-op: nothing is
        emitted, `gtl`, the root logits and `terminal` keep their values, and
        every write lands at slots >= `gtl`."""
        dev, md = self.device, self._md
        gtl = state.gtl
        ts = gtl - 1
        stochastic = self.algorithm in ("sequoia", "specinfer")
        if stochastic:
            r = torch.rand(self.tree_size, generator=state.gen, device=dev)
            path, res = self._walk(tokens_tree, draft_logits, target_logits, r)
            bonus = sample_categorical_probs(state.gen, res)
            terminal = path.terminal | torch.isnan(res).any()
        else:
            if self.algorithm == "greedy":
                verify_tok = target_logits.argmax(dim=-1)
            else:  # greedys
                p = target_probs(target_logits, self.top_p, self.temperature)
                verify_tok = sample_categorical_probs(state.gen, p)
            acc = token_match_accept(verify_tok, tokens_tree, self._succ)
            path = resolve_path(acc.accepted_child, tokens_tree, self._stop, md)
            bonus = at_index(acc.target_token, path.final_node)
            terminal = path.terminal
        has_bonus = ~terminal
        # A stop token emitted as the bonus also terminates.
        terminal = terminal | (has_bonus & (bonus == self._stop).any())
        count = path.accept_count
        emitted = (count + has_bonus.long()) * live.long()
        dead = (~live).long()

        # Commit accepted tokens + bonus at [gtl, gtl + md + 1).
        path_c = path.path.clamp_min(0)
        ar = torch.arange(md + 1, device=dev)
        block = torch.cat([tokens_tree[path_c], torch.zeros(1, dtype=torch.long, device=dev)])
        block = torch.where(ar < count, block, torch.zeros_like(block))
        block = torch.where((ar == count) & has_bonus, bonus, block)
        state.tokens.index_copy_(0, gtl + ar, block)

        # Target K/V commit, scratch rows -> main cache, in place: fresh
        # rows for the root and every accepted node go to [ts, ts+1+md)
        # (a no-op iteration writes them one slot later, from gtl on).
        zero1 = torch.zeros(1, dtype=torch.long, device=dev)
        state.target_kv.commit_rows(self._tscratch, torch.cat([zero1, path_c]), ts + dead)

        # Draft re-draft: one causal forward over the committed block writes
        # the K/V of every accepted node and of the bonus at [gtl, gtl+md+1)
        # (the root's is in main from the last re-draft); the next root's
        # logits are the last committed token's row. Padding rows land at
        # slots >= the new committed length and are rewritten before they
        # are ever read; an iteration that commits nothing keeps the old
        # root logits.
        pos = gtl + ar
        redraft_logits, _ = forward(
            self.draft_params, self.draft_cfg, block, pos, state.draft_kv, gtl,
            self._k_idx[None, :] <= pos[:, None], tp=self._dtp,
        )
        root_logits = at_index(redraft_logits, (emitted - 1).clamp_min(0))
        first = path.path[0]
        first_rank = torch.where(first >= 0, at_index(self._child_rank, first.clamp_min(0)),
                                 torch.full_like(first, -1))
        state.root_draft_logits.copy_(torch.where(emitted > 0, root_logits,
                                                  state.root_draft_logits))
        state.terminal.copy_(state.terminal | (live & terminal))
        state.gtl.copy_(gtl + emitted)
        return StepStats(emitted=emitted, terminal=state.terminal, first_rank=first_rank)

    def _walk(self, tokens_tree, draft_logits, target_logits, r):
        """The stochastic accept walk of `self.walk` (JAX `_finalize_impl`):
        returns the path and the bonus distribution at its final node."""
        T, md = self.temperature, self._md
        is_sequoia = self.algorithm == "sequoia"
        if self.walk == "staged":
            # Decisions for every parent, the path, then the residual
            # replayed at the path's final node for the bonus.
            p = target_probs(target_logits, self.top_p, T)
            accepted = stochastic_accept_decisions(
                p, draft_logits, tokens_tree, r, self._staged, T,
                strict=is_sequoia, mask_rejected_draft=is_sequoia)
            path = resolve_path(accepted, tokens_tree, self._stop, md)
            fn = path.final_node
            children = at_index(self._succ, fn)
            res = node_residual(at_index(p, fn), draft_probs(at_index(draft_logits, fn), T),
                                tokens_tree[children.clamp_min(0)], children >= 0,
                                mask_rejected_draft=is_sequoia)
            return path, res
        # The path walks: p/q rows built lazily at the visited nodes from
        # the nucleus cutoff; the final residual row is the bonus
        # distribution.
        cut = nucleus_cutoff(target_logits, self.top_p, T)
        args = (target_logits, draft_logits, tokens_tree, r, self._succ, T, cut,
                self._stop, md, is_sequoia, is_sequoia)
        if self.walk == "node":
            walk = stochastic_path_walk_node(*args, ranks=self._walk_ranks)
        elif self.walk == "path":
            walk = stochastic_path_walk(*args, trips=self._edge_trips)
        else:
            walk = stochastic_path_walk_unrolled(*args)
        return PathResult(walk.path, walk.accept_count, walk.final_node,
                          walk.terminal), walk.p_final_row

    def _finalize_counted(self, state: DecodeState, tokens_tree, draft_logits,
                          target_logits) -> StepStats:
        """`_finalize` under the device loop's predicate (JAX's `cond`:
        not terminal, under the budget, the next tree fits), counting the
        tokens and iterations it makes."""
        gtl, M = state.gtl, self.max_length
        fits = (gtl - 1 + self.tree_size <= M) & (gtl + self.max_depth + 1 <= M)
        live = ~state.terminal & (self._produced < self._budget) & fits
        stats = self._finalize(state, tokens_tree, draft_logits, target_logits, live)
        self._produced.add_(stats.emitted)
        self._steps.add_(live.long())
        return stats

    def iterate(self, state: DecodeState) -> StepStats:
        """One speculative iteration, in place on `state`, launched eagerly."""
        trace.count("draft_forwards", self._draft_forwards)
        tokens_tree, draft_logits = self._grow(state)
        target_logits = self._verify(state, tokens_tree)
        return self._finalize(state, tokens_tree, draft_logits, target_logits, self._always)

    # ------------------------------------------------------------------
    # CUDA graphs of the three phases, and the device loop's blocks
    # ------------------------------------------------------------------

    def _graph_key(self):
        return self._format() + w8a8_setting()

    def _ensure_graphs(self, state: DecodeState) -> None:
        """Capture grow, verify and finalize (the counted, predicated one)
        for the current cache format and routes, after one warm-up
        iteration that is a no-op (budget 0; its writes land at slots
        [gtl, gtl + max_depth], so the next tree must fit). On the card
        only."""
        def capture(g):
            self._graph_collectives(g)
            budget = self._budget.clone()
            self._budget.zero_()
            try:
                with g.warmup():
                    tt, dl = self._grow(state)
                    self._finalize_counted(state, tt, dl, self._verify(state, tt))
            finally:
                self._budget.copy_(budget)
            tt, dl = g.capture("grow", lambda: self._grow(state))
            tl = g.capture("verify", lambda: self._verify(state, tt))
            g.capture("finalize", lambda: self._finalize_counted(state, tt, dl, tl))

        self._graphs.ensure(self._graph_key(), capture)

    def graph_report(self) -> dict:
        """{phase: capture seconds, replays, launches per replay} of the
        captured graphs (empty on the CPU or before the first capture)."""
        return self._graphs.report() if self._graphs is not None else {}

    def _arm(self, budget: int) -> None:
        """Start the device loop's counters for a budget of `budget` tokens."""
        self._produced.zero_()
        self._steps.zero_()
        self._budget.fill_(budget)

    def _block(self, state: DecodeState, k: int) -> None:
        """k predicated iterations: the captured phases replayed on the
        card, the same phases launched eagerly on the CPU."""
        with trace.span("block"):
            trace.count("draft_forwards", k * self._draft_forwards)
            for _ in range(k):
                if self._graphs is None:
                    tt, dl = self._grow(state)
                    self._finalize_counted(state, tt, dl, self._verify(state, tt))
                else:
                    for name in ("grow", "verify", "finalize"):
                        self._graphs.replay(name)

    def _block_size(self, gtl: int, remaining: int) -> int:
        """Iterations in the next block: as many as still fit the buffer if
        each commits `max_depth + 1` tokens, and no more than could be
        needed for `remaining` tokens (so no iteration starts past the
        budget), at most `BLOCK_ITERATIONS`."""
        step = self.max_depth + 1
        last_gtl = min(self.max_length + 1 - self.tree_size, self.max_length - step)
        return max(1, min(1 + (last_gtl - gtl) // step, -(-remaining // step),
                          BLOCK_ITERATIONS))

    def _device_loop(self, state: DecodeState, gtl: int, budget: int):
        """JAX's `_generate_loop`: iterations while not terminal, under the
        budget and while the next tree fits, from committed length `gtl`.
        One host read per block. Returns `(produced, steps, terminal)`."""
        if self._graphs is not None and budget > 0 and self._fits(gtl):
            self._ensure_graphs(state)
        with trace.span("loop"):
            self._arm(budget)
            produced, steps, terminal = 0, 0, False
            while not terminal and produced < budget and self._fits(gtl + produced):
                self._block(state, self._block_size(gtl + produced, budget - produced))
                with trace.span("host_read"):
                    produced, steps, terminal = torch.stack(
                        [self._produced, self._steps, state.terminal.long()]).tolist()
        return produced, steps, bool(terminal)

    def iterate_phased(self, state: DecodeState):
        """One speculative iteration as its three phases, each timed (JAX
        `iterate_phased`, the reference's `benchmark=True` split,
        `Tree/SpecTree.py:99-241`): `draft_run` (growth incl. sampling),
        `target_run` (verify forward), `accept_kv` (walk, commit, re-draft).
        On the card the captured graphs, replayed with CUDA events between
        them; on the CPU the same phases launched eagerly, on the host clock.
        Returns `(stats, {phase: seconds})`; the stats are rewritten by the
        next iteration. An iteration after a stop token is a no-op."""
        clock = trace.PhaseClock(self.device)
        trace.count("draft_forwards", self._draft_forwards)
        if self._graphs is not None:
            self._ensure_graphs(state)
            for phase, name in (("draft_run", "grow"), ("target_run", "verify"),
                                ("accept_kv", "finalize")):
                clock.mark(phase)
                self._graphs.replay(name)
            clock.mark()
            stats = self._graphs.outputs("finalize")
        else:
            clock.mark("draft_run")
            tt, dl = self._grow(state)
            clock.mark("target_run")
            tl = self._verify(state, tt)
            clock.mark("accept_kv")
            stats = self._finalize_counted(state, tt, dl, tl)
            clock.mark()
        return stats, clock.seconds()

    # ------------------------------------------------------------------
    # Generation loops
    # ------------------------------------------------------------------

    def _fits(self, gtl: int) -> bool:
        return (gtl - 1 + self.tree_size <= self.max_length
                and gtl + self.max_depth + 1 <= self.max_length)

    def _run(self, prompt, max_new_tokens: int, seed: int, phase_totals=None):
        """Iterate until a stop token, the budget, or a full buffer, reading
        the emitted count and the terminal flag after each iteration;
        yields `(state, gtl_before, emitted)`. With `phase_totals` (a dict),
        the iterations go through `iterate_phased` and add their phase
        times to it."""
        state = self.prefill(prompt, seed=seed)
        gtl = int(np.asarray(prompt).size)
        produced = 0
        self.num_decoding_steps = 0
        self.num_large_model_steps = 0
        while produced < max_new_tokens and self._fits(gtl):
            if phase_totals is None:
                stats = self.iterate(state)
            else:
                stats, seconds = self.iterate_phased(state)
                for k, v in seconds.items():
                    phase_totals[k] = phase_totals.get(k, 0.0) + v
            emitted, terminal = torch.stack(
                [stats.emitted, stats.terminal.long()]).tolist()  # one host read
            yield state, gtl, emitted
            produced += emitted
            gtl += emitted
            self.num_decoding_steps += emitted
            self.num_large_model_steps += 1
            if terminal:
                break

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 128,
                 seed: int = 0) -> np.ndarray:
        """Generate until a stop token / the budget / a full buffer, one
        eager iteration and one host read at a time. Returns the committed
        sequence (prompt + generated), int32."""
        state, gtl = None, int(np.asarray(prompt).size)
        for state, before, emitted in self._run(prompt, max_new_tokens, seed):
            gtl = before + emitted
        if state is None:
            return np.asarray(prompt, np.int32).reshape(-1)
        return state.tokens[:gtl].cpu().numpy().astype(np.int32)

    def generate_fast(self, prompt: np.ndarray, max_new_tokens: int = 128,
                      seed: int = 0) -> np.ndarray:
        """`generate` with the loop on the device (JAX `generate_fast`):
        blocks of replayed iterations, one host read per block. The same
        committed sequence as `generate` for one seed."""
        with trace.span("request"):
            state = self.prefill(prompt, seed=seed)
            plen = int(np.asarray(prompt).size)
            produced, steps, _ = self._device_loop(state, plen, max_new_tokens)
            self.num_decoding_steps = produced
            self.num_large_model_steps = steps
            return state.tokens[:plen + produced].cpu().numpy().astype(np.int32)

    def generate_benchmark(self, prompt: np.ndarray, max_new_tokens: int = 128,
                           seed: int = 0):
        """Generation through `iterate_phased`, with per-phase times (CUDA
        events between graph replays on the card); returns
        `(tokens, {phase: total_seconds})`."""
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

    def stream_fast(self, prompt: np.ndarray, max_new_tokens: int = 128,
                    chunk_tokens: int = 16, seed: int = 0):
        """Streaming with the loop on the device (JAX `stream_fast`): yields
        the tokens (np int32) each device loop of up to `chunk_tokens`
        tokens commits; stops when a chunk commits nothing or ends on a
        stop token. Greedy decoding commits what `generate_fast` commits."""
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        with trace.span("request"):
            state = self.prefill(prompt, seed=seed)
            gtl = int(np.asarray(prompt).size)
            produced = 0
            self.num_decoding_steps = 0
            self.num_large_model_steps = 0
            while produced < max_new_tokens:
                budget = min(chunk_tokens, max_new_tokens - produced)
                chunk, steps, terminal = self._device_loop(state, gtl, budget)
                if chunk == 0:   # terminal or a full buffer before any token
                    break
                with trace.span("chunk_out"):
                    new = state.tokens[gtl:gtl + chunk].cpu().numpy().astype(np.int32)
                produced += chunk
                gtl += chunk
                self.num_decoding_steps += chunk
                self.num_large_model_steps += steps
                yield new
                if terminal:
                    break
