"""Device-side tree verification: the four accept walks of the stochastic
algorithms, token matching for greedy/greedyS, and path resolution.

Port of `sequoia_tpu/trees/accept.py`, every walk an engine configuration
reaches:
- `stochastic_path_walk_node` (`walk="node"`, the default): one trip per
  visited node, the node's ranks tested inside the trip;
- `stochastic_path_walk` (`walk="path"`): one trip per tested edge;
- `stochastic_path_walk_unrolled` (`walk="unrolled"`): the node walk with
  every trip testing all `max_branch` ranks;
- `stochastic_accept_decisions` + `resolve_path` + `node_residual`
  (`walk="staged"`): a decision for every parent at once, then the path,
  then the bonus residual at its final node;
plus `token_match_accept` (greedy / greedyS). JAX's frozen test oracles
(`stochastic_accept`, `stochastic_accept_dense`) are not ported.

The reference walked the tree on the host, one device sync per edge
(`Tree/SpecTree.py:203-213`); here every walk stays on the device: where
JAX ran a `lax.while_loop`, the port runs a Python loop of a fixed number of
trips (enough for the longest walk the tree allows) whose updates are
predicated on a `done` flag, and the decisions are identical. Nothing reads
a value back to the host inside a walk: a 0-d tensor index (`x[node]`)
would, as PyTorch turns it into `.item()`, so every lookup at a device
index is an `index_select` (`at_index`), and each walk captures into a CUDA
graph.

Verification rules (SURVEY.md §2.1):
- sequoia   : accept iff p[tok] >  r * q[tok]; on reject p <- residual(p, q),
              draft prob of tok -> 0 and renormalize (without replacement).
- specinfer : accept iff p[tok] >= r * q[tok]; on reject p <- residual(p, q).
- greedy    : accept iff tok == argmax(target_logits).
- greedys   : accept iff tok == sample from the filtered target distribution.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..ops.sampling import draft_probs, residual


class AcceptResult(NamedTuple):
    accepted_child: torch.Tensor  # long [size]: first accepted child node id or -1
    target_token: torch.Tensor    # long [size]: greedy/greedyS verification token


class WalkResult(NamedTuple):
    path: torch.Tensor          # long [max_depth]: accepted tree nodes, -1 pad
    accept_count: torch.Tensor  # long 0-d: accepted tree nodes (excl. root)
    final_node: torch.Tensor    # long 0-d: node whose residual feeds the bonus
    terminal: torch.Tensor      # bool 0-d: stop token accepted on the path
    p_final_row: torch.Tensor   # f32 [vocab]: bonus distribution at final_node


class PathResult(NamedTuple):
    path: torch.Tensor          # long [max_depth]: accepted nodes in order, -1 pad
    accept_count: torch.Tensor  # long 0-d
    final_node: torch.Tensor    # long 0-d
    terminal: torch.Tensor      # bool 0-d: stop token accepted on the path


def at_index(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """`x[i]` for a 0-d index tensor `i`, without a host read."""
    return x.index_select(0, i.reshape(1))[0]


def ranks_per_trip(successors: np.ndarray, trips: int) -> List[int]:
    """Static rank-loop length for each walk trip. While the walk is live,
    trip t sits at a node of depth t, so it needs only as many rank tests
    as the widest node at that depth has children; ranks past a node's
    children are no-ops in the JAX walk, so the decisions do not change."""
    size = successors.shape[0]
    depth = np.zeros(size, np.int64)
    for i in range(size):
        for c in successors[i]:
            if c >= 0:
                depth[c] = depth[i] + 1
    n_children = (successors >= 0).sum(axis=1)
    return [int(n_children[depth == t].max(initial=0)) for t in range(trips)]


def _row_dists(target_logits, draft_logits, top_p_cut, temperature):
    """The path walks' lazily built rows at a node (a 0-d index tensor):
    `p_at`, the nucleus-filtered target distribution, and `q_at`, the draft
    distribution. Division by T (not multiplication by 1/T), as in
    `target_probs` / `draft_probs`, so that nucleus membership agrees with
    the staged walk's (JAX `stochastic_path_walk`, the note at its p_at)."""
    zero = torch.zeros((), device=target_logits.device)

    def p_at(node):
        sm = torch.softmax(at_index(target_logits, node).float() / temperature, dim=-1)
        kept = torch.where(sm >= at_index(top_p_cut, node), sm, zero)
        return kept / kept.sum()

    def q_at(node):
        return torch.softmax(at_index(draft_logits, node).float() / temperature, dim=-1)

    return p_at, q_at


def stochastic_path_walk_node(
    target_logits: torch.Tensor,  # f32 [size, vocab]
    draft_logits: torch.Tensor,   # f32 [size, vocab]
    tokens_tree: torch.Tensor,    # long [size]
    r: torch.Tensor,              # f32 [size] uniform threshold per node
    successors: torch.Tensor,     # long [size, max_branch], -1 pad
    temperature: float,
    top_p_cut: torch.Tensor,      # f32 [size] inclusive nucleus cutoff per row
    stop_tokens: torch.Tensor,    # long [n_stop]
    max_depth: int,
    strict: bool,
    mask_rejected_draft: bool,
    ranks: List[int],
) -> WalkResult:
    """Path-following walk, one trip per visited node: p/q rows are built
    lazily on node entry,

      p_row = normalize(where(softmax(tl[node]/T) >= cut[node], ., 0))
      q_row = softmax(dl[node]/T)

    and each trip tests the node's children in rank order, applying the
    residual (and, for sequoia, the draft mask) on each rejection. The final
    node's running residual is the bonus distribution. Same decisions and
    outputs as `sequoia_tpu.trees.accept.stochastic_path_walk_node` on the
    same inputs. Division by T (not multiplication by 1/T), so the nucleus
    membership matches the cutoff computed from the same logits.

    `successors` and `stop_tokens` are tensors on the logits' device, built
    once by the caller (a host copy here would run every iteration), and
    `ranks = ranks_per_trip(successors, max_depth + 1)`, from the host's
    copy of the successors."""
    dev = target_logits.device
    vocab_idx = torch.arange(target_logits.shape[-1], device=dev)
    depth_idx = torch.arange(max_depth, device=dev)
    zero = torch.zeros((), device=dev)
    p_at, q_at = _row_dists(target_logits, draft_logits, top_p_cut, temperature)

    cur = torch.zeros((), dtype=torch.long, device=dev)
    p_row, q_row = p_at(cur), q_at(cur)
    path = torch.full((max_depth,), -1, dtype=torch.long, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    for n_ranks in ranks:
        children = at_index(successors, cur)             # [max_branch]
        child_c = children.clamp_min(0)
        tokens = tokens_tree[child_c]
        thresh_r = r[child_c]
        can_descend = count < max_depth
        found = torch.zeros((), dtype=torch.bool, device=dev)
        open_ = ~done
        chosen = cur
        chosen_tok = torch.zeros((), dtype=torch.long, device=dev)
        for j in range(n_ranks):
            open_ = open_ & (children[j] >= 0)    # the walk stops at the -1 pad
            token = tokens[j]
            p_tok, q_tok = at_index(p_row, token), at_index(q_row, token)
            thresh = thresh_r[j] * q_tok
            ok = (p_tok > thresh) if strict else (p_tok >= thresh)
            test = open_ & ~found
            # An ok rank that cannot descend is neither accepted nor
            # rejected: the scan moves on (as in JAX).
            accept = test & ok & can_descend
            reject = test & ~ok
            chosen = torch.where(accept, child_c[j], chosen)
            chosen_tok = torch.where(accept, token, chosen_tok)
            found = found | accept
            p_row = torch.where(reject, residual(p_row, q_row), p_row)
            if mask_rejected_draft:
                q_new = torch.where(vocab_idx == token, zero, q_row) / torch.clamp_min(
                    1.0 - q_tok, 1e-30)
                q_row = torch.where(reject, q_new, q_row)

        is_stop = found & (chosen_tok == stop_tokens).any()
        path = torch.where(found & (depth_idx == count), chosen, path)
        count = count + found.long()
        descend = found & ~is_stop
        cur = torch.where(found, chosen, cur)
        p_row = torch.where(descend, p_at(cur), p_row)
        q_row = torch.where(descend, q_at(cur), q_row)
        terminal = terminal | is_stop
        done = done | is_stop | ~found

    return WalkResult(path=path, accept_count=count, final_node=cur,
                      terminal=terminal, p_final_row=p_row)


def stochastic_path_walk_unrolled(
    target_logits, draft_logits, tokens_tree, r, successors, temperature,
    top_p_cut, stop_tokens, max_depth: int, strict: bool,
    mask_rejected_draft: bool,
) -> WalkResult:
    """JAX `stochastic_path_walk_unrolled`: the node walk's `max_depth + 1`
    trips with every trip testing all `max_branch` ranks, predicated, where
    the node walk tests only as many ranks as the widest node at the trip's
    depth has children (`ranks_per_trip`). Ranks past a node's children are
    no-ops, so decisions and outputs are the node walk's, bit for bit;
    only the work differs (JAX measured it the slower walk on a TPU)."""
    ranks = [successors.shape[1]] * (max_depth + 1)
    return stochastic_path_walk_node(
        target_logits, draft_logits, tokens_tree, r, successors, temperature,
        top_p_cut, stop_tokens, max_depth, strict, mask_rejected_draft, ranks)


def edge_trips(successors: np.ndarray, max_depth: int) -> int:
    """Trips `stochastic_path_walk` needs to finish on any input: at a node
    of depth t the walk tests at most its children and then finds no
    further rank, so `ranks_per_trip(...)[t] + 1` trips a depth suffice."""
    return sum(n + 1 for n in ranks_per_trip(successors, max_depth + 1))


def stochastic_path_walk(
    target_logits: torch.Tensor,  # f32 [size, vocab]
    draft_logits: torch.Tensor,   # f32 [size, vocab]
    tokens_tree: torch.Tensor,    # long [size]
    r: torch.Tensor,              # f32 [size] uniform threshold per node
    successors: torch.Tensor,     # long [size, max_branch], -1 pad
    temperature: float,
    top_p_cut: torch.Tensor,      # f32 [size] inclusive nucleus cutoff per row
    stop_tokens: torch.Tensor,    # long [n_stop]
    max_depth: int,
    strict: bool,
    mask_rejected_draft: bool,
    trips: int,
) -> WalkResult:
    """The path-following walk one tested edge at a time (JAX
    `stochastic_path_walk`, the reference's control flow): a trip tests
    rank `j` of the current node; an accept descends (p/q rows rebuilt
    lazily at the child) and restarts at rank 0, a reject applies the
    residual (and, for sequoia, the draft mask) at the current node and
    moves to rank `j + 1`, and a missing rank ends the walk. Decisions and
    outputs equal the node walk's on the same inputs. `trips =
    edge_trips(successors_host, max_depth)`: JAX's `lax.while_loop` ends
    when the walk does, here the later trips are predicated no-ops."""
    dev = target_logits.device
    max_branch = successors.shape[1]
    succ_flat = successors.reshape(-1)
    vocab_idx = torch.arange(target_logits.shape[-1], device=dev)
    depth_idx = torch.arange(max_depth, device=dev)
    zero = torch.zeros((), device=dev)
    p_at, q_at = _row_dists(target_logits, draft_logits, top_p_cut, temperature)

    cur = torch.zeros((), dtype=torch.long, device=dev)
    j = torch.zeros((), dtype=torch.long, device=dev)
    p_row, q_row = p_at(cur), q_at(cur)
    path = torch.full((max_depth,), -1, dtype=torch.long, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    for _ in range(trips):
        child = torch.where(j < max_branch,
                            at_index(succ_flat, cur * max_branch + j.clamp_max(max_branch - 1)),
                            torch.full_like(j, -1))
        has_child = ~done & (child >= 0)
        child_c = child.clamp_min(0)
        token = at_index(tokens_tree, child_c)
        p_tok, q_tok = at_index(p_row, token), at_index(q_row, token)
        thresh = at_index(r, child_c) * q_tok
        ok = (p_tok > thresh) if strict else (p_tok >= thresh)
        can_descend = count < max_depth
        accept = has_child & ok & can_descend
        reject = has_child & ~ok

        # Accept: descend (or stop on a stop token).
        is_stop = accept & (token == stop_tokens).any()
        path = torch.where(accept & (depth_idx == count), child_c, path)
        count = count + accept.long()
        descend = accept & ~is_stop
        cur = torch.where(accept, child_c, cur)
        p_row = torch.where(descend, p_at(cur), p_row)
        q_row = torch.where(descend, q_at(cur), q_row)

        # Reject: residual and draft mask at the current node.
        p_row = torch.where(reject, residual(p_row, q_row), p_row)
        if mask_rejected_draft:
            q_new = torch.where(vocab_idx == token, zero, q_row) / torch.clamp_min(
                1.0 - q_tok, 1e-30)
            q_row = torch.where(reject, q_new, q_row)

        j = torch.where(accept, torch.zeros_like(j), j + 1)
        terminal = terminal | is_stop
        # Done: a stop token accepted, or no (further) child at this rank.
        done = done | is_stop | ~has_child

    return WalkResult(path=path, accept_count=count, final_node=cur,
                      terminal=terminal, p_final_row=p_row)


class StagedPlan(NamedTuple):
    """The staged walk's static row sets (JAX computes them while tracing
    `stochastic_accept_decisions`), built once per growmap: the parents
    (nodes with a child) sorted by child count, descending, and for each
    rank j the rank-j children of the first `n_j` of them."""
    parents: torch.Tensor              # long [P]
    rank_children: List[torch.Tensor]  # long [n_j] per rank, n_j > 0 non-increasing


def staged_plan(successors: np.ndarray, device) -> StagedPlan:
    successors = np.asarray(successors)
    child_count = (successors >= 0).sum(axis=1)
    order = np.argsort(-child_count, kind="stable")
    parents = order[child_count[order] > 0]
    succ_sorted = successors[parents]
    rank_children = []
    for j in range(successors.shape[1]):
        nj = int((child_count[parents] > j).sum())
        if nj == 0:
            break
        rank_children.append(torch.as_tensor(succ_sorted[:nj, j], dtype=torch.long,
                                             device=device))
    return StagedPlan(torch.as_tensor(parents, dtype=torch.long, device=device),
                      rank_children)


def stochastic_accept_decisions(
    p: torch.Tensor,              # f32 [size, vocab] target verification dist
    draft_logits: torch.Tensor,   # f32 [size, vocab]
    tokens_tree: torch.Tensor,    # long [size]
    r: torch.Tensor,              # f32 [size] uniform threshold per node
    plan: StagedPlan,             # staged_plan(successors)
    temperature: float,
    strict: bool,
    mask_rejected_draft: bool,
) -> torch.Tensor:
    """Accept decisions for every parent at once (JAX
    `stochastic_accept_decisions`, `walk="staged"`): `accepted_child`
    long [size], the first accepted child of each node or -1. The parent
    rows are gathered once; at rank j the first n_j sorted parents are
    tested, a static prefix `[:n_j]`, with the residual (and, for sequoia,
    the renormalized draft mask) on each rejection. No residual is kept
    for the bonus: `node_residual` replays it at the path's final node."""
    size = p.shape[0]
    accepted_child = torch.full((size,), -1, dtype=torch.long, device=p.device)
    if plan.parents.numel() == 0:
        return accepted_child
    p_par = p.index_select(0, plan.parents)                     # [P, V]
    q_par = draft_probs(draft_logits.index_select(0, plan.parents), temperature)
    accepted = torch.full((plan.parents.numel(),), -1, dtype=torch.long, device=p.device)
    for child in plan.rank_children:
        nj = child.numel()
        token = tokens_tree[child]                               # [nj]
        p_sub, q_sub = p_par[:nj], q_par[:nj]
        p_tok = p_sub.gather(1, token[:, None])[:, 0]
        q_tok = q_sub.gather(1, token[:, None])[:, 0]
        thresh = r[child] * q_tok
        ok = (p_tok > thresh) if strict else (p_tok >= thresh)
        acc_sub = accepted[:nj]
        active = acc_sub < 0
        rej = (active & ~ok)[:, None]
        # Out of place (`cat` of the updated prefix and the rest), so the
        # walk also runs under `torch.func.vmap`.
        accepted = torch.cat([torch.where(active & ok, child, acc_sub), accepted[nj:]])
        p_par = torch.cat([torch.where(rej, residual(p_sub, q_sub), p_sub), p_par[nj:]])
        if mask_rejected_draft:
            q_masked = q_sub.scatter(1, token[:, None], 0.0)
            q_new = q_masked / torch.clamp_min(1.0 - q_tok, 1e-30)[:, None]
            q_par = torch.cat([torch.where(rej, q_new, q_sub), q_par[nj:]])
    return accepted_child.index_copy(0, plan.parents, accepted)


def node_residual(p_row: torch.Tensor, q_row: torch.Tensor,
                  child_tokens: torch.Tensor, child_valid: torch.Tensor,
                  mask_rejected_draft: bool) -> torch.Tensor:
    """Residual at a node all of whose valid children were rejected: replay
    the sibling scan on one row, in rank order (the staged walk's bonus
    distribution). `child_tokens` must hold valid token ids everywhere
    (clamp the -1 pads first)."""
    vocab_idx = torch.arange(p_row.shape[-1], device=p_row.device)
    zero = torch.zeros((), device=p_row.device)
    for j in range(child_tokens.shape[0]):
        v, tok = child_valid[j], child_tokens[j]
        q_tok = at_index(q_row, tok)
        p_row = torch.where(v, residual(p_row, q_row), p_row)
        if mask_rejected_draft:
            q_new = torch.where(vocab_idx == tok, zero, q_row) / torch.clamp_min(
                1.0 - q_tok, 1e-30)
            q_row = torch.where(v, q_new, q_row)
    return p_row


def token_match_accept(target_token: torch.Tensor, tokens_tree: torch.Tensor,
                       successors: torch.Tensor) -> AcceptResult:
    """Greedy / greedyS: accept the first child whose token equals the
    node's verification token."""
    valid = successors >= 0
    child_tokens = tokens_tree[successors.clamp_min(0)]        # [size, B]
    match = valid & (child_tokens == target_token[:, None])
    first = match.long().argmax(dim=1)                          # first True
    accepted = torch.where(match.any(dim=1),
                           successors.gather(1, first[:, None])[:, 0],
                           torch.full_like(first, -1))
    return AcceptResult(accepted_child=accepted, target_token=target_token)


def resolve_path(accepted_child: torch.Tensor, tokens_tree: torch.Tensor,
                 stop_tokens: torch.Tensor, max_depth: int) -> PathResult:
    """Follow accepted_child pointers from the root; stop at the first
    rejection or at an accepted stop token (`Tree/SpecTree.py:203-213`).
    A fixed `max_depth` trips of predicated updates (no host reads).
    `stop_tokens`: long [n_stop], on the device of `accepted_child`."""
    dev = accepted_child.device
    depth_idx = torch.arange(max_depth, device=dev)
    node = torch.zeros((), dtype=torch.long, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    terminal = torch.zeros((), dtype=torch.bool, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    path = torch.full((max_depth,), -1, dtype=torch.long, device=dev)
    for _ in range(max_depth):
        nxt = at_index(accepted_child, node)
        step = (nxt >= 0) & ~stopped
        node = torch.where(step, nxt, node)
        is_stop = step & (at_index(tokens_tree, node) == stop_tokens).any()
        path = torch.where(step & (depth_idx == count), node, path)
        count = count + step.long()
        terminal = terminal | is_stop
        stopped = stopped | ~step | is_stop
    return PathResult(path=path, accept_count=count, final_node=node,
                      terminal=terminal)
