"""Device-side tree verification: the node walk for the stochastic
algorithms, token matching for greedy/greedyS, and path resolution.

Port of the production pieces of `sequoia_tpu/trees/accept.py`:
`stochastic_path_walk_node` (the engine's `walk="node"`), `node_residual`,
`token_match_accept` and `resolve_path`. The reference walked the tree on
the host, one device sync per edge (`Tree/SpecTree.py:203-213`); here the
walk stays on the device: where JAX ran a `lax.while_loop`, the port runs a
Python loop of a fixed `max_depth + 1` trips whose updates are predicated
on a `done` flag, and the decisions are identical. Nothing reads a value
back to the host inside the walk: a 0-d tensor index (`x[node]`) would, as
PyTorch turns it into `.item()`, so every lookup at a device index is an
`index_select` (`at_index`), and the walk captures into a CUDA graph.

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

from ..ops.sampling import residual


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

    def p_at(node):
        sm = torch.softmax(at_index(target_logits, node).float() / temperature, dim=-1)
        kept = torch.where(sm >= at_index(top_p_cut, node), sm, zero)
        return kept / kept.sum()

    def q_at(node):
        return torch.softmax(at_index(draft_logits, node).float() / temperature, dim=-1)

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


def node_residual(p_row: torch.Tensor, q_row: torch.Tensor,
                  child_tokens: torch.Tensor, child_valid: torch.Tensor,
                  mask_rejected_draft: bool) -> torch.Tensor:
    """Residual at a node all of whose valid children were rejected: replay
    the sibling scan on one row, in rank order."""
    vocab_idx = torch.arange(p_row.shape[-1], device=p_row.device)
    zero = torch.zeros((), device=p_row.device)
    for j in range(child_tokens.shape[0]):
        v, tok = child_valid[j], child_tokens[j]
        q_tok = q_row[tok]
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
