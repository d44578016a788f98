"""Hardware-aware offline tree planner (numpy backend).

The port's own copy of `sequoia_tpu/planner/dp.py` without the native C++
backend.

Dynamic program over (acceptance-rate vector, measured latency curve) that
emits the optimal static speculation-tree topology — the growmap. Same
mathematical program as the reference `tree_search.py:21-75` (it is
hardware-agnostic; only the latency inputs change per hardware):

  T[m][l][b] = max expected accepted tokens of a tree with m nodes, depth
  <= l, whose root has exactly b children (children ordered by draft
  sampling rank; p[b] = probability the rank-b child is the accepted one).

  T[1][l][0] = 1
  T[m][l][1] = 1 + p[1] * max_b' T[m-1][l-1][b']
  T[m][l][b] = max_{1<=y<m} T[y][l][b-1] + p[b] * max_b' T[m-y][l-1][b']

The serving tree is then chosen to minimize expected per-token latency
  (depth * t_draft + t_target(budget)) / E[accepted]
over the measured `(valid_budget, target_time)` curve, and materialized
BFS-wise into a GrowMap. Inner maximization over the split y is vectorized
in numpy (the reference triple-loops in Python).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..trees.growmap import GrowMap

NEG = -np.inf


@dataclasses.dataclass
class PlannerTable:
    T: np.ndarray  # [budget+1, depth+1, branch+1]
    Y: np.ndarray  # same shape, i32: split backpointer (nodes kept by the
    #                first b-1 children's subtree); -1 = infeasible
    p: np.ndarray

    @property
    def results(self) -> np.ndarray:
        """max over root branch counts: [budget+1, depth+1]."""
        return self.T.max(axis=2)

    @property
    def Targ(self) -> np.ndarray:
        if not hasattr(self, "_targ"):
            object.__setattr__(self, "_targ", self.T.argmax(axis=2))
        return self._targ

    def children(self, m: int, l: int, b: int) -> List[Tuple[int, int, int]]:
        """Child states `(nodes, depth, branches)` of an optimal (m, l, b)
        tree, in sibling-rank order (replaces the reference's explicit
        `branch_map` lists, `tree_search.py:33-50`, with backpointer
        reconstruction)."""
        if b == 0:
            return []
        y = int(self.Y[m, l, b])
        assert y >= 1, f"infeasible state ({m},{l},{b})"
        rest = (m - y, l - 1, int(self.Targ[m - y, l - 1]))
        return self.children(y, l, b - 1) + [rest]


def fill_table(p: np.ndarray, max_budget: int, max_depth: int) -> PlannerTable:
    """p[0] must be 0; p[b] = acceptance probability of the rank-b child
    (the acceptance-rate vector artifact, SURVEY.md §2.2). numpy only: the
    C++ DP of `sequoia_tpu/native/` is not ported yet."""
    p = np.asarray(p, np.float64)
    assert p[0] == 0.0
    max_branch = len(p) - 1
    T = np.full((max_budget + 1, max_depth + 1, max_branch + 1), NEG)
    Y = np.full((max_budget + 1, max_depth + 1, max_branch + 1), -1, np.int32)
    for l in range(1, max_depth + 1):
        T[1][l][0] = 1.0

    Tmax = T.max(axis=2)  # maintained incrementally: Tmax[m][l]
    Targ = T.argmax(axis=2)
    with np.errstate(invalid="ignore"):
      for m in range(2, max_budget + 1):
        for l in range(2, max_depth + 1):
            v1 = 1.0 + p[1] * Tmax[m - 1][l - 1]
            T[m][l][1] = NEG if np.isnan(v1) else v1
            if T[m][l][1] > 0:
                Y[m][l][1] = 1
            for b in range(2, max_branch + 1):
                # candidates over split y in [1, m). `0 * -inf = nan` occurs
                # when p[b] == 0 and the subtree is infeasible; treat as
                # infeasible (the reference's `nan > x` comparison is False,
                # so nan candidates are skipped there too).
                ys = np.arange(1, m)
                vals = T[1:m, l, b - 1] + p[b] * Tmax[m - ys, l - 1]
                vals = np.where(np.isnan(vals), NEG, vals)
                yi = int(np.argmax(vals))
                max_value = vals[yi]
                T[m][l][b] = max_value
                if max_value >= 0:
                    Y[m][l][b] = int(ys[yi])
            mx = T[m][l].max()
            Tmax[m][l] = mx
            Targ[m][l] = int(T[m][l].argmax())
    return PlannerTable(T=T, Y=Y, p=p)


def choose_tree(
    table: PlannerTable,
    valid_budget: Sequence[int],
    target_time: Sequence[float],
    draft_time: float,
) -> Tuple[int, int, float, float]:
    """Pick (budget, depth) minimizing expected per-token latency
    (`tree_search.py:63-75`). Returns (budget, depth, dec_time, exp_accept)."""
    results = table.results
    best = (None, None, np.inf, 0.0)
    for i, b in enumerate(valid_budget):
        for d in range(results.shape[1]):
            ac = results[b][d]
            if ac < 0:
                continue
            x = (d * draft_time + target_time[i]) / ac
            if x < best[2]:
                best = (b, d, x, ac)
    assert best[0] is not None, "no feasible tree"
    return best


def materialize(table: PlannerTable, budget: int, depth: int) -> GrowMap:
    """BFS-materialize the optimal tree with `budget` nodes / depth bound
    into a GrowMap (`tree_search.py:80-118` flow)."""
    b0 = int(table.T[budget][depth].argmax())
    states = [(budget, depth, b0)]
    active = [True]
    depths = [0]
    successors: List[List[int]] = [[]]
    parents = [-1]
    roots: List[List[int]] = []
    branches: List[List[int]] = []
    n = 1
    while True:
        expand, expand_branch = [], []
        for i in range(len(active)):
            if not active[i]:
                continue
            active[i] = False
            (x, y, z) = states[i]
            expand.append(i)
            expand_branch.append(z)
            kids = list(range(n, n + z))
            successors[i].extend(kids)
            successors.extend([[] for _ in kids])
            parents.extend([i] * z)
            depths.extend([depths[i] + 1] * z)
            child_states = table.children(x, y, z)
            assert len(child_states) == z
            states.extend(child_states)
            n += z
        if not expand:
            break
        roots.append(expand)
        branches.append(expand_branch)
        active.extend([True] * sum(expand_branch))
    assert n == budget, (n, budget)
    anc = np.zeros((n, n), bool)
    anc[0, 0] = True
    for i in range(1, n):
        anc[i] = anc[parents[i]]
        anc[i, i] = True
    return GrowMap.from_fields(n, roots, branches, successors, anc, depths)


def expected_accepted(gm: GrowMap, p: np.ndarray) -> float:
    """E[tokens emitted per target step] for a tree under acceptance vector
    p (root counts as 1 = the bonus/root token). Bottom-up over BFS order."""
    p = np.asarray(p, np.float64)
    E = np.ones(gm.size)
    for i in range(gm.size - 1, -1, -1):
        for rank, c in enumerate(gm.successors[i], start=1):
            if rank < len(p):
                E[i] += p[rank] * E[c]
    return float(E[0])


def plan(
    acceptance_vector: np.ndarray,
    valid_budget: Sequence[int],
    target_time: Sequence[float],
    draft_time: float,
    max_depth: int = 10,
    max_budget: Optional[int] = None,
    max_branch: Optional[int] = None,
) -> Tuple[GrowMap, dict]:
    """End-to-end planning: fill table, choose serving tree, materialize.
    Returns (growmap, info dict with dec_time / speedup estimate).

    `max_branch` caps per-node branching by truncating the acceptance
    vector. The engine's per-iteration overhead scales with the max sibling
    rank (the accept walk is sequential over ranks, the WOR sampler's k
    follows the widest node), while the vector's tail mass is tiny — e.g.
    the reference 68m->7b vector costs only 0.6% of E[accept] at cap 8
    (4.179 -> 4.155 at budget 128) for a ~2x shorter walk."""
    p = np.asarray(acceptance_vector, np.float64)
    if max_branch is not None and len(p) > max_branch + 1:
        p = p[: max_branch + 1]
    if max_budget is None:
        max_budget = int(max(valid_budget))
    table = fill_table(p, max_budget, max_depth)
    budget, depth, dec_time, exp_acc = choose_tree(
        table, valid_budget, target_time, draft_time
    )
    gm = materialize(table, budget, depth)
    info = {
        "budget": budget,
        "depth": depth,
        "dec_time": dec_time,
        "expected_accepted": exp_acc,
        "speedup_vs_target_time0": target_time[0] / dec_time,
    }
    return gm, info
