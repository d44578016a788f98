"""GrowMap: the static speculation-tree topology artifact.

The port's own copy of `sequoia_tpu/trees/growmap.py` (the port imports
nothing of `sequoia_tpu`).

Schema-compatible with the reference planner output (`tree_search.py:121-132`,
a `torch.save`d dict with keys `roots`, `branches`, `Successors`, `mask`,
`depth`, `size` — see SURVEY.md §2.2). Loaders accept both the reference
`.pt` files (via torch CPU) and a native JSON format; all fields are plain
numpy on the host, converted to device tensors by the engine.

Node numbering is BFS: node 0 is the root (the last committed token); grow
step `i` expands `roots[i]` giving `branches[i][j]` children per root, and
the new nodes of step `i` occupy a contiguous index range.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class GrowMap:
    size: int                      # total nodes incl. root
    roots: List[List[int]]         # per grow step: node ids to expand
    branches: List[List[int]]      # per grow step: children count per root
    successors: List[List[int]]    # per node: child node ids (BFS order)
    ancestors: np.ndarray          # bool [size, size]; row i = ancestors of i incl. i
    depth: np.ndarray              # i32 [size]

    # ---- derived static structure used by the engine ----

    @property
    def num_grow_steps(self) -> int:
        return len(self.roots)

    @property
    def level_widths(self) -> List[int]:
        """Tokens added per grow step (the reference's CUDA-graph capture
        bucket list, `tests/testbed.py:266-268`)."""
        return [int(sum(b)) for b in self.branches]

    @property
    def level_starts(self) -> List[int]:
        """First node id of each grow step's new nodes."""
        starts, n = [], 1
        for w in self.level_widths:
            starts.append(n)
            n += w
        return starts

    @property
    def max_branch(self) -> int:
        return max((max(b) for b in self.branches if b), default=0)

    def successors_padded(self) -> np.ndarray:
        """i32 `[size, max_branch]`, -1 padded, children in growth order."""
        out = np.full((self.size, max(self.max_branch, 1)), -1, np.int32)
        for i, ch in enumerate(self.successors):
            out[i, : len(ch)] = ch
        return out

    def num_children(self) -> np.ndarray:
        return np.asarray([len(c) for c in self.successors], np.int32)

    def child_rank(self) -> np.ndarray:
        """i32 `[size]`: position of node among its parent's children
        (0 for the root)."""
        rank = np.zeros(self.size, np.int32)
        for ch in self.successors:
            for j, c in enumerate(ch):
                rank[c] = j
        return rank

    def parent(self) -> np.ndarray:
        p = np.full(self.size, -1, np.int32)
        for i, ch in enumerate(self.successors):
            for c in ch:
                p[c] = i
        return p

    def sample_gather_index(self, step: int) -> np.ndarray:
        """Maps the padded per-root top-k sample matrix (flattened
        `[num_roots * max_k]`) to the flat list of new tokens for this step —
        `tests/testbed.py:277-285` semantics."""
        ks = self.branches[step]
        max_k = max(ks)
        idx = [j * max_k + t for j, k in enumerate(ks) for t in range(k)]
        return np.asarray(idx, np.int64)

    def validate(self) -> None:
        assert self.size >= 1
        assert self.ancestors.shape == (self.size, self.size)
        assert bool(self.ancestors[0, 0])
        assert len(self.depth) == self.size
        assert int(self.depth[0]) == 0
        n = 1
        for step, (roots, branch) in enumerate(zip(self.roots, self.branches)):
            assert len(roots) == len(branch), f"step {step}"
            for r, b in zip(roots, branch):
                assert list(self.successors[r]) == list(range(n, n + b))
                n += b
        assert n == self.size, f"BFS covers {n} != size {self.size}"
        parent = self.parent()
        for i in range(1, self.size):
            p = parent[i]
            assert p >= 0
            expect = self.ancestors[p].copy()
            expect[i] = True
            assert (self.ancestors[i] == expect).all(), f"ancestor row {i}"
            assert self.depth[i] == self.depth[p] + 1

    # ---- constructors / IO ----

    @staticmethod
    def from_fields(size, roots, branches, successors, ancestors, depth) -> "GrowMap":
        # The reference materializer emits a final grow step that "expands"
        # the deepest leaves with zero children (`tree_search.py:90-116`);
        # its runtime then skips it by iterating `range(draft_step - 1)`
        # (`Tree/SpecTree.py:249`). We strip zero-width steps here instead so
        # the engine can execute every remaining step uniformly.
        kept = [
            (r, b) for r, b in zip(roots, branches) if int(sum(int(x) for x in b)) > 0
        ]
        roots = [r for r, _ in kept]
        branches = [b for _, b in kept]
        gm = GrowMap(
            size=int(size),
            roots=[[int(x) for x in r] for r in roots],
            branches=[[int(x) for x in b] for b in branches],
            successors=[[int(x) for x in s] for s in successors],
            ancestors=np.asarray(ancestors).astype(bool),
            depth=np.asarray(depth).astype(np.int32),
        )
        gm.validate()
        return gm

    @staticmethod
    def from_torch_file(path: str) -> "GrowMap":
        """Load a reference-format growmap `.pt` (e.g. `demo_tree.pt`,
        `A100_growmaps/**/*.pt`)."""
        import torch

        d = torch.load(path, map_location="cpu", weights_only=False)
        return GrowMap.from_fields(
            size=d["size"],
            roots=d["roots"],
            branches=d["branches"],
            successors=d["Successors"],
            ancestors=np.asarray(d["mask"]),
            depth=np.asarray(d["depth"]),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "size": self.size,
                    "roots": self.roots,
                    "branches": self.branches,
                    "successors": self.successors,
                    "ancestors": self.ancestors.astype(int).tolist(),
                    "depth": self.depth.tolist(),
                },
                f,
            )

    @staticmethod
    def from_json(path: str) -> "GrowMap":
        with open(path) as f:
            d = json.load(f)
        return GrowMap.from_fields(
            d["size"], d["roots"], d["branches"], d["successors"],
            np.asarray(d["ancestors"]), np.asarray(d["depth"]),
        )

    @staticmethod
    def load(path: str) -> "GrowMap":
        if path.endswith(".json"):
            return GrowMap.from_json(path)
        return GrowMap.from_torch_file(path)


def chain(length: int) -> GrowMap:
    """A depth-`length` chain (each node one child) — the shape of
    `demo_tree.pt` (size-4 chain; SURVEY.md §2.2)."""
    assert length >= 1
    size = length + 1
    successors = [[i + 1] for i in range(length)] + [[]]
    ancestors = np.tril(np.ones((size, size), bool))
    return GrowMap.from_fields(
        size=size,
        roots=[[i] for i in range(length)],
        branches=[[1] for _ in range(length)],
        successors=successors,
        ancestors=ancestors,
        depth=np.arange(size),
    )


def tree_from_branches(steps: Sequence[Sequence[int]]) -> GrowMap:
    """Build a growmap from explicit per-step child counts: `steps[i][j]` is
    the number of children for the j-th frontier node at grow step i (0 =
    leaf). Covers heterogeneous sibling-group sizes — the shape of every
    planner-emitted growmap, which `chain`/`uniform_tree` cannot express."""
    successors: List[List[int]] = [[]]
    depths = [0]
    frontier = [0]
    roots: List[List[int]] = []
    branches: List[List[int]] = []
    n = 1
    for bs in steps:
        assert len(bs) == len(frontier), (len(bs), len(frontier))
        roots.append(list(frontier))
        branches.append([int(b) for b in bs])
        new_frontier = []
        for r, b in zip(frontier, bs):
            kids = list(range(n, n + b))
            successors[r].extend(kids)
            successors.extend([[] for _ in kids])
            depths.extend([depths[r] + 1] * b)
            new_frontier.extend(kids)
            n += b
        frontier = new_frontier
    size = n
    anc = np.zeros((size, size), bool)
    anc[0, 0] = True
    parent = np.full(size, -1)
    for i, ch in enumerate(successors):
        for c in ch:
            parent[c] = i
    for i in range(1, size):
        anc[i] = anc[parent[i]]
        anc[i, i] = True
    return GrowMap.from_fields(size, roots, branches, successors, anc, depths)


def uniform_tree(depth: int, branch: int) -> GrowMap:
    """Fixed k×d tree (the reference's `L40_growmaps/8x8-tree.pt`-style
    SpecInfer comparison shapes, `run.sh:1-30`)."""
    roots: List[List[int]] = []
    branches: List[List[int]] = []
    successors: List[List[int]] = [[]]
    depths = [0]
    frontier = [0]
    n = 1
    for _ in range(depth):
        roots.append(list(frontier))
        branches.append([branch] * len(frontier))
        new_frontier = []
        for r in frontier:
            kids = list(range(n, n + branch))
            successors[r].extend(kids)
            successors.extend([[] for _ in kids])
            depths.extend([depths[r] + 1] * branch)
            new_frontier.extend(kids)
            n += branch
        frontier = new_frontier
    size = n
    anc = np.zeros((size, size), bool)
    anc[0, 0] = True
    parent = np.full(size, -1)
    for i, ch in enumerate(successors):
        for c in ch:
            parent[c] = i
    for i in range(1, size):
        anc[i] = anc[parent[i]]
        anc[i, i] = True
    return GrowMap.from_fields(size, roots, branches, successors, anc, depths)
