"""The work the traffic needed in the traced window, as forward calls.

A `Call` is one forward of one model over every live slot: the query rows it
needed, the keys those rows attend to (summed over rows: the attention's
multiply-adds follow it) and the distinct cache rows they read (the bytes
follow it). It is worked out from the tree, the prompt lengths and the
committed lengths the run reached (the copies `trace.Tap` makes), never from
what a kernel does, so a later kernel that does the same work in another
way is counted alike. Iterations and slots that commit nothing, and the
padding rows of a prefill chunk, are not work the traffic needed.

Per iteration of a slot at committed length g that commits up to g':
- growth level l (draft): its w_l nodes at depth d attend to the g
  committed rows and their d ancestors in the tree scratch (themselves
  included); the level reads g + (start_l + w_l - 1) rows;
- verify (target): every node attends to the g - 1 rows before the root and
  to its d + 1 ancestors in the scratch; it reads g - 1 + size rows;
- the re-draft of the new root (draft): 1 row over g' keys.
A prefill or admission chunk of r prompt rows at offset o: row j attends to
o + j + 1 keys, and the chunk reads o + r rows.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple


@dataclass
class Call:
    model: str      # "draft" or "target"
    rows: int
    keys: int       # sum over rows of attended keys
    kv_rows: int    # distinct cache rows read


@dataclass
class Tree:
    size: int
    depth: List[int]
    widths: List[int]
    starts: List[int]

    @staticmethod
    def load(path) -> "Tree":
        with open(path) as f:
            d = json.load(f)
        widths = [sum(b) for b in d["branches"] if sum(b) > 0]
        starts, s = [], 1
        for w in widths:
            starts.append(s)
            s += w
        return Tree(int(d["size"]), [int(x) for x in d["depth"]], widths, starts)


def chunk_call(model: str, off: int, rows: int) -> Call:
    return Call(model, rows, rows * off + rows * (rows + 1) // 2, off + rows)


def prefill_calls(plen: int, chunk: int) -> List[Call]:
    """Both models' chunks of one request's prefill."""
    out = []
    for off in range(0, plen, chunk):
        rows = min(chunk, plen - off)
        out += [chunk_call("draft", off, rows), chunk_call("target", off, rows)]
    return out


def iteration_calls(tree: Tree, slots: Sequence[Tuple[int, int]]) -> List[Call]:
    """The calls of one iteration over the live slots `(g, g')`."""
    if not slots:
        return []
    out = []
    for s, w in zip(tree.starts, tree.widths):
        dsum = sum(tree.depth[s:s + w])
        out.append(Call("draft", w * len(slots), sum(w * g + dsum for g, _ in slots),
                        sum(g + s + w - 1 for g, _ in slots)))
    vsum = sum(d + 1 for d in tree.depth)
    out.append(Call("target", tree.size * len(slots),
                    sum(tree.size * (g - 1) + vsum for g, _ in slots),
                    sum(g - 1 + tree.size for g, _ in slots)))
    out.append(Call("draft", len(slots), sum(g2 for _, g2 in slots),
                    sum(g2 for _, g2 in slots)))
    return out


def admission_calls(entries: Iterable[Tuple[int, int, int]], chunk: int) -> List[Call]:
    """One admission step over `(offset, prompt length, valid)` entries."""
    parts = [(o, min(chunk, p - o)) for o, p, v in entries if v and p > o]
    if not parts:
        return []
    out = []
    for model in ("draft", "target"):
        cs = [chunk_call(model, o, r) for o, r in parts]
        out.append(Call(model, sum(c.rows for c in cs), sum(c.keys for c in cs),
                        sum(c.kv_rows for c in cs)))
    return out


def from_snaps(snaps: Sequence[tuple], tree: Tree, chunk: int) -> List[Call]:
    """The calls of a tap's host-side copies (`trace.Tap.snaps`, read to the
    host): `("prefill", plen)`, `("admit", [[off, plen, valid], ...])`, and
    `("before", g)` / `("after", g')` pairs, g a length or a list a slot."""
    out: List[Call] = []
    before = None
    for kind, val in snaps:
        if kind == "prefill":
            out += prefill_calls(int(val), chunk)
        elif kind == "admit":
            out += admission_calls([tuple(int(x) for x in e) for e in val], chunk)
        elif kind == "before":
            before = val if isinstance(val, list) else [val]
        elif kind == "after" and before is not None:
            after = val if isinstance(val, list) else [val]
            out += iteration_calls(tree, [(int(g), int(g2)) for g, g2 in zip(before, after)
                                          if g2 != g])
            before = None
    return out

