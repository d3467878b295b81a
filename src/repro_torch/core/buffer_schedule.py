"""Buffer Schedule (§3.3.1): bufferization + alias analysis + memory planning.

* **Alias analysis** — view-semantics ops (reshape/slice/squeeze/unpack-of-
  pack metadata views) share their input's storage: zero-copy.
* **Liveness** — intervals over a linearized (topological) op order.
* **Memory planning** — offset assignment is the classic interval bin-packing:
  a greedy best-fit planner for production sizes, plus an exact
  branch-and-bound planner (the paper's SAT-optimal arrangement) for small
  problem sizes, used to measure the greedy gap in tests.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tensor_ir import Term, term_shape

VIEW_OPS = ("reshape", "squeeze", "slice_view")


@dataclasses.dataclass
class BufferSpec:
    name: str
    size: int
    start: int            # first def (topo index)
    end: int              # last use
    alias_of: Optional[str] = None


def liveness_from_term(root: Term, dtype_bytes: int = 2) -> List[BufferSpec]:
    """Linearize a term DAG and build liveness intervals; view ops alias."""
    topo: List[Term] = []
    seen: Dict[Term, int] = {}

    def walk(t: Term):
        if t in seen:
            return
        for c in t.children:
            walk(c)
        seen[t] = len(topo)
        topo.append(t)
    walk(root)

    last_use = {i: i for i in range(len(topo))}
    for i, t in enumerate(topo):
        for c in t.children:
            last_use[seen[c]] = max(last_use[seen[c]], i)
    last_use[seen[root]] = len(topo)

    shape_cache: Dict[Term, Tuple[int, ...]] = {}
    buffers = []
    for i, t in enumerate(topo):
        shape = term_shape(t, shape_cache)
        n = dtype_bytes
        for d in shape:
            n *= d
        alias = None
        if t.op in VIEW_OPS and t.children:
            alias = f"b{seen[t.children[0]]}"
        buffers.append(BufferSpec(f"b{i}", 0 if alias else n, i,
                                  last_use[i], alias))
    return buffers


def _overlaps(a: BufferSpec, b: BufferSpec) -> bool:
    return not (a.end <= b.start or b.end <= a.start)


def plan_greedy(buffers: List[BufferSpec]) -> Tuple[Dict[str, int], int]:
    """Best-fit decreasing offset assignment.  Returns ({name: offset}, peak)."""
    real = [b for b in buffers if b.alias_of is None and b.size > 0]
    placed: List[Tuple[BufferSpec, int]] = []
    offsets: Dict[str, int] = {}
    for b in sorted(real, key=lambda x: -x.size):
        conflicts = sorted(
            [(off, off + p.size) for p, off in placed if _overlaps(p, b)])
        off = 0
        for lo, hi in conflicts:
            if off + b.size <= lo:
                break
            off = max(off, hi)
        offsets[b.name] = off
        placed.append((b, off))
    peak = max((off + b.size for b, off in placed), default=0)
    for b in buffers:
        if b.alias_of is not None:
            offsets[b.name] = offsets.get(b.alias_of, 0)
        elif b.size == 0:
            offsets.setdefault(b.name, 0)
    return offsets, peak


def plan_optimal(buffers: List[BufferSpec], node_budget: int = 200000
                 ) -> Tuple[Dict[str, int], int]:
    """Exact branch & bound over placement order (small inputs only)."""
    real = [b for b in buffers if b.alias_of is None and b.size > 0]
    if len(real) > 12:
        return plan_greedy(buffers)
    best: List[Tuple[int, Dict[str, int]]] = [plan_greedy(buffers)[::-1]]
    best_peak = best[0][0] if isinstance(best[0][0], int) else None
    g_off, g_peak = plan_greedy(buffers)
    best_sol = (g_peak, g_off)
    visited = [0]

    def place(order_left: List[BufferSpec], placed: List[Tuple[BufferSpec, int]],
              peak: int):
        visited[0] += 1
        if visited[0] > node_budget:
            return
        nonlocal best_sol
        if peak >= best_sol[0]:
            return
        if not order_left:
            off = {b.name: o for b, o in placed}
            best_sol = (peak, off)
            return
        for i, b in enumerate(order_left):
            conflicts = sorted(
                [(o, o + p.size) for p, o in placed if _overlaps(p, b)])
            # candidate offsets: 0 and each conflict end
            cands = [0] + [hi for _, hi in conflicts]
            for off in cands:
                ok = all(off + b.size <= lo or off >= hi
                         for lo, hi in conflicts)
                if not ok:
                    continue
                place(order_left[:i] + order_left[i + 1:],
                      placed + [(b, off)], max(peak, off + b.size))
                break  # first-fit per buffer within this order branch

    place(sorted(real, key=lambda x: -x.size), [], 0)
    peak, offsets = best_sol
    for b in buffers:
        if b.alias_of is not None:
            offsets[b.name] = offsets.get(b.alias_of, 0)
        elif b.size == 0:
            offsets.setdefault(b.name, 0)
    return offsets, peak


def naive_peak(buffers: List[BufferSpec]) -> int:
    """No-reuse allocation (sum of all sizes) — the baseline the planner beats."""
    return sum(b.size for b in buffers if b.alias_of is None)


def validate_plan(buffers: List[BufferSpec], offsets: Dict[str, int]) -> bool:
    real = [b for b in buffers if b.alias_of is None and b.size > 0]
    for a, b in itertools.combinations(real, 2):
        if _overlaps(a, b):
            ao, bo = offsets[a.name], offsets[b.name]
            if not (ao + a.size <= bo or bo + b.size <= ao):
                return False
    return True
