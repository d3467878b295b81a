"""DPLL SAT + branch-and-bound Weighted Partial MaxSAT (§3.1.1 extraction).

Self-contained (the paper uses an external SAT solver via OR-Tools; we keep
the whole pipeline in-repo).  Variables are 1-based ints; literals are signed
ints.  Hard clauses must all be satisfied; soft clauses are unit literals with
weights — the solver minimizes the total weight of *violated* soft clauses.

Scale target: e-graphs of a few thousand e-nodes (unit propagation dominates;
the branch-and-bound rarely explores deeply because selection variables are
heavily constrained by the class/child implications).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class UNSAT(Exception):
    pass


def _unit_propagate(clauses: List[List[int]], assign: Dict[int, bool]):
    """In-place propagation; returns list of newly assigned vars or raises."""
    trail = []
    changed = True
    while changed:
        changed = False
        for cl in clauses:
            unassigned = None
            n_unassigned = 0
            sat = False
            for lit in cl:
                v, want = abs(lit), lit > 0
                if v in assign:
                    if assign[v] == want:
                        sat = True
                        break
                else:
                    unassigned = lit
                    n_unassigned += 1
            if sat:
                continue
            if n_unassigned == 0:
                raise UNSAT()
            if n_unassigned == 1:
                v, want = abs(unassigned), unassigned > 0
                assign[v] = want
                trail.append(v)
                changed = True
    return trail


def sat_solve(n_vars: int, clauses: Sequence[Sequence[int]],
              assumptions: Sequence[int] = ()) -> Optional[Dict[int, bool]]:
    """Plain DPLL; returns assignment dict or None if UNSAT."""
    clauses = [list(c) for c in clauses]
    assign: Dict[int, bool] = {}
    for lit in assumptions:
        assign[abs(lit)] = lit > 0
    try:
        _unit_propagate(clauses, assign)
    except UNSAT:
        return None

    def rec(assign: Dict[int, bool]) -> Optional[Dict[int, bool]]:
        # pick an unassigned var from the shortest unsatisfied clause
        best_cl, best_len = None, 1 << 30
        for cl in clauses:
            sat, free = False, []
            for lit in cl:
                v = abs(lit)
                if v in assign:
                    if assign[v] == (lit > 0):
                        sat = True
                        break
                else:
                    free.append(lit)
            if not sat and free and len(free) < best_len:
                best_cl, best_len = free, len(free)
        if best_cl is None:
            return assign
        lit = best_cl[0]
        for val in (lit > 0, lit < 0):
            a2 = dict(assign)
            a2[abs(lit)] = val
            try:
                _unit_propagate(clauses, a2)
            except UNSAT:
                continue
            r = rec(a2)
            if r is not None:
                return r
        return None

    return rec(assign)


@dataclasses.dataclass
class WPMaxSATResult:
    assignment: Dict[int, bool]
    cost: float
    optimal: bool = True


def wpmaxsat(n_vars: int, hard: Sequence[Sequence[int]],
             soft: Sequence[Tuple[int, float]],
             time_budget_nodes: int = 200000,
             ub_init: Optional[float] = None,
             lb_extra=None) -> Optional[WPMaxSATResult]:
    """Branch & bound weighted partial MaxSAT.

    `soft` is a list of (literal, weight): satisfying the literal is free,
    violating costs `weight`.  Returns the minimum-cost assignment found
    (optimal=False if the node budget was exhausted first).

    ub_init: known upper bound (e.g. a greedy solution's cost) — branches
    costing >= it are pruned even before any solution is found here.
    lb_extra(assign) -> float: admissible extra lower bound added to the
    violated-soft cost (problem-structure aware, e.g. min cost-to-go).
    """
    hard = [list(c) for c in hard]
    soft_by_var: Dict[int, List[Tuple[int, float]]] = {}
    for lit, w in soft:
        soft_by_var.setdefault(abs(lit), []).append((lit, w))

    best: List[Optional[WPMaxSATResult]] = [None]
    bound: List[float] = [float("inf") if ub_init is None else ub_init]
    nodes_visited = [0]
    truncated = [False]

    def soft_cost(assign: Dict[int, bool]) -> float:
        c = 0.0
        for v, entries in soft_by_var.items():
            if v in assign:
                for lit, w in entries:
                    if assign[v] != (lit > 0):
                        c += w
        return c

    def soft_weight_if_true(v: int) -> float:
        w = 0.0
        for lit, wt in soft_by_var.get(v, ()):
            if lit < 0:
                w += wt
        return w

    def rec(assign: Dict[int, bool]):
        nodes_visited[0] += 1
        if nodes_visited[0] > time_budget_nodes:
            truncated[0] = True
            return
        lb = soft_cost(assign)
        if lb_extra is not None:
            lb += lb_extra(assign)
        if lb >= bound[0] - 1e-15:
            return
        # find branching clause (shortest unsatisfied hard clause first)
        best_cl, best_len = None, 1 << 30
        for cl in hard:
            sat, free = False, []
            for lit in cl:
                v = abs(lit)
                if v in assign:
                    if assign[v] == (lit > 0):
                        sat = True
                        break
                else:
                    free.append(lit)
            if not sat:
                if not free:
                    return  # violated hard clause
                if len(free) < best_len:
                    best_cl, best_len = free, len(free)
        if best_cl is None:
            # all hard satisfied: assign remaining soft vars to their free value
            final = dict(assign)
            for v, entries in soft_by_var.items():
                if v not in final:
                    # choose value that violates nothing
                    lit, _ = entries[0]
                    final[v] = lit > 0
            cost = soft_cost(final)
            if best[0] is None or cost < best[0].cost:
                best[0] = WPMaxSATResult(final, cost)
                bound[0] = min(bound[0], cost)
            return
        # branch on the literal that satisfies the clause at minimum soft
        # cost, SATISFYING polarity first — finds a full solution fast, after
        # which bound pruning takes over.
        lit = min(best_cl,
                  key=lambda l: soft_weight_if_true(abs(l)) if l > 0 else 0.0)
        v = abs(lit)
        for val in (lit > 0, lit < 0):
            a2 = dict(assign)
            a2[v] = val
            try:
                _unit_propagate(hard, a2)
            except UNSAT:
                continue
            rec(a2)

    a0: Dict[int, bool] = {}
    try:
        _unit_propagate(hard, a0)
    except UNSAT:
        return None
    rec(a0)
    if best[0] is not None:
        best[0].optimal = not truncated[0]
    return best[0]
