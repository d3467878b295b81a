"""Optimal-program extraction from a saturated e-graph (§3.1.1).

Two extractors:

  * ``greedy_extract`` — fixpoint DP over e-classes (egg-style); fast, optimal
    for tree costs, used as cross-check and as the WPMaxSAT warm start.
  * ``wpmaxsat_extract`` — Weighted Partial MaxSAT formulation: one selection
    variable per e-node, hard clauses encode "an active class selects >= 1
    node" + "selected node activates child classes", soft clauses charge each
    node's roofline cost.  Cycles (created by saturation) are eliminated
    CEGAR-style: if the chosen subgraph is cyclic, a blocking clause is added
    and the solver re-runs.

All return (total_cost, {eclass_id: chosen ENode}).  Without a ``cost_fn``
each charges ``cost_model.node_cost`` on the ``hw`` record.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.cost_model import node_cost
from repro_torch.core.egraph import EGraph, ENode
from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.sat import wpmaxsat


def greedy_extract(eg: EGraph, root: int,
                   cost_fn: Optional[Callable] = None, hw: Hardware = H100):
    cost_fn = cost_fn or (lambda n: node_cost(eg, n, hw=hw))
    root = eg.find(root)
    best: Dict[int, Tuple[float, ENode]] = {}
    changed = True
    it = 0
    while changed and it < 10 * len(eg.classes) + 10:
        changed = False
        it += 1
        for cid in eg.eclasses():
            for node in eg.nodes(cid):
                c = cost_fn(node)
                ok = True
                for ch in node.children:
                    ch = eg.find(ch)
                    if ch not in best:
                        ok = False
                        break
                    c += best[ch][0]
                if ok and (cid not in best or c < best[cid][0] - 1e-15):
                    best[cid] = (c, node)
                    changed = True
    if root not in best:
        raise ValueError("root not extractable")
    choice = {}

    def walk(cid):
        cid = eg.find(cid)
        if cid in choice:
            return
        _, node = best[cid]
        choice[cid] = node
        for ch in node.children:
            walk(ch)
    walk(root)
    # DAG cost: each selected class counted once
    total = sum(cost_fn(n) for n in choice.values())
    return total, choice


def _has_cycle(eg: EGraph, choice: Dict[int, ENode], root: int):
    """Return a cycle (list of class ids) in the selected subgraph, or None."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {}
    stack_path = []

    def dfs(cid):
        cid = eg.find(cid)
        c = color.get(cid, WHITE)
        if c == GRAY:
            i = stack_path.index(cid)
            return stack_path[i:]
        if c == BLACK or cid not in choice:
            return None
        color[cid] = GRAY
        stack_path.append(cid)
        for ch in choice[cid].children:
            cyc = dfs(ch)
            if cyc:
                return cyc
        stack_path.pop()
        color[cid] = BLACK
        return None

    return dfs(root)


def wpmaxsat_extract(eg: EGraph, root: int,
                     cost_fn: Optional[Callable] = None,
                     memory_limit: Optional[Tuple[Callable, float]] = None,
                     max_cegar_rounds: int = 20, hw: Hardware = H100):
    """WPMaxSAT extraction with optional hard memory constraint.

    memory_limit: (mem_fn(node) -> bytes, capacity) — enforced CEGAR-style:
    oversized selections are blocked and the solver re-runs (§3.1.3's hard
    memory-capacity constraint).
    """
    cost_fn = cost_fn or (lambda n: node_cost(eg, n, hw=hw))
    root = eg.find(root)

    # variable numbering
    node_var: Dict[Tuple[int, ENode], int] = {}
    class_var: Dict[int, int] = {}
    v = 0
    for cid in eg.eclasses():
        v += 1
        class_var[cid] = v
        for n in eg.nodes(cid):
            v += 1
            node_var[(cid, n)] = v
    n_vars = v

    hard = []
    # root class is active
    hard.append([class_var[root]])
    for cid in eg.eclasses():
        nodes = list(eg.nodes(cid))
        # class active -> one of its nodes selected
        hard.append([-class_var[cid]] + [node_var[(cid, n)] for n in nodes])
        for n in nodes:
            nv = node_var[(cid, n)]
            # node selected -> its class active
            hard.append([-nv, class_var[cid]])
            # node selected -> child classes active
            for ch in n.children:
                hard.append([-nv, class_var[eg.find(ch)]])

    # soft: each node selection costs its roofline latency (scaled to ints-ish)
    soft = []
    for (cid, n), nv in node_var.items():
        w = max(cost_fn(n), 0.0)
        if w > 0:
            soft.append((-nv, w))

    # warm start upper bound from greedy (only usable when no memory cap:
    # the cap may force strictly costlier solutions than the greedy optimum)
    greedy_sol = None
    try:
        greedy_sol = greedy_extract(eg, root, cost_fn)
    except ValueError:
        pass
    ub = greedy_sol[0] + 1e-9 if (greedy_sol and memory_limit is None) else None

    # admissible extra lower bound: every active class with no node selected
    # yet must eventually pay at least its cheapest not-yet-excluded node.
    class_nodes = {cid: [(cost_fn(n), node_var[(cid, n)])
                         for n in eg.nodes(cid)] for cid in eg.eclasses()}
    for v_ in class_nodes.values():
        v_.sort()

    def lb_extra(assign):
        extra = 0.0
        for cid, entries in class_nodes.items():
            if not assign.get(class_var[cid]):
                continue
            picked = False
            cheapest = None
            for c, nv in entries:
                st = assign.get(nv)
                if st is True:
                    picked = True
                    break
                if st is None and cheapest is None:
                    cheapest = c
            if not picked and cheapest:
                extra += cheapest
        return extra

    for _ in range(max_cegar_rounds):
        res = wpmaxsat(n_vars, hard, soft, ub_init=ub, lb_extra=lb_extra)
        if res is None:
            if greedy_sol is not None and memory_limit is None:
                # SAT search found nothing better than the greedy warm start
                total, choice = greedy_sol
                cyc = _has_cycle(eg, choice, root)
                if cyc is None:
                    return total, choice
            raise ValueError("extraction UNSAT (or infeasible under memory cap)")
        choice: Dict[int, ENode] = {}
        for (cid, n), nv in node_var.items():
            if res.assignment.get(nv):
                # keep the cheapest selected node per class
                if cid not in choice or cost_fn(n) < cost_fn(choice[cid]):
                    choice[cid] = n
        cyc = _has_cycle(eg, choice, root)
        if cyc is not None:
            # block this cyclic combination
            hard.append([-node_var[(c, choice[c])] for c in cyc])
            continue
        if memory_limit is not None:
            mem_fn, cap = memory_limit
            reach = _reachable(eg, choice, root)
            used = sum(mem_fn(choice[c]) for c in reach)
            if used > cap:
                # block the MINIMAL over-capacity prefix (strongest clause):
                # the largest-memory selected nodes that together exceed cap
                by_mem = sorted(reach, key=lambda c: -mem_fn(choice[c]))
                prefix, s = [], 0
                for c in by_mem:
                    prefix.append(c)
                    s += mem_fn(choice[c])
                    if s > cap:
                        break
                hard.append([-node_var[(c, choice[c])] for c in prefix])
                continue
        reach = _reachable(eg, choice, root)
        total = sum(cost_fn(choice[c]) for c in reach)
        return total, {c: choice[c] for c in reach}
    raise ValueError("CEGAR rounds exhausted")


def _reachable(eg, choice, root):
    seen = set()

    def walk(cid):
        cid = eg.find(cid)
        if cid in seen or cid not in choice:
            return
        seen.add(cid)
        for ch in choice[cid].children:
            walk(ch)
    walk(root)
    return seen


def branch_bound_extract(eg: EGraph, root: int,
                         cost_fn: Optional[Callable] = None,
                         mem_fn: Optional[Callable] = None,
                         cap: Optional[float] = None,
                         node_budget: int = 500000, hw: Hardware = H100):
    """Exact branch & bound extraction specialized to e-graphs.

    Explores only classes reachable from the root, selecting one e-node per
    class in DFS order.  Monotone accumulation of cost and memory makes both
    the cost bound and the hard memory cap ({mem_fn, cap}) strong pruners —
    this is what makes the §3.1.3 memory-constrained extraction practical at
    distribution-search sizes (the generic WPMaxSAT handles the
    unconstrained case).  Returns (cost, {class: node}).
    """
    cost_fn = cost_fn or (lambda n: node_cost(eg, n, hw=hw))
    root = eg.find(root)

    # admissible per-class lower bound from the greedy DP (tree-cost)
    dp: Dict[int, float] = {}
    changed = True
    while changed:
        changed = False
        for cid in eg.eclasses():
            for n in eg.nodes(cid):
                c = cost_fn(n)
                ok = True
                for ch in n.children:
                    ch = eg.find(ch)
                    if ch not in dp:
                        ok = False
                        break
                    c += dp[ch]
                if ok and (cid not in dp or c < dp[cid] - 1e-18):
                    dp[cid] = c
                    changed = True
    if root not in dp:
        raise ValueError("root not extractable")

    best: List = [None, float("inf")]
    visited = [0]

    def bb(pending: List[int], chosen: Dict[int, ENode], cost: float,
           mem: float):
        visited[0] += 1
        if visited[0] > node_budget:
            return
        if cap is not None and mem > cap:
            return
        # admissible bound: the most expensive unresolved class must be paid
        lb = cost + max((dp.get(c, 0.0) for c in pending if c not in chosen),
                        default=0.0)
        if lb >= best[1]:
            return
        while pending and eg.find(pending[-1]) in chosen:
            pending = pending[:-1]
        if not pending:
            if _has_cycle(eg, chosen, root) is None:
                best[0], best[1] = dict(chosen), cost
            return
        cid = eg.find(pending[-1])
        rest = pending[:-1]
        nodes = sorted(eg.nodes(cid),
                       key=lambda n: cost_fn(n) + sum(
                           dp.get(eg.find(c), 0.0) for c in n.children))
        for n in nodes:
            ok = all(eg.find(c) in dp for c in n.children)
            if not ok:
                continue
            chosen[cid] = n
            new_pending = rest + [eg.find(c) for c in n.children
                                  if eg.find(c) not in chosen]
            m = mem_fn(n) if mem_fn else 0.0
            bb(new_pending, chosen, cost + cost_fn(n), mem + m)
            del chosen[cid]

    bb([root], {}, 0.0, 0.0)
    if best[0] is None:
        raise ValueError("branch-bound extraction found no feasible solution")
    reach = _reachable(eg, best[0], root)
    return best[1], {c: best[0][c] for c in reach}


def extract_term(eg: EGraph, root: int, choice: Dict[int, ENode]):
    """Materialize the chosen subgraph back into a Term tree."""
    from repro_torch.core.tensor_ir import Term

    memo = {}

    def build(cid):
        cid = eg.find(cid)
        if cid in memo:
            return memo[cid]
        n = choice[cid]
        t = Term(n.op, tuple(build(c) for c in n.children), n.attrs)
        memo[cid] = t
        return t

    return build(root)
