"""MCTS structural search (§3.2.1).

Nodes are TileGraph states; edges are merge/reorder actions; the *Simulation*
phase is NOT a random rollout — per the paper it calls the MINLP parametric
solver as a deterministic evaluator, and the reward is 1/latency.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.schedule.minlp import MINLPSolver, Schedule
from repro_torch.core.schedule.tile_graph import TileGraph


def enumerate_actions(tg: TileGraph) -> List[Tuple[str, tuple]]:
    acts: List[Tuple[str, tuple]] = []
    ng = len(tg.groups)
    for src in range(ng):
        for dst in range(ng):
            if src != dst and tg.merge(src, dst) is not None:
                acts.append(("merge", (src, dst)))
    for gi, g in enumerate(tg.groups):
        n = len(g.order)
        if n <= 1:
            continue
        # adjacent swaps + full reversal keep branching factor sane
        for a in range(n - 1):
            perm = list(range(n))
            perm[a], perm[a + 1] = perm[a + 1], perm[a]
            if tg.reorder(gi, tuple(perm)) is not None:
                acts.append(("reorder", (gi, tuple(perm))))
    return acts


def apply_action(tg: TileGraph, act) -> Optional[TileGraph]:
    kind, args = act
    return tg.merge(*args) if kind == "merge" else tg.reorder(*args)


@dataclasses.dataclass
class Node:
    state: TileGraph
    parent: Optional["Node"]
    action: Optional[tuple]
    children: List["Node"] = dataclasses.field(default_factory=list)
    untried: Optional[List[tuple]] = None
    visits: int = 0
    value: float = 0.0          # sum of rewards
    reward: float = 0.0         # this state's own evaluation


class MCTS:
    def __init__(self, solver: Optional[MINLPSolver] = None,
                 c_uct: float = 0.7, seed: int = 0, hw: Hardware = H100):
        self.solver = solver or MINLPSolver(hw=hw)
        self.c = c_uct
        self.rng = random.Random(seed)
        self.eval_cache: Dict[TileGraph, Schedule] = {}

    def evaluate(self, tg: TileGraph) -> Schedule:
        if tg not in self.eval_cache:
            self.eval_cache[tg] = self.solver.solve(tg)
        return self.eval_cache[tg]

    def search(self, root_state: TileGraph, iterations: int = 40
               ) -> Tuple[TileGraph, Schedule]:
        root = Node(root_state, None, None)
        root.untried = enumerate_actions(root_state)
        best: Tuple[float, TileGraph, Schedule] = (
            self.evaluate(root_state).latency, root_state,
            self.evaluate(root_state))

        for _ in range(iterations):
            node = root
            # 1. Selection
            while not node.untried and node.children:
                node = max(node.children, key=lambda ch: (
                    ch.value / max(1, ch.visits)
                    + self.c * math.sqrt(math.log(node.visits + 1)
                                         / max(1, ch.visits))))
            # 2. Expansion
            if node.untried:
                act = node.untried.pop(
                    self.rng.randrange(len(node.untried)))
                child_state = apply_action(node.state, act)
                if child_state is None:
                    continue
                child = Node(child_state, node, act)
                child.untried = enumerate_actions(child_state)
                node.children.append(child)
                node = child
            # 3. Simulation = deterministic MINLP evaluation
            sched = self.evaluate(node.state)
            reward = 0.0 if not sched.feasible else 1.0 / (sched.latency + 1e-12)
            node.reward = reward
            if sched.feasible and sched.latency < best[0]:
                best = (sched.latency, node.state, sched)
            # 4. Backpropagation
            while node is not None:
                node.visits += 1
                node.value += reward
                node = node.parent
        return best[1], best[2]


def auto_schedule(tg: TileGraph, iterations: int = 40, seed: int = 0,
                  hw: Hardware = H100
                  ) -> Tuple[TileGraph, Schedule, Schedule]:
    """Returns (best structure, its schedule, the unfused baseline schedule)
    on ``hw``."""
    mcts = MCTS(seed=seed, hw=hw)
    baseline = mcts.evaluate(tg)
    state, sched = mcts.search(tg, iterations=iterations)
    return state, sched, baseline
