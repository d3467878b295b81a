"""Tiered Tile Graphs (§3.2): the structural half of the schedule space.

A schedule state is a list of *groups*; each group is one on-chip-level loop
nest executing one or more fused ops (Eq. 3's Op^n nesting, flattened to the
three GPU memory tiers device memory -> shared memory -> registers).  Group loop ORDER is explicit —
it drives the buffer-reuse traffic model in the MINLP.

Actions (MCTS edges, §3.2.1):
  * merge(src, dst)      — operator fusion at the shared-memory level: the
    producer group's ops join the consumer group; the intermediate buffer
    stops touching device memory (Fig. 7's green dashed box).
  * reorder(group, perm) — loop permutation within a group's nest.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Buffer:
    name: str
    index: Tuple[str, ...]          # which loops address this buffer
    elem_bytes: int = 2


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    ukernel: str
    loops: Tuple[str, ...]          # iteration dims of this op
    reads: Tuple[Buffer, ...]
    write: Buffer


@dataclasses.dataclass(frozen=True)
class Group:
    ops: Tuple[str, ...]            # op names, producer -> consumer order
    order: Tuple[str, ...]          # loop order, outermost first


@dataclasses.dataclass(frozen=True)
class TileGraph:
    ops: Tuple[OpSpec, ...]
    extents: Tuple[Tuple[str, int], ...]   # loop name -> extent
    groups: Tuple[Group, ...]

    def extent(self, loop: str) -> int:
        for k, v in self.extents:
            if k == loop:
                return v
        raise KeyError(loop)

    def op(self, name: str) -> OpSpec:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    # -- structural actions --------------------------------------------------
    def merge(self, src: int, dst: int) -> Optional["TileGraph"]:
        """Fuse group src into group dst (src's last op must feed dst's first)."""
        if src == dst or src >= len(self.groups) or dst >= len(self.groups):
            return None
        gs, gd = self.groups[src], self.groups[dst]
        prod = self.op(gs.ops[-1])
        cons = self.op(gd.ops[0])
        if prod.write.name not in [b.name for b in cons.reads]:
            return None
        loops = list(gs.order) + [l for l in gd.order if l not in gs.order]
        merged = Group(gs.ops + gd.ops, tuple(loops))
        groups = [g for i, g in enumerate(self.groups) if i not in (src, dst)]
        groups.insert(min(src, dst), merged)
        return dataclasses.replace(self, groups=tuple(groups))

    def reorder(self, gi: int, perm: Tuple[int, ...]) -> Optional["TileGraph"]:
        if gi >= len(self.groups):
            return None
        g = self.groups[gi]
        if sorted(perm) != list(range(len(g.order))):
            return None
        new_order = tuple(g.order[p] for p in perm)
        if new_order == g.order:
            return None
        groups = list(self.groups)
        groups[gi] = Group(g.ops, new_order)
        return dataclasses.replace(self, groups=tuple(groups))

    # -- group-level buffer classification ------------------------------------
    def group_buffers(self, gi: int):
        """Returns (hbm_buffers, intermediate_buffers) for group gi.
        Intermediates are produced AND consumed inside the group (stay in
        shared memory); everything else moves through device memory."""
        g = self.groups[gi]
        produced = {self.op(o).write.name: self.op(o).write for o in g.ops}
        consumed = {}
        for o in g.ops:
            for b in self.op(o).reads:
                consumed[b.name] = b
        inter, hbm = [], []
        for name, b in produced.items():
            (inter if name in consumed else hbm).append(b)
        for name, b in consumed.items():
            if name not in produced:
                hbm.append(b)
        return hbm, inter


# ---------------------------------------------------------------------------
# Builders for the paper's running examples
# ---------------------------------------------------------------------------

def matmul_tile_graph(M: int, N: int, K: int, dtype_bytes: int = 2) -> TileGraph:
    A = Buffer("A", ("i", "k"), dtype_bytes)
    B = Buffer("B", ("k", "j"), dtype_bytes)
    C = Buffer("C", ("i", "j"), dtype_bytes)
    op = OpSpec("mm", "matmul", ("i", "j", "k"), (A, B), C)
    return TileGraph((op,), (("i", M), ("j", N), ("k", K)),
                     (Group(("mm",), ("i", "j", "k")),))


def attention_tile_graph(S: int, D: int, dtype_bytes: int = 2) -> TileGraph:
    """Fig. 7: O = MatMul(Exp(MatMul(Q, K)), V); loops i (q rows), l (kv rows),
    k (head dim), j (head dim out)."""
    Q = Buffer("Q", ("i", "k"), dtype_bytes)
    K = Buffer("K", ("k", "l"), dtype_bytes)
    Sb = Buffer("S", ("i", "l"), dtype_bytes)
    E = Buffer("E", ("i", "l"), dtype_bytes)
    V = Buffer("V", ("l", "j"), dtype_bytes)
    O = Buffer("O", ("i", "j"), dtype_bytes)
    mm1 = OpSpec("mm1", "matmul", ("i", "l", "k"), (Q, K), Sb)
    ex = OpSpec("exp", "exp", ("i", "l"), (Sb,), E)
    mm2 = OpSpec("mm2", "matmul", ("i", "j", "l"), (E, V), O)
    return TileGraph(
        (mm1, ex, mm2),
        (("i", S), ("l", S), ("k", D), ("j", D)),
        (Group(("mm1",), ("i", "l", "k")),
         Group(("exp",), ("i", "l")),
         Group(("mm2",), ("i", "j", "l"))),
    )


def mlp_tile_graph(T: int, D: int, F: int, dtype_bytes: int = 2) -> TileGraph:
    """h = silu(x @ w1); y = h @ w2."""
    X = Buffer("X", ("i", "k"), dtype_bytes)
    W1 = Buffer("W1", ("k", "f"), dtype_bytes)
    H0 = Buffer("H0", ("i", "f"), dtype_bytes)
    H = Buffer("H", ("i", "f"), dtype_bytes)
    W2 = Buffer("W2", ("f", "j"), dtype_bytes)
    Y = Buffer("Y", ("i", "j"), dtype_bytes)
    mm1 = OpSpec("mm1", "matmul", ("i", "f", "k"), (X, W1), H0)
    act = OpSpec("silu", "silu", ("i", "f"), (H0,), H)
    mm2 = OpSpec("mm2", "matmul", ("i", "j", "f"), (H, W2), Y)
    return TileGraph(
        (mm1, act, mm2),
        (("i", T), ("f", F), ("k", D), ("j", D)),
        (Group(("mm1",), ("i", "f", "k")),
         Group(("silu",), ("i", "f")),
         Group(("mm2",), ("i", "j", "f"))),
    )
