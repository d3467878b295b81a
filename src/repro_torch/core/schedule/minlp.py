"""Parametric optimization via MINLP (§3.2.2).

Given a structural state (TileGraph), solve for on-chip tile sizes and
buffer placement minimizing  max(T_mem, T_comp)  (Eq. 16) subject to:

  * domain coverage  — tiles divide loop extents (Eq. 10),
  * on-chip capacity — sum of resident (double-buffered) tiles + fused
    intermediates <= ``hw.onchip_bytes`` (Eq. 14; 227 KB of shared memory
    per block on the H100),
  * fusion           — intermediates of fused groups stay on chip (Eq. 13).

T_comp uses the NTT μkernel linear timing model x trip counts (Eq. 15);
T_mem is the device-memory <-> shared-memory traffic under the
loop-order-aware reuse model:
a buffer is re-streamed by every loop outside its residency scope that does
not index it (this is where ``reorder`` earns its keep).

Solver: branch & bound over divisor-constrained integer tiles — integer
variables + nonlinear objective + hard capacity constraints, i.e. a small
special-purpose MINLP (the paper uses OR-Tools; we stay self-contained).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.schedule.ntt import ukernel_time
from repro_torch.core.schedule.tile_graph import TileGraph


def _divisors(n: int, align: int, cap: int = 4096) -> List[int]:
    out = [d for d in range(1, min(n, cap) + 1) if n % d == 0]
    # keep the search tractable: powers of two + hw-aligned + extremes
    keep = sorted({d for d in out
                   if d in (1, n) or d % align == 0 or (d & (d - 1)) == 0})
    return keep


@dataclasses.dataclass
class Schedule:
    tiles: Dict[int, Dict[str, int]]        # group -> loop -> tile
    latency: float
    t_mem: float
    t_comp: float
    smem_peak: int                          # on-chip bytes of the largest group
    feasible: bool = True


def _group_eval(tg: TileGraph, gi: int, tiles: Dict[str, int],
                hw: Hardware = H100) -> Optional[Tuple[float, float, int]]:
    """(t_mem, t_comp, on-chip bytes) for one group under `tiles`, or None
    if the tiling exceeds ``hw.onchip_bytes``."""
    g = tg.groups[gi]
    order = g.order
    trips = {l: tg.extent(l) // tiles[l] for l in order}
    pos = {l: i for i, l in enumerate(order)}
    hbm, inter = tg.group_buffers(gi)

    def tile_elems(buf) -> int:
        n = 1
        for l in buf.index:
            n *= tiles[l] if l in tiles else 1
        return n

    # on-chip residency: tiles of every buffer touched + fused intermediates
    onchip = 0
    for b in hbm:
        onchip += hw.double_buffer * tile_elems(b) * b.elem_bytes
    for b in inter:
        onchip += tile_elems(b) * b.elem_bytes
    if onchip > hw.onchip_bytes:
        return None

    # device-memory traffic with reuse model
    t_bytes = 0
    for b in hbm:
        reload_loops = 1
        idx = set(b.index)
        max_idx_pos = max((pos[l] for l in b.index if l in pos), default=-1)
        for l in order:
            if l in idx:
                reload_loops *= trips[l]
            elif pos[l] < max_idx_pos:
                # an outer loop not indexing b forces re-streaming
                reload_loops *= trips[l]
        t_bytes += tile_elems(b) * b.elem_bytes * reload_loops
    t_mem = t_bytes / hw.mem_bw

    # compute time: μkernel model per op x its trip count
    t_comp = 0.0
    for opname in g.ops:
        op = tg.op(opname)
        trip = 1
        for l in order:
            if l in op.loops:
                trip *= trips[l]
        tile_work = 1
        for l in op.loops:
            tile_work *= tiles.get(l, 1)
        t_comp += trip * ukernel_time(op.ukernel, tile_work, hw)
    return t_mem, t_comp, onchip


class MINLPSolver:
    """Branch & bound over per-group divisor-constrained tiles."""

    def __init__(self, max_candidates_per_loop: int = 12,
                 beam: int = 64, hw: Hardware = H100):
        self.max_cands = max_candidates_per_loop
        self.beam = beam
        self.hw = hw

    def solve_group(self, tg: TileGraph, gi: int):
        g = tg.groups[gi]
        loops = list(g.order)
        cands = {}
        for l in loops:
            ds = _divisors(tg.extent(l), self.hw.tile_align)
            # hardware alignment: prefer >= μkernel tile on matmul dims
            if len(ds) > self.max_cands:
                step = len(ds) / self.max_cands
                ds = sorted({ds[int(i * step)] for i in range(self.max_cands)}
                            | {ds[-1]})
            cands[l] = ds

        best: Optional[Tuple[float, Dict[str, int], Tuple]] = None
        # beam over loops: partial assignment keeps optimistic bound
        partials: List[Dict[str, int]] = [{}]
        for l in loops:
            nxt = []
            for p in partials:
                for d in cands[l]:
                    q = dict(p)
                    q[l] = d
                    nxt.append(q)
            # score partials optimistically: fill remaining loops with full
            # extent (max reuse) ignoring capacity; keep the best `beam`
            scored = []
            for q in nxt:
                full = dict(q)
                for l2 in loops:
                    full.setdefault(l2, tg.extent(l2))
                ev = _group_eval(tg, gi, full, self.hw)
                opt = max(ev[0], ev[1]) if ev else float("inf")
                scored.append((opt if ev else 1e30, q))
            scored.sort(key=lambda x: x[0])
            partials = [q for _, q in scored[:self.beam]]
        for q in partials:
            ev = _group_eval(tg, gi, q, self.hw)
            if ev is None:
                continue
            lat = max(ev[0], ev[1])
            if best is None or lat < best[0]:
                best = (lat, q, ev)
        if best is None:
            return None
        lat, tiles, (tm, tc, vm) = best
        return lat, tiles, tm, tc, vm

    def solve(self, tg: TileGraph) -> Schedule:
        total_lat = t_mem = t_comp = 0.0
        peak = 0
        all_tiles: Dict[int, Dict[str, int]] = {}
        for gi in range(len(tg.groups)):
            r = self.solve_group(tg, gi)
            if r is None:
                return Schedule({}, float("inf"), float("inf"), float("inf"),
                                0, feasible=False)
            lat, tiles, tm, tc, vm = r
            all_tiles[gi] = tiles
            total_lat += lat
            t_mem += tm
            t_comp += tc
            peak = max(peak, vm)
        return Schedule(all_tiles, total_lat, t_mem, t_comp, peak)
