"""Per-device cost analysis of one step (train, prefill or decode), and
its roofline terms
(the port of ``src/repro/launch/hlo_analysis.py``; the name is kept so a
reader finds the counterpart).

The reference compiles a step and reads the scheduled HLO: dot FLOPs, the
bytes every op writes, the collectives with their replica groups.  The port
runs eagerly and has no HLO: it counts the ops one call of the step
dispatches.  ``analyze_step(fn, *args)`` runs ``fn(*args)`` once (a train
step's forward, backward and optimizer together; a prefill or decode
step) under a ``TorchDispatchMode`` and gives, per device:

  * ``flops``: the matrix products (mm, bmm, addmm, baddbmm, which
    ``einsum`` and ``matmul`` lower to) by ``torch.utils.flop_counter``'s
    formulas, 2 x result x contracted as the reference counts a dot, plus
    what the kernel wrappers report for their calls
    (``repro_torch.kernels.costed``: the reference's dots for the same
    call, whatever implements it);
  * ``bytes_traffic``: 2 x the bytes of every op's results (one write and
    one read), views, metadata, fills and fresh allocations skipped as the
    reference skips parameters, bitcasts, constants, iotas and broadcasts;
  * ``collectives``: by kind, from the mesh's record (a ``DryTrainMesh``'s
    ``log``), in the reference's units: an all-gather's bytes are its
    result's (the group's parts together), an all-reduce's its payload's;
  * ``argument_bytes``: the storages of ``args``, each counted once;
  * ``peak_bytes``: the most bytes alive at once, the arguments included
    (every storage an op makes is tracked until it is freed);
  * ``launches``: the kernel wrappers' calls, by kernel.

It counts ``meta`` tensors (the dry run) and real ones alike: on CUDA
tensors the kernels launch and report the same counts.

``collective_time_s`` and ``roofline_terms`` follow the reference's
alpha-beta and roofline formulas with every rate from a ``Hardware``
record: a collective whose groups lie within one node of
``node_devices`` consecutive ranks moves at ``link_bw``, one that crosses
nodes at ``net_bw``.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import kernels

aten = torch.ops.aten

# matrix products and their FLOP formulas (torch.utils.flop_counter's)
_MATMULS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm)
# ops that write no data of their own: fresh allocations, fills and
# ranges (the reference's constants, broadcasts and iotas); views are
# skipped by their schema
_NO_DATA = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
            aten.new_empty_strided, aten.zeros, aten.zeros_like,
            aten.new_zeros, aten.ones, aten.ones_like, aten.new_ones,
            aten.full, aten.full_like, aten.new_full, aten.scalar_tensor,
            aten.arange, aten.zero_, aten.fill_, aten.lift_fresh,
            aten.detach, aten._local_scalar_dense}
# the reference's collective kinds for the mesh's
COLLECTIVE_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Analyzer(TorchDispatchMode):
    """The counts of one ``analyze_step``; also the kernel wrappers' hook
    (``kernels.analyzer``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.launches: Counter = Counter()
        self.kernel_flops: Counter = Counter()
        self.muted = 0
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}
        from torch.utils.flop_counter import flop_registry
        self._formulas = {op: flop_registry[op] for op in _MATMULS}

    # -- storages alive ------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive:
            return
        n = st.nbytes()
        self._alive[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        n = self._alive.pop(key, 0)
        self.live -= n

    # -- ops -----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        if self.muted:
            return out
        packet = func._overloadpacket
        formula = self._formulas.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not (func.is_view or packet in _NO_DATA
                or func.namespace == "c10d"):
            self.bytes += sum(_nbytes(t) for t in outs)
        return out

    def kernel(self, name: str, flops: int, fn, *args):
        """One kernel wrapper call (``kernels.costed``)."""
        self.muted += 1
        try:
            out = fn(*args)
        finally:
            self.muted -= 1
        self.launches[name] += 1
        self.kernel_flops[name] += flops
        self.flops += flops
        self.bytes += sum(_nbytes(t) for t in tree_flatten(out)[0])
        return out


def mesh_collectives(mesh, node_devices: int) -> Dict:
    """A ``DryTrainMesh``'s record as the reference's ``collectives``:
    {kind: {"bytes", "count", "max_group", "net_bytes", "net_count"}},
    the ``net_`` part over groups that cross a node of ``node_devices``
    consecutive ranks.  A group of one rank moves nothing and is left out
    (``TrainMesh``'s "world" collectives run at any size)."""
    out: Dict[str, Dict] = {}
    for kind, nbytes, _axis, ranks in getattr(mesh, "log", ()):
        g = len(ranks)
        if g < 2:
            continue
        op = COLLECTIVE_KINDS[kind]
        if op == "all-gather":
            nbytes *= g
        e = out.setdefault(op, {"bytes": 0, "count": 0, "max_group": 1,
                                "net_bytes": 0, "net_count": 0})
        e["bytes"] += nbytes
        e["count"] += 1
        e["max_group"] = max(e["max_group"], g)
        if len({r // node_devices for r in ranks}) > 1:
            e["net_bytes"] += nbytes
            e["net_count"] += 1
    return out


def analyze_step(fn, *args, mesh=None, hw=None) -> Dict:
    """Run ``fn(*args)`` once and count it (see the module's docstring).
    ``mesh``: the step's ``DryTrainMesh``, whose record gives the
    collectives (``hw.node_devices`` says which cross nodes; default the
    H100 record).  Returns {"flops", "bytes_traffic", "collectives",
    "argument_bytes", "peak_bytes", "launches", "kernel_flops", "out"}."""
    if hw is None:
        from repro_torch.core.hardware import H100 as hw
    a = _Analyzer()
    seen = set()
    argument_bytes = 0
    for t in tree_flatten(list(args))[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                argument_bytes += st.nbytes()
            a.track(t)
    if mesh is not None:
        mesh.reset_issued()
    if kernels.analyzer is not None:
        raise RuntimeError("analyze_step: another analysis is running")
    kernels.analyzer = a
    try:
        with a:
            out = fn(*args)
    finally:
        kernels.analyzer = None
    return {"flops": a.flops, "bytes_traffic": 2 * a.bytes,
            "collectives": mesh_collectives(mesh, hw.node_devices)
            if mesh is not None else {},
            "argument_bytes": argument_bytes, "peak_bytes": a.peak,
            "launches": dict(a.launches),
            "kernel_flops": dict(a.kernel_flops), "out": out}


# ---------------------------------------------------------------------------
# Roofline terms, every rate from a Hardware record
# ---------------------------------------------------------------------------

def collective_time_s(coll: Dict, hw) -> float:
    """Alpha-beta per-device collective time (ring algorithms, the
    reference's factors): all-gather / reduce-scatter move (g-1)/g of the
    payload, all-reduce 2x that, all-to-all (g-1)/g, collective-permute one
    hop; ``hw.alpha`` a collective.  The part of an entry whose groups cross
    nodes (``net_bytes``) moves at ``hw.net_bw``, the rest at
    ``hw.link_bw``."""
    t = 0.0
    for op, e in coll.items():
        g = max(2, e.get("max_group", 2))
        frac = (g - 1) / g
        factor = {"all-gather": frac, "reduce-scatter": frac,
                  "all-reduce": 2 * frac, "all-to-all": frac,
                  "collective-permute": 1.0}[op]
        net = e.get("net_bytes", 0)
        t += factor * (e["bytes"] - net) / hw.link_bw \
            + factor * net / hw.net_bw + hw.alpha * e.get("count", 1)
    return t


def roofline_terms(analysis: Dict, hw) -> Dict:
    """Per-device seconds of the three roofline terms and the dominant one
    (``matrix_flops`` for compute, ``mem_bw`` for memory)."""
    tc = analysis["flops"] / hw.matrix_flops
    tm = analysis["bytes_traffic"] / hw.mem_bw
    tn = collective_time_s(analysis["collectives"], hw)
    dom = max((tc, "compute"), (tm, "memory"), (tn, "collective"))[1]
    return {"compute_s": tc, "memory_s": tm, "collective_s": tn,
            "bottleneck": dom,
            "step_time_s": max(tc, tm, tn)}
