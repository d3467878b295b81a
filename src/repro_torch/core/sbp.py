"""SBP (Split / Broadcast / Partial) abstraction (§3.1.3), after OneFlow.

The three per-mesh-axis placement states of a logical tensor:

  * ``S(d)`` — *Split*: sliced evenly along tensor dim ``d`` across the
    devices of that mesh axis.  ``S(1)`` on a 2-D ``(in, out)`` weight is
    column-parallel, ``S(0)`` is row-parallel.
  * ``B`` — *Broadcast*: every device holds the full tensor.
  * ``P`` — *Partial*: every device holds a same-shaped unreduced partial
    sum; the true value is their elementwise sum.  This is what a matmul
    over a split contraction dim produces, and an all-reduce (``P -> B``)
    or reduce-scatter (``P -> S``) materializes it.

An *ND-SBP* is a tuple assigning one SBP per mesh axis; axes compose
orthogonally (a ``(S(0), B)`` over a 2-D mesh shards dim 0 on the first
axis and replicates over the second).  *Boxing* converts between ND-SBPs
via collectives; :func:`boxing_cost` prices each transition with the
alpha-beta model (``hw.alpha`` latency + payload / ``hw.link_bw``).

Op semantics live in *signatures* (:func:`matmul_axis_signatures`,
:func:`elementwise_axis_signatures`): per-axis rules mapping input SBP
tags to the output tag, e.g. ``(B, S1) -> S1`` ("replicated activations
times a column-sharded weight yield column-sharded output, no comm") and
``(S1, S0) -> P`` ("split contraction yields partials").  Auto
Distribution (``repro.core.distribution``) enumerates these per tensor and
extracts the cheapest consistent assignment.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from repro_torch.core.hardware import H100, Hardware


@dataclasses.dataclass(frozen=True)
class S:
    """Split along tensor dim ``axis``; hashable and interned by value so
    ND-SBP tuples can key e-cluster dicts."""
    axis: int

    def __repr__(self):
        return f"S({self.axis})"


class _B:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "B"


class _P:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "P"


B = _B()
P = _P()
NdSbp = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Logical device topology: named mesh axes with sizes."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def ndim(self):
        return len(self.axes)

    @property
    def n_devices(self):
        n = 1
        for s in self.sizes:
            n *= s
        return n


def shard_shape(shape: Tuple[int, ...], nd: NdSbp, pl: Placement):
    """Per-device local shape under an ND-SBP (None if not divisible)."""
    local = list(shape)
    for sbp, size in zip(nd, pl.sizes):
        if isinstance(sbp, S):
            if sbp.axis >= len(local) or local[sbp.axis] % size != 0:
                return None
            local[sbp.axis] //= size
    return tuple(local)


def valid_ndsbps(shape: Tuple[int, ...], pl: Placement,
                 allow_partial: bool = False) -> List[NdSbp]:
    """All ND-SBPs whose splits divide `shape` evenly.

    This is the per-tensor strategy-enumeration primitive: Auto
    Distribution calls it for every graph input (and for resharding
    targets, with ``allow_partial=False`` since nothing *stores* a tensor
    as Partial on purpose).  Non-divisible splits are excluded here, which
    is why a config whose head or FF dims don't divide the mesh axis
    degrades to replicated instead of crashing.
    """
    per_axis: List[List[object]] = []
    for size in pl.sizes:
        cands: List[object] = [B]
        cands += [S(d) for d in range(len(shape)) if shape[d] % size == 0]
        if allow_partial:
            cands.append(P)
        per_axis.append(cands)
    out = []
    for combo in itertools.product(*per_axis):
        if shard_shape(shape, combo, pl) is not None:
            out.append(tuple(combo))
    return out


def memory_bytes(shape, nd: NdSbp, pl: Placement, dtype_bytes: int = 2) -> int:
    """Per-device bytes of a tensor stored with this ND-SBP.

    A Broadcast or Partial axis charges the full extent (each device holds
    a complete copy or a complete partial sum); a Split axis charges
    ``1/size``.  An invalid (non-divisible) placement returns 2**60 so it
    can never win under a memory cap."""
    local = shard_shape(shape, nd, pl)
    if local is None:
        return 1 << 60
    n = dtype_bytes
    for d in local:
        n *= d
    return n


# ---------------------------------------------------------------------------
# Boxing: per-axis SBP transitions and their collective cost
# ---------------------------------------------------------------------------

_TRANSITION = {
    # (src, dst) -> collective kind; None = impossible, "" = free
    ("B", "B"): "",
    ("B", "S"): "slice",          # local slicing, free
    ("S", "S"): "all-to-all",     # different split axes
    ("S", "B"): "all-gather",
    ("P", "B"): "all-reduce",
    ("P", "S"): "reduce-scatter",
    # P sources can also stay partial (free) — handled by equality below
}


def _kindof(sbp) -> str:
    if isinstance(sbp, S):
        return "S"
    return "B" if sbp is B else "P"


def boxing_ops(src: NdSbp, dst: NdSbp, shape, pl: Placement,
               dtype_bytes: int = 2):
    """List of (collective kind, payload bytes, group size) per mesh axis for
    converting src -> dst.  Returns None if the conversion is impossible."""
    ops = []
    for i, (a, b, size) in enumerate(zip(src, dst, pl.sizes)):
        if a == b or size == 1:
            continue
        ka, kb = _kindof(a), _kindof(b)
        if ka == "S" and kb == "S" and a.axis == b.axis:
            continue
        kind = _TRANSITION.get((ka, kb))
        if kind is None:
            return None
        if kind in ("", "slice"):
            ops.append(("slice", 0, size))
            continue
        # payload = the local tensor being exchanged on this axis: use the
        # destination-local size for gathers, source-local for scatters.
        local_src = shard_shape(shape, src, pl)
        if local_src is None:
            return None
        nbytes = dtype_bytes
        for d in local_src:
            nbytes *= d
        if kind == "all-gather":
            nbytes *= size  # gathered result
        ops.append((kind, nbytes, size))
    return ops


def boxing_cost(src: NdSbp, dst: NdSbp, shape, pl: Placement,
                dtype_bytes: int = 2, hw: Hardware = H100) -> Optional[float]:
    """Alpha-beta time (seconds) to convert ``src -> dst``, or None if no
    collective implements the transition (e.g. ``B -> P``).

    Per ring-collective convention, each device moves ``(g-1)/g`` of the
    payload once for all-gather / reduce-scatter / all-to-all and twice for
    all-reduce (reduce-scatter + all-gather), plus an ``hw.alpha`` launch
    latency per collective.  This is the term that makes one row-parallel
    all-reduce beat two column-parallel all-gathers in the TP layout
    search."""
    ops = boxing_ops(src, dst, shape, pl, dtype_bytes)
    if ops is None:
        return None
    t = 0.0
    for kind, nbytes, g in ops:
        if kind == "slice" or g <= 1:
            continue
        frac = (g - 1) / g
        factor = {"all-gather": frac, "reduce-scatter": frac,
                  "all-reduce": 2 * frac, "all-to-all": frac}[kind]
        t += hw.alpha + factor * nbytes / hw.link_bw
    return t


# ---------------------------------------------------------------------------
# SBP signatures (per mesh axis; ND composition is orthogonal)
# ---------------------------------------------------------------------------

def matmul_axis_signatures() -> List[Tuple[Tuple[str, ...], str]]:
    """1-axis signatures for C[M,N] = A[M,K] @ B[K,N], encoded symbolically:
    entries are 'S0'/'S1'/'B'/'P' per operand and the output."""
    return [
        (("S0", "B"), "S0"),    # split rows (data parallel)
        (("B", "S1"), "S1"),    # split cols (tensor parallel out-dim)
        (("S1", "S0"), "P"),    # split contraction -> partial
        (("B", "B"), "B"),
        (("P", "B"), "P"),
        (("B", "P"), "P"),
    ]


def elementwise_axis_signatures(arity: int, linear: bool
                                ) -> List[Tuple[Tuple[str, ...], str]]:
    """1-axis signatures for elementwise ops: any split or broadcast state
    passes through unchanged.  Only *linear* ops (add-like) may consume
    Partial inputs — a nonlinearity applied to unreduced partial sums would
    compute ``f(a) + f(b) != f(a + b)``, so P must be boxed to B first."""
    sigs = []
    for tag in ("S0", "S1", "B"):
        sigs.append((tuple(tag for _ in range(arity)), tag))
    if linear:  # add-like ops propagate partial values
        sigs.append((tuple("P" for _ in range(arity)), "P"))
        if arity == 2:
            sigs.append((("P", "B"), "P"))
            sigs.append((("B", "P"), "P"))
    return sigs


def resolve_tag(tag: str, ndim: int):
    """Symbolic signature tag ('B'/'P'/'S<d>') -> SBP object, or None when
    the split dim doesn't exist on an ``ndim``-dimensional output."""
    if tag == "B":
        return B
    if tag == "P":
        return P
    d = int(tag[1:])
    return S(d) if d < ndim else None
