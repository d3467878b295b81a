"""Roofline cost model (§3.1.1) + alpha-beta communication model (§3.1.3).

Costs are abstract per-op latencies in seconds on a :class:`Hardware`
record (default: the H100 SXM); the e-graph extractor minimizes their sum.
Packed ops run on the matching compute unit (the matrix unit for
packed_matmul, the elementwise unit for packed element-wise) at higher
efficiency than their unpacked forms — that asymmetry is what drives the
Auto Vectorize trade-off (§3.1.2).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.egraph import EGraph, ENode
from repro_torch.core.hardware import H100, Hardware


def _elems(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def node_cost(eg: EGraph, node: ENode, dtype_bytes: int = 2,
              hw: Hardware = H100) -> float:
    """Roofline latency of one e-node given its children's shapes."""
    out_shape = None
    try:
        child_shapes = tuple(eg.shape(c) for c in node.children)
    except KeyError:
        child_shapes = ()
    op = node.op

    if op == "input":
        return 0.0
    if op == "box":
        return boxing_cost(node, eg, hw=hw)

    from repro_torch.core.tensor_ir import infer_shape
    out_shape = infer_shape(op, child_shapes, dict(node.attrs))
    out_b = _elems(out_shape) * dtype_bytes
    in_b = sum(_elems(s) for s in child_shapes) * dtype_bytes

    if op in ("matmul", "packed_matmul"):
        k = child_shapes[0][-1]
        flops = 2 * _elems(out_shape) * k
        eff = 1.0 if op == "packed_matmul" else hw.unpacked_matrix_eff
        return max(flops / (hw.matrix_flops * eff), (in_b + out_b) / hw.mem_bw)
    if op in ("unary", "packed_unary", "binary", "packed_binary"):
        flops = _elems(out_shape) * (4 if "unary" in op else 1)
        eff = 1.0 if op.startswith("packed") else hw.unpacked_vector_eff
        return max(flops / (hw.vector_flops * eff), (in_b + out_b) / hw.mem_bw)
    if op == "transpose":
        # layout permutation: pure data movement, poorly coalesced
        return (in_b + out_b) / (hw.mem_bw * 0.5)
    if op in ("pack", "unpack"):
        # layout conversion: streaming copy
        return (in_b + out_b) / hw.mem_bw
    return out_b / hw.mem_bw


def boxing_cost(node: ENode, eg: EGraph, dtype_bytes: int = 2,
                hw: Hardware = H100) -> float:
    """Alpha-beta cost of an SBP Boxing op (attrs carry the transfer kind)."""
    kind = node.attr("comm", "none")
    group = node.attr("group", 1)
    shape = eg.shape(node.children[0]) if node.children else ()
    nbytes = _elems(shape) * dtype_bytes
    if kind == "none" or group <= 1:
        return 0.0
    frac = (group - 1) / group
    factor = {"all-gather": frac, "reduce-scatter": frac,
              "all-reduce": 2 * frac, "all-to-all": frac,
              "split": 0.0, "p2p": 1.0}.get(kind, frac)
    return hw.alpha + factor * nbytes / hw.link_bw


def collective_bytes(kind: str, nbytes: int, group: int) -> float:
    frac = (group - 1) / max(1, group)
    factor = {"all-gather": frac, "reduce-scatter": frac,
              "all-reduce": 2 * frac, "all-to-all": frac}.get(kind, frac)
    return factor * nbytes
