"""Auto Vectorize (§3.1.2): MetaPackOperation + FoldNopPack.

MetaPackOperation injects, for every logical op, hardware-specific packed
variants wrapped in pack/unpack, with lane widths from the
:class:`Hardware` record:

  * matrix blocked layout: ``hw.matrix_lanes`` — feeds ``packed_matmul``
  * vector flat layout:    ``hw.vector_lanes`` — feeds ``packed_unary/binary``
  * matrix-block elementwise: element-wise ops can also run directly on the
    matrix blocked layout by treating each block as a contiguous vector —
    the "pass-through layout" of Fig. 3.

FoldNopPack cancels pack(unpack(x)) pairs, which is what lets a blocked
layout flow through MatMul -> Exp -> MatMul without round-tripping to the
logical layout.  Extraction (roofline-weighted WPMaxSAT) then picks the best
variant mix globally.

The extracted packed graph is what ``repro_torch.core.codegen`` emits:
``packed_matmul`` over blocked operands, logical ``matmul`` through the
hand-written matmul kernel.
"""
from __future__ import annotations

from typing import Iterable, List

from repro_torch.core.egraph import EGraph, ENode, M, MixedTerm
from repro_torch.core.extraction import (extract_term, greedy_extract,
                                         wpmaxsat_extract)
from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.rewrite import Rule, TRANSPOSE_RULES
from repro_torch.core.tensor_ir import Term


def _divisible(shape, lanes, axes) -> bool:
    return all(ax < len(shape) and shape[ax] % lane == 0
               for lane, ax in zip(lanes, axes))


class MetaPackOperation(Rule):
    """Op() -> Unpack(PackedOp(Pack(arg_i, lanes_i, axes_i)...), lanes, axes)."""
    name = "meta-pack-operation"

    def __init__(self, hw: Hardware = H100):
        self.matrix_lanes = tuple(hw.matrix_lanes)
        self.vector_lanes = tuple(hw.vector_lanes)

    def apply(self, eg: EGraph, cid: int, node: ENode) -> Iterable[MixedTerm]:
        shape = eg.shape(cid)
        if len(shape) != 2:
            return
        if node.op == "matmul":
            a, b = node.children
            sa, sb = eg.shape(a), eg.shape(b)
            lm, lk = self.matrix_lanes
            ln = self.matrix_lanes[1]
            if (_divisible(sa, (lm, lk), (0, 1))
                    and _divisible(sb, (lk, ln), (0, 1))):
                yield M("unpack",
                        M("packed_matmul",
                          M("pack", a, lanes=(lm, lk), axes=(0, 1)),
                          M("pack", b, lanes=(lk, ln), axes=(0, 1))),
                        lanes=(lm, ln), axes=(0, 1))
        elif node.op in ("unary", "binary"):
            kind = node.attr("kind")
            for lanes in (self.vector_lanes, self.matrix_lanes):
                if not _divisible(shape, lanes, (0, 1)):
                    continue
                packed_children = [M("pack", c, lanes=lanes, axes=(0, 1))
                                   for c in node.children]
                yield M("unpack",
                        M(f"packed_{node.op}", *packed_children, kind=kind),
                        lanes=lanes, axes=(0, 1))


class FoldNopPack(Rule):
    """Pack(Unpack(arg, lanes, axes), lanes, axes) -> arg."""
    name = "fold-nop-pack"

    def apply(self, eg: EGraph, cid: int, node: ENode):
        if node.op != "pack":
            return
        lanes, axes = node.attr("lanes"), node.attr("axes")
        for inner in eg.nodes(node.children[0]):
            if (inner.op == "unpack" and inner.attr("lanes") == lanes
                    and inner.attr("axes") == axes):
                yield inner.children[0]


def vectorize_rules(hw: Hardware = H100) -> List[Rule]:
    """The vectorization rule set for ``hw``'s lane widths."""
    return [MetaPackOperation(hw), FoldNopPack()]


VECTORIZE_RULES: List[Rule] = vectorize_rules(H100)


def auto_vectorize(term: Term, use_sat: bool = True, max_iters: int = 8,
                   node_limit: int = 8000, hw: Hardware = H100):
    """Saturate with vectorization (+ transpose) rules and extract the best
    packed program.  Returns (cost, packed Term, stats)."""
    eg = EGraph()
    root = eg.add_term(term)
    baseline, _ = greedy_extract(eg, root, hw=hw)
    stats = eg.saturate(vectorize_rules(hw) + TRANSPOSE_RULES,
                        max_iters=max_iters, node_limit=node_limit)
    if use_sat:
        cost, choice = wpmaxsat_extract(eg, root, hw=hw)
    else:
        cost, choice = greedy_extract(eg, root, hw=hw)
    stats["baseline_cost"] = baseline
    stats["optimized_cost"] = cost
    stats["egraph_size"] = eg.size()
    return cost, extract_term(eg, root, choice), stats


def count_ops(t: Term, *ops: str) -> int:
    return (t.op in ops) + sum(count_ops(c, *ops) for c in t.children)
