"""Rewrite rules (Table 1: transpose optimization) + the rule protocol.

A Rule inspects one (e-class, e-node) pair and yields MixedTerms (children may
reference existing e-classes by id) that are equal to that e-class.  Rules are
non-destructive: the saturation driver adds the new term and unions it with
the matched class.
"""
from __future__ import annotations

from typing import Iterable, List

from repro_torch.core.egraph import EGraph, ENode, M, MixedTerm
from repro_torch.core.tensor_ir import compose_perms, invert_perm


class Rule:
    name = "rule"

    def apply(self, eg: EGraph, cid: int, node: ENode) -> Iterable[MixedTerm]:
        raise NotImplementedError


def _transpose_nodes(eg: EGraph, cid: int):
    """Yield transpose e-nodes within class `cid`."""
    for n in eg.nodes(cid):
        if n.op == "transpose":
            yield n


class CombineBinaryLeftTrans(Rule):
    """Binary(T_p(A), B) -> T_p(Binary(A, T_p^-1(B)))."""
    name = "combine-binary-left-trans"

    def apply(self, eg, cid, node):
        if node.op != "binary":
            return
        lhs, rhs = node.children
        kind = node.attr("kind")
        for tn in _transpose_nodes(eg, lhs):
            perm = tn.attr("perm")
            inv = invert_perm(perm)
            yield M("transpose",
                    M("binary", tn.children[0],
                      M("transpose", rhs, perm=inv), kind=kind),
                    perm=perm)


class CombineBinaryRightTrans(Rule):
    """Binary(A, T_p(B)) -> T_p(Binary(T_p^-1(A), B))."""
    name = "combine-binary-right-trans"

    def apply(self, eg, cid, node):
        if node.op != "binary":
            return
        lhs, rhs = node.children
        kind = node.attr("kind")
        for tn in _transpose_nodes(eg, rhs):
            perm = tn.attr("perm")
            inv = invert_perm(perm)
            yield M("transpose",
                    M("binary", M("transpose", lhs, perm=inv),
                      tn.children[0], kind=kind),
                    perm=perm)


class CombineUnaryTrans(Rule):
    """Unary(T_p(A)) -> T_p(Unary(A))."""
    name = "combine-unary-trans"

    def apply(self, eg, cid, node):
        if node.op != "unary":
            return
        kind = node.attr("kind")
        for tn in _transpose_nodes(eg, node.children[0]):
            yield M("transpose",
                    M("unary", tn.children[0], kind=kind),
                    perm=tn.attr("perm"))


class FoldTwoTrans(Rule):
    """T_p2(T_p1(A)) -> T_{p1∘p2}(A)."""
    name = "fold-two-trans"

    def apply(self, eg, cid, node):
        if node.op != "transpose":
            return
        p2 = node.attr("perm")
        for tn in _transpose_nodes(eg, node.children[0]):
            p1 = tn.attr("perm")
            yield M("transpose", tn.children[0], perm=compose_perms(p1, p2))


class FoldNopTrans(Rule):
    """T_{0,1,...,n}(A) -> A.  Yields the child e-class id directly, which the
    saturation driver interprets as "union this class with that one"."""
    name = "fold-nop-trans"

    def apply(self, eg, cid, node):
        if node.op != "transpose":
            return
        perm = node.attr("perm")
        if perm == tuple(range(len(perm))):
            yield node.children[0]


TRANSPOSE_RULES: List[Rule] = [
    CombineBinaryLeftTrans(), CombineBinaryRightTrans(),
    CombineUnaryTrans(), FoldTwoTrans(), FoldNopTrans(),
]
