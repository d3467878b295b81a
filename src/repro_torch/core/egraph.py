"""E-graph with equality saturation (§3.1.1).

egg-style implementation: union-find over e-class ids, hash-consed e-nodes,
congruence closure via rebuild(), and a saturation driver.  An e-class
analysis carries (shape, dtype) — rewrites must be shape-preserving, and the
analysis is checked on every union.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Set, Tuple

from repro_torch.core.tensor_ir import Term, infer_shape


@dataclasses.dataclass(frozen=True)
class ENode:
    op: str
    children: Tuple[int, ...]      # e-class ids
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def attr(self, key, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def canonicalize(self, find) -> "ENode":
        return ENode(self.op, tuple(find(c) for c in self.children), self.attrs)


class EGraph:
    def __init__(self):
        self._parent: List[int] = []
        self.hashcons: Dict[ENode, int] = {}
        self.classes: Dict[int, Set[ENode]] = {}
        self.analysis: Dict[int, Tuple[Tuple[int, ...], str]] = {}
        self.worklist: List[int] = []
        self.n_unions = 0

    # -- union find --------------------------------------------------------
    def find(self, a: int) -> int:
        while self._parent[a] != a:
            self._parent[a] = self._parent[self._parent[a]]
            a = self._parent[a]
        return a

    def _new_class(self, node: ENode, shape, dtype) -> int:
        cid = len(self._parent)
        self._parent.append(cid)
        self.classes[cid] = {node}
        self.analysis[cid] = (shape, dtype)
        return cid

    # -- add / union -------------------------------------------------------
    def add(self, node: ENode) -> int:
        node = node.canonicalize(self.find)
        if node in self.hashcons:
            return self.find(self.hashcons[node])
        child_shapes = tuple(self.analysis[c][0] for c in node.children)
        dtype = (self.analysis[node.children[0]][1]
                 if node.children else node.attr("dtype", "bf16"))
        shape = infer_shape(node.op, child_shapes, dict(node.attrs))
        cid = self._new_class(node, shape, dtype)
        self.hashcons[node] = cid
        return cid

    def add_term(self, t: Term) -> int:
        ids = tuple(self.add_term(c) for c in t.children)
        return self.add(ENode(t.op, ids, t.attrs))

    def union(self, a: int, b: int) -> int:
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        sa, sb = self.analysis[a], self.analysis[b]
        if sa[0] != sb[0]:
            raise ValueError(
                f"union of classes with different shapes: {sa[0]} vs {sb[0]}")
        # merge smaller into larger
        if len(self.classes[a]) < len(self.classes[b]):
            a, b = b, a
        self._parent[b] = a
        self.classes[a] |= self.classes[b]
        del self.classes[b]
        del self.analysis[b]
        self.worklist.append(a)
        self.n_unions += 1
        return a

    # -- congruence closure --------------------------------------------------
    def rebuild(self):
        while self.worklist:
            todo, self.worklist = self.worklist, []
            # re-canonicalize the hashcons; union congruent nodes
            new_hashcons: Dict[ENode, int] = {}
            pending: List[Tuple[int, int]] = []
            for node, cid in self.hashcons.items():
                nn = node.canonicalize(self.find)
                nc = self.find(cid)
                if nn in new_hashcons and new_hashcons[nn] != nc:
                    pending.append((new_hashcons[nn], nc))
                new_hashcons[nn] = self.find(new_hashcons.get(nn, nc))
            self.hashcons = new_hashcons
            for x, y in pending:
                self.union(x, y)
            # rebuild class node sets
            new_classes: Dict[int, Set[ENode]] = {}
            for node, cid in self.hashcons.items():
                new_classes.setdefault(self.find(cid), set()).add(node)
            for cid in list(self.classes):
                root = self.find(cid)
                if root not in new_classes:
                    new_classes[root] = {n.canonicalize(self.find)
                                         for n in self.classes[cid]}
            stale = [c for c in self.classes if c != self.find(c)]
            for cid, nodes in new_classes.items():
                self.classes[cid] = nodes
            for c in stale:
                self.classes.pop(c, None)

    # -- queries -------------------------------------------------------------
    def eclasses(self) -> Iterable[int]:
        return list(self.classes.keys())

    def nodes(self, cid: int) -> Iterable[ENode]:
        return list(self.classes[self.find(cid)])

    def shape(self, cid: int) -> Tuple[int, ...]:
        return self.analysis[self.find(cid)][0]

    def size(self) -> int:
        return sum(len(v) for v in self.classes.values())

    # -- saturation ----------------------------------------------------------
    def saturate(self, rules: List["Rule"], max_iters: int = 12,
                 node_limit: int = 20000) -> Dict[str, int]:
        """Apply all rules to all (class, node) pairs until fixpoint/limits."""
        stats = {"iters": 0, "applications": 0}
        for it in range(max_iters):
            stats["iters"] = it + 1
            matches = []
            for rule in rules:
                for cid in self.eclasses():
                    for node in self.nodes(cid):
                        for new_term in rule.apply(self, cid, node):
                            matches.append((cid, new_term))
            before = self.n_unions
            for cid, term in matches:
                if self.size() > node_limit:
                    break
                new_id = self.add_term_from_ids(term)
                self.union(self.find(cid), new_id)
                stats["applications"] += 1
            self.rebuild()
            if self.n_unions == before or self.size() > node_limit:
                break
        return stats

    def add_term_from_ids(self, t) -> int:
        """Add a 'mixed term': children may be Terms, ints (e-class ids), or
        nested mixed terms — the form rewrite rules produce."""
        if isinstance(t, int):
            return self.find(t)
        ids = tuple(self.add_term_from_ids(c) for c in t.children)
        return self.add(ENode(t.op, ids, t.attrs))


@dataclasses.dataclass(frozen=True)
class MixedTerm:
    """Term whose children can be e-class ids (ints) or MixedTerms."""
    op: str
    children: tuple = ()
    attrs: Tuple[Tuple[str, Any], ...] = ()


def M(op: str, *children, **attrs) -> MixedTerm:
    return MixedTerm(op, tuple(children), tuple(sorted(attrs.items())))
