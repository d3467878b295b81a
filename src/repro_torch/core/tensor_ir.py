"""A small tensor IR that the e-graph engine rewrites over.

Terms are immutable, hash-consed trees.  Ops mirror the subset of the paper's
IR needed by the three passes:

  input(name, shape, dtype)         leaf tensors
  transpose(x; perm)                Table 1 rules
  unary(x; kind)                    exp / silu / relu2 / neg ...
  binary(x, y; kind)                add / mul / sub ...
  matmul(x, y)                      2-D (M,K)x(K,N)
  pack(x; lanes, axes)              Auto Vectorize blocked layouts
  unpack(x; axes)                   inverse of pack
  packed_matmul / packed_unary ...  hardware-unit variants (§3.1.2)
  box(x; sbp)                       Auto Distribution boxing (§3.1.3)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Term:
    op: str
    children: Tuple["Term", ...] = ()
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def attr(self, key, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def __repr__(self):
        a = ", ".join(f"{k}={v}" for k, v in self.attrs)
        c = ", ".join(repr(ch) for ch in self.children)
        inner = ", ".join(x for x in (c, a) if x)
        return f"{self.op}({inner})"


def T(op: str, *children: Term, **attrs) -> Term:
    return Term(op, tuple(children), tuple(sorted(attrs.items())))


def inp(name: str, shape: Shape, dtype: str = "bf16") -> Term:
    return T("input", name=name, shape=tuple(shape), dtype=dtype)


def transpose(x: Term, perm: Tuple[int, ...]) -> Term:
    return T("transpose", x, perm=tuple(perm))


def unary(x: Term, kind: str) -> Term:
    return T("unary", x, kind=kind)


def binary(x: Term, y: Term, kind: str) -> Term:
    return T("binary", x, y, kind=kind)


def matmul(x: Term, y: Term) -> Term:
    return T("matmul", x, y)


def pack(x: Term, lanes: Tuple[int, ...], axes: Tuple[int, ...]) -> Term:
    return T("pack", x, lanes=tuple(lanes), axes=tuple(axes))


def unpack(x: Term, lanes: Tuple[int, ...], axes: Tuple[int, ...]) -> Term:
    return T("unpack", x, lanes=tuple(lanes), axes=tuple(axes))


def compose_perms(p1: Tuple[int, ...], p2: Tuple[int, ...]) -> Tuple[int, ...]:
    """transpose(transpose(A, p1), p2) == transpose(A, compose_perms(p1, p2))."""
    return tuple(p1[p2[i]] for i in range(len(p2)))


def invert_perm(p: Tuple[int, ...]) -> Tuple[int, ...]:
    out = [0] * len(p)
    for i, v in enumerate(p):
        out[v] = i
    return tuple(out)


DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1}


def infer_shape(op: str, child_shapes: Tuple[Shape, ...],
                attrs: Dict[str, Any]) -> Shape:
    if op == "input":
        return tuple(attrs["shape"])
    if op == "transpose":
        (s,) = child_shapes
        perm = attrs["perm"]
        return tuple(s[p] for p in perm)
    if op in ("unary", "packed_unary"):
        return child_shapes[0]
    if op in ("binary", "packed_binary"):
        a, b = child_shapes
        if a != b:
            raise ValueError(f"binary shape mismatch {a} vs {b}")
        return a
    if op in ("matmul", "packed_matmul"):
        a, b = child_shapes
        if a[-1] != b[-2 if len(b) >= 2 else 0]:
            raise ValueError(f"matmul dim mismatch {a} x {b}")
        return tuple(a[:-1]) + (b[-1],)
    if op == "pack":
        (s,) = child_shapes
        lanes, axes = attrs["lanes"], attrs["axes"]
        out = list(s)
        for lane, ax in zip(lanes, axes):
            if out[ax] % lane != 0:
                raise ValueError(f"pack lane {lane} on dim {out[ax]}")
            out[ax] //= lane
        return tuple(out)  # lanes become the (implicit) register dims
    if op == "unpack":
        (s,) = child_shapes
        lanes, axes = attrs["lanes"], attrs["axes"]
        out = list(s)
        for lane, ax in zip(lanes, axes):
            out[ax] *= lane
        return tuple(out)
    if op == "box":
        return child_shapes[0]
    raise ValueError(f"unknown op {op}")


def term_shape(t: Term, cache: Optional[dict] = None) -> Shape:
    cache = cache if cache is not None else {}
    if t in cache:
        return cache[t]
    child_shapes = tuple(term_shape(c, cache) for c in t.children)
    s = infer_shape(t.op, child_shapes, dict(t.attrs))
    cache[t] = s
    return s
