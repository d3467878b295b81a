"""Nested dicts, lists and tuples of tensors: the port's parameter and
train-state trees (the JAX package's pytrees).

Dict keys are walked in sorted order, as ``jax.tree`` walks them, and a
``Quantized`` moment is one leaf to ``leaves``/``map_tree`` (the optimizer
updates it whole) and two to ``flatten`` (its payload and scales, which the
checkpoint stores).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_quantized(x) -> bool:
    from repro_torch.train.optimizer import Quantized
    return isinstance(x, Quantized)


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def flatten(tree) -> Tuple[List[Any], str]:
    """(array leaves, a description of the structure), each ``Quantized``
    expanded into its payload and scales."""
    out: List[Any] = []

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        if _is_quantized(t):
            out.extend([t.q, t.scale])
            return f"Quantized({list(t.shape)}, pad={t.pad})"
        out.append(t)
        return "*"
    return out, walk(tree)


def unflatten_like(tree_like, new_leaves: List[Any]):
    """Rebuild ``tree_like``'s structure from leaves in ``flatten`` order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(x) for x in t]
            return out if isinstance(t, list) else tuple(out)
        if _is_quantized(t):
            q = next(it)
            return type(t)(q, next(it), t.shape, t.pad)
        return next(it)
    return build(tree_like)
