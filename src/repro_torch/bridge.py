"""Numpy bridge between the JAX package's pytrees and the port's tensors.

The JAX side hands over ``np.asarray`` copies, so this module never sees a
JAX array and never imports JAX or ``ml_dtypes``.  A bfloat16 numpy array is
recognised by its dtype *name* and crosses as a bit-exact ``uint16`` view;
on the way back, bf16 tensors come out as ``uint16`` arrays unless the
caller passes its own bf16 numpy dtype (``bf16_dtype=ml_dtypes.bfloat16``).

Parameter layout: the JAX package stacks layer weights on leading axes
under ``params["layers"]``: ``transformer.init_lm`` as a tuple with one
(L/every, ...) stack per layer kind of a super-layer, ``ssm_lm.init_ssm_lm``
as one dict of (L, ...) stacks, ``hybrid.init_hybrid`` as one dict of
(n_seg, per, ...) stacks beside its ``shared`` block.  The port keeps
``params["layers"]`` as a list of per-layer dicts in forward order for every
family.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        a = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return a.view(bf16_dtype) if bf16_dtype is not None else a
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """JAX ``init`` pytree (numpy leaves) of a dense, ssm or hybrid model ->
    the port's param dict."""
    stacks = tree["layers"]
    if isinstance(stacks, dict):
        # one stack: (L, ...) for ssm, (n_seg, per, ...) for the hybrid
        lead = 2 if "shared" in tree else 1
        stacks = (_map(stacks, lambda a: np.asarray(a).reshape(
            (-1,) + np.asarray(a).shape[lead:])),)
    every = len(stacks)
    n_super = _leading(stacks[0])
    layers: List[Dict] = []
    for i in range(n_super):
        for j in range(every):
            layers.append(_map(stacks[j],
                               lambda a, i=i: tensor_from_numpy(a[i], device)))
    out = {k: _map(v, lambda a: tensor_from_numpy(a, device))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = layers
    return out


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _stack(trees: List):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(params: Dict, every: int = 1, bf16_dtype=None,
                    family: str = "dense") -> Dict:
    """Inverse of ``params_from_numpy``: re-stack the per-layer dicts in the
    family's JAX layout.  ``every`` is the super-layer size of a dense arch
    and the segment length (``attn_every``) of a hybrid."""
    conv = lambda t: tensor_to_numpy(t, bf16_dtype)  # noqa: E731
    layers = [_map(lp, conv) for lp in params["layers"]]
    out = {k: _map(v, conv) for k, v in params.items() if k != "layers"}
    if family == "dense":
        out["layers"] = tuple(_stack(layers[j::every]) for j in range(every))
    elif family == "ssm":
        out["layers"] = _stack(layers)
    elif family == "hybrid":
        out["layers"] = _map(_stack(layers), lambda a: a.reshape(
            (a.shape[0] // every, every) + a.shape[1:]))
    else:
        raise NotImplementedError(f"family {family!r} has no bridge layout")
    return out


def paged_cache_from_numpy(cache: Dict, device="cpu") -> Dict:
    """A cache pytree (the paged KV ``{"k","v": (L, N, bs, KV, hd)}``, a
    state slab, or the hybrid's mix of both), layout unchanged."""
    return _map(cache, lambda a: tensor_from_numpy(a, device))


def paged_cache_to_numpy(cache: Dict,
                         bf16_dtype: Optional[object] = None) -> Dict:
    return _map(cache, lambda t: tensor_to_numpy(t, bf16_dtype))
