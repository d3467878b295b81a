"""Numpy bridge between the JAX package's pytrees and the port's tensors.

The JAX side hands over ``np.asarray`` copies, so this module never sees a
JAX array and never imports JAX or ``ml_dtypes``.  A bfloat16 numpy array is
recognised by its dtype *name* and crosses as a bit-exact ``uint16`` view;
on the way back, bf16 tensors come out as ``uint16`` arrays unless the
caller passes its own bf16 numpy dtype (``bf16_dtype=ml_dtypes.bfloat16``).

Train state: ``train_state_from_numpy``/``train_state_to_numpy`` carry
``{"params", "opt": {"step", "m", "v"}}``, the moments in the params'
layout, f32 or int8 block-quantized (payload and scales; a quantized moment
is anything with ``q``, ``scale``, ``shape`` and ``pad``, as the JAX
package's ``Quantized`` is).  A stacked int8 moment splits into per-layer
ones exactly when each layer's slice is whole quantization blocks; where a
block straddles two layers no per-layer state equals it, and the bridge
raises rather than requantize.

Parameter layout: the JAX package stacks layer weights on leading axes
under ``params["layers"]``: ``transformer.init_lm`` (dense and moe) as a
tuple with one (L/every, ...) stack per layer kind of a super-layer (an
MoE layer's expert weights are (L/every, E, d, f) stacks),
``ssm_lm.init_ssm_lm`` as one dict of (L, ...) stacks,
``hybrid.init_hybrid`` as one dict of (n_seg, per, ...) stacks beside its
``shared`` block; ``encdec.init_encdec`` (audio) as two dicts of (L, ...)
stacks, ``enc_layers`` and ``dec_layers``.  The port keeps each stack as a
list of per-layer dicts in forward order for every family.  The vlm family
has the dense layout.
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


# the encoder-decoder's two layer stacks, each (L, ...)
ENCDEC_STACKS = ("enc_layers", "dec_layers")


def _unstack(stack, device) -> List[Dict]:
    """One (L, ...) stack -> L per-layer dicts of tensors."""
    return [_map(stack, lambda a, i=i: tensor_from_numpy(a[i], device))
            for i in range(_leading(stack))]


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """JAX ``init`` pytree (numpy leaves) of a dense, moe, vlm, ssm, hybrid
    or audio model -> the port's param dict."""
    if "enc_layers" in tree:
        return {k: _unstack(v, device) if k in ENCDEC_STACKS
                else _map(v, lambda a: tensor_from_numpy(a, device))
                for k, v in tree.items()}
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
    return tuple(tree.shape)[0] if _is_quantized(tree) \
        else np.asarray(tree).shape[0]


def _stack(trees: List):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(params: Dict, every: int = 1, bf16_dtype=None,
                    family: str = "dense") -> Dict:
    """Inverse of ``params_from_numpy``: re-stack the per-layer dicts in the
    family's JAX layout.  ``every`` is the super-layer size of a dense or
    moe arch (``cfg.moe.every``) and the segment length (``attn_every``) of
    a hybrid."""
    conv = lambda t: tensor_to_numpy(t, bf16_dtype)  # noqa: E731
    if family == "audio":
        return {k: _stack([_map(lp, conv) for lp in v])
                if k in ENCDEC_STACKS else _map(v, conv)
                for k, v in params.items()}
    layers = [_map(lp, conv) for lp in params["layers"]]
    out = {k: _map(v, conv) for k, v in params.items() if k != "layers"}
    if family in ("dense", "moe", "vlm"):
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


# ---------------------------------------------------------------------------
# Train state: params and AdamW moments
# ---------------------------------------------------------------------------

def _is_quantized(x) -> bool:
    return all(hasattr(x, a) for a in ("q", "scale", "shape", "pad"))


def _any_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_quantized(v) for v in tree)
    return _is_quantized(tree)


def _quantized(q, scale, shape, pad, device):
    from repro_torch.train.optimizer import Quantized
    return Quantized(tensor_from_numpy(q, device),
                     tensor_from_numpy(scale, device), tuple(shape), int(pad))


def _layer_blocks(x, i: int):
    """Layer ``i``'s payload and scales of a stacked quantized moment."""
    shape = tuple(x.shape)
    per = int(np.prod(shape[1:], dtype=np.int64))
    block = np.asarray(x.q).shape[1]
    if per % block:
        raise ValueError(
            f"bridge: a moment of shape {shape} is quantized in blocks of "
            f"{block} that straddle its layers ({per} values a layer); no "
            "per-layer int8 state equals it")
    nb = per // block
    return (np.asarray(x.q)[i * nb:(i + 1) * nb],
            np.asarray(x.scale)[i * nb:(i + 1) * nb], shape[1:])


def _moments_from_numpy(tree: Dict, device) -> Dict:
    if not _any_quantized(tree):
        return params_from_numpy(tree, device)

    def split(stack) -> List[Dict]:
        return [_map(stack, lambda x, i=i: _quantized(
            *_layer_blocks(x, i), 0, device)) for i in range(_leading(stack))]

    def whole(v):
        return _map(v, lambda x: _quantized(x.q, x.scale, x.shape, x.pad,
                                            device))

    if "enc_layers" in tree:
        return {k: split(v) if k in ENCDEC_STACKS else whole(v)
                for k, v in tree.items()}
    stacks = tree["layers"]
    if not isinstance(stacks, (tuple, list)):
        raise NotImplementedError("bridge: int8 moments cross for the dense "
                                  "and audio layouts only")
    per_kind = [split(stack) for stack in stacks]
    out = {k: whole(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [kind[i] for i in range(len(per_kind[0]))
                     for kind in per_kind]
    return out


def _moments_to_numpy(tree: Dict, every: int, bf16_dtype,
                      family: str) -> Dict:
    from repro_torch.train.optimizer import Quantized
    if not _any_quantized(tree):
        return params_to_numpy(tree, every, bf16_dtype, family)

    def host(x):
        return Quantized(tensor_to_numpy(x.q), tensor_to_numpy(x.scale),
                         tuple(x.shape), int(x.pad))

    def stack(xs):
        if any(x.pad for x in xs):
            raise ValueError(
                f"bridge: a per-layer moment of shape {tuple(xs[0].shape)} "
                "ends in a padded quantization block; stacking the layers "
                "gives no int8 state equal to it")
        return Quantized(np.concatenate([tensor_to_numpy(x.q) for x in xs]),
                         np.concatenate([tensor_to_numpy(x.scale)
                                         for x in xs]),
                         (len(xs),) + tuple(xs[0].shape), 0)

    def stack_tree(trees):
        if isinstance(trees[0], dict):
            return {k: stack_tree([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)

    if family == "audio":
        return {k: stack_tree(v) if k in ENCDEC_STACKS else _map(v, host)
                for k, v in tree.items()}
    layers = tree["layers"]
    out = {k: _map(v, host) for k, v in tree.items() if k != "layers"}
    out["layers"] = tuple(stack_tree(layers[j::every]) for j in range(every))
    return out


def train_state_from_numpy(tree: Dict, device="cpu") -> Dict:
    """The JAX package's train state ``{"params", "opt": {"step", "m",
    "v"}}`` (numpy leaves) -> the port's, on ``device``."""
    opt = tree["opt"]
    return {"params": params_from_numpy(tree["params"], device),
            "opt": {"step": tensor_from_numpy(
                        np.asarray(opt["step"], np.int32), device),
                    "m": _moments_from_numpy(opt["m"], device),
                    "v": _moments_from_numpy(opt["v"], device)}}


def train_state_to_numpy(state: Dict, every: int = 1,
                         bf16_dtype=None, family: str = "dense") -> Dict:
    """Inverse of ``train_state_from_numpy`` (``every`` and ``family`` as
    for ``params_to_numpy``; int8 moments for the dense, moe and audio
    layouts); int8 moments come out as ``optimizer.Quantized`` records of
    numpy arrays."""
    opt = state["opt"]
    return {"params": params_to_numpy(state["params"], every, bf16_dtype,
                                      family),
            "opt": {"step": tensor_to_numpy(opt["step"]),
                    **{k: _moments_to_numpy(opt[k], every, bf16_dtype,
                                            family) for k in ("m", "v")}}}
