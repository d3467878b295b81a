"""Sharding policy: trees of shapes -> partition specs for params, batches,
caches and optimizer state (the port of ``src/repro/distributed/
sharding.py``).

The rules are the materialization of the Auto Distribution module's SBP
assignments (``repro_torch.core.distribution``): S(axis) on a tensor dim
becomes a mesh axis name in that dim's spec entry, B becomes None, and P
never appears on stored tensors.

A spec is a tuple with the reference ``PartitionSpec``'s entries: None, an
axis name, or a tuple of names.  A mesh is anything with ``.shape``, a dict
of axis sizes in mesh order (``repro_torch.launch.mesh.ServeMesh`` or
``MeshShape``, or the reference's ``Mesh``).  A tree is nested dicts and
lists (a tuple container comes back a list) whose leaves have ``.shape``;
the port's per-layer lists and the reference's stacked dicts both work.

Conventions:
  * mesh axes: ("data", "model") single-pod, ("pod", "data", "model") 2-pod.
  * FSDP axes = ("pod","data") when present: weights sharded over them on a
    non-contracting dim (gathered per layer at use, A10b).
  * TP axis = "model": heads / ffn / experts / d_inner.
  * Any entry is dropped (-> None) if the dim size is not divisible by the
    mesh axis size (e.g. whisper's vocab 51865).

``local_shard`` gives one rank's slice of a tensor under a spec.  What
applies the specs to a training step (``constrain``, ``weight_use``'s
``REPRO_WEIGHT_AG`` branch) waits for ROADMAP A10b; ``weight_use``'s serve
branch defers to ``param_sharding.tp_use``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.perf import perf

def weight_use(w, *logical, shard=None):
    """A weight at its use site.  On the serve path with weight tensor
    parallelism (``shard`` of a ``ServeEngine(tp=True)``) this is
    ``param_sharding.tp_use``: the all-gathered weight, or the stored
    shard under REPRO_TP_REDUCE_SCATTER=1.  The training branch
    (``REPRO_WEIGHT_AG``) waits for ROADMAP A10b."""
    from repro_torch.distributed import param_sharding
    return param_sharding.tp_use(w, shard)


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts and lists/tuples (path entries
    are dict keys and list indices as strings)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _tree_map2(fn, specs, tree, is_leaf=lambda x: False):
    """``fn(spec, leaf)`` over ``tree``'s structure, ``specs`` holding a
    spec (a tuple) at each of its leaves."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: _tree_map2(fn, specs[k], v, is_leaf)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [_tree_map2(fn, s, v, is_leaf)
                    for s, v in zip(specs, tree)]
    return fn(specs, tree)


def mesh_axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= mesh_axis_size(mesh, a)
        return n
    return int(mesh.shape[name]) if name in mesh.shape else 1


def fsdp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def batch_axes(mesh):
    if perf().train_sharding == "dp":
        # pure data parallelism: batch over every mesh axis
        return _unwrap(tuple(mesh.shape.keys()))
    return ("pod", "data") if "pod" in mesh.shape else "data"


def _unwrap(entry):
    """1-tuples -> bare axis name (the reference's spelling)."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(entries) -> tuple:
    """A spec as ``PartitionSpec`` spells it: a 1-tuple entry is the bare
    axis name and an empty one None."""
    return tuple(None if e == () else _unwrap(e) for e in entries)


def _fits(dim: int, mesh, entry) -> bool:
    return entry is None or dim % mesh_axis_size(mesh, entry) == 0


def _spec_for(shape: Tuple[int, ...], trailing, mesh) -> tuple:
    """Nones for the leading dims + ``trailing`` for the last
    len(trailing) dims, each dropped where the dim does not divide."""
    n = len(shape)
    t = list(trailing)[-n:] if len(trailing) > n else list(trailing)
    entries = [None] * (n - len(t)) + t
    return _spec(e if _fits(shape[i], mesh, e) else None
                 for i, e in enumerate(entries))


def _replicated(shape) -> tuple:
    return (None,) * len(shape)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_specs(cfg, params_abstract, mesh):
    """The training layout of every weight (REPRO_TRAIN_SHARDING): FSDP
    over the data axes and TP over "model", or all replicated under
    "dp"."""
    if perf().train_sharding == "dp":
        return _tree_map(lambda path, leaf: _replicated(leaf.shape),
                         params_abstract)
    FS = fsdp_axes(mesh)
    TP = "model"

    def rule(keys, leaf):
        name = keys[-1]
        in_moe = "moe" in keys
        shape = tuple(leaf.shape)

        if name in ("ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm",
                    "norm", "q_norm", "k_norm", "dt_bias", "conv_b", "D"):
            # conv_b/D are d_inner-sized: shard over TP when they fit
            if name in ("conv_b", "D", "dt_bias") and shape:
                return _spec_for(shape, (TP,), mesh)
            return _replicated(shape)
        if name == "embed":
            return _spec_for(shape, (TP, FS), mesh)
        if name == "unembed":
            return _spec_for(shape, (FS, TP), mesh)
        if name in ("wq", "wk", "wv"):
            return _spec_for(shape, (FS, TP), mesh)
        if name in ("wi", "wi_gate", "wi_up"):
            if in_moe and len(shape) >= 3:      # (..., E, d, f): expert parallel
                return _spec_for(shape, (TP, FS, None), mesh)
            return _spec_for(shape, (FS, TP), mesh)
        if name in ("wo", "out_proj"):
            if in_moe and len(shape) >= 3:      # (..., E, f, d)
                return _spec_for(shape, (TP, None, FS), mesh)
            return _spec_for(shape, (TP, FS), mesh)
        if name == "router":
            return _spec_for(shape, (FS, None), mesh)
        if name in ("in_proj", "in_proj_zx"):
            return _spec_for(shape, (FS, TP), mesh)
        if name == "in_proj_bcdt":
            return _spec_for(shape, (FS, None), mesh)
        if name == "x_proj":
            return _spec_for(shape, (TP, None), mesh)
        if name == "dt_proj":
            return _spec_for(shape, (None, TP), mesh)
        if name == "conv_w":
            return _spec_for(shape, (None, TP), mesh)
        if name == "A_log":
            if shape and shape[-1] > 1 and len(shape) >= 2 \
                    and shape[-2] % 8 == 0:
                return _spec_for(shape, (TP, None), mesh)   # mamba1 (di, N)
            return _spec_for(shape, (TP,), mesh)            # mamba2 (H,)
        return _replicated(shape)

    return _tree_map(lambda keys, leaf: _spec(rule(keys, leaf)),
                     params_abstract)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def batch_specs(cfg, batch_abstract: Dict, mesh):
    BA = batch_axes(mesh)
    nb = mesh_axis_size(mesh, BA)

    def rule(keys, leaf):
        name = keys[-1]
        shape = tuple(leaf.shape)
        if name in ("tokens", "labels", "token"):
            e = BA if shape[0] % nb == 0 else None
            return (e,) + (None,) * (len(shape) - 1)
        if name in ("embeds", "frames"):
            e = BA if shape[0] % nb == 0 else None
            return (e, None, None)
        if name == "positions":
            e = BA if shape[1] % nb == 0 else None
            return (None, e) + (None,) * (len(shape) - 2)
        if name == "cur_len":
            return ()
        return _replicated(shape)

    return _tree_map(lambda keys, leaf: _spec(rule(keys, leaf)),
                     batch_abstract)


# ---------------------------------------------------------------------------
# Decode / prefill caches
# ---------------------------------------------------------------------------

def cache_specs(cfg, cache_abstract, mesh):
    BA = batch_axes(mesh)
    nb = mesh_axis_size(mesh, BA)
    tp_n = mesh_axis_size(mesh, "model")

    def rule(keys, leaf):
        name = keys[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v", "xk", "xv"):
            # (..., B, S, KV, hd)
            b, s, kv = shape[-4], shape[-3], shape[-2]
            lead = (None,) * (len(shape) - 4)
            if b % nb == 0:
                bent, sent = BA, None
            else:
                bent, sent = None, BA if s % nb == 0 else None
            if kv % tp_n == 0:
                kvent, s2 = "model", sent
            else:
                # GQA with KV < model size: sequence-parallel KV cache
                kvent = None
                s2 = (sent, "model") if sent and s % (nb * tp_n) == 0 else (
                    "model" if s % tp_n == 0 else sent)
            return lead + (bent, s2, kvent, None)
        if name == "h":
            # mamba1 (L,B,di,N) / hybrid (nseg,per,B,H,P,N)
            if len(shape) == 4:
                b, di = shape[1], shape[2]
                return (None, BA if b % nb == 0 else None,
                        "model" if di % tp_n == 0 else None, None)
            lead = (None,) * (len(shape) - 4)
            b, hh = shape[-4], shape[-3]
            return lead + (BA if b % nb == 0 else None,
                           "model" if hh % tp_n == 0 else None, None, None)
        if name == "conv":
            # (..., B, K-1, di)
            lead = (None,) * (len(shape) - 3)
            b, di = shape[-3], shape[-1]
            return lead + (BA if b % nb == 0 else None, None,
                           "model" if di % tp_n == 0 else None)
        return _replicated(shape)

    return _tree_map(lambda keys, leaf: _spec(rule(keys, leaf)),
                     cache_abstract)


def paged_cache_specs(cfg, cache_abstract, mesh):
    """Specs of the serve engine's paged KV block slab.

    The paged layout ``(n_layers, num_blocks, block_size, KV, hd)`` lines
    up with the dense cache rule's trailing ``(B, S, KV, hd)``, so
    ``cache_specs`` lands "model" on the kv-heads axis when it divides;
    every other entry is dropped (the block axis is indexed host-side by
    the allocator, and block_size is the offset within a block).  Each rank
    owns ``KV / n_model`` heads of every block in the pool."""
    base = cache_specs(cfg, cache_abstract, mesh)

    def rule(spec, leaf):
        n = len(leaf.shape)
        entries = list(spec) + [None] * (n - len(spec))
        return tuple(e if (i == n - 2 and e == "model") else None
                     for i, e in enumerate(entries))

    return _tree_map2(rule, base, cache_abstract)


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------

def opt_state_specs(param_spec_tree, opt_state_abstract, mesh):
    """Moments mirror the param specs; quantized moments shard their blocks
    over all axes; step is replicated.  Under pure-DP sharding the moments
    are ZeRO-sharded along their largest divisible dim over all axes."""
    from repro_torch.train.optimizer import Quantized
    all_axes = tuple(mesh.shape.keys())
    n_all = mesh_axis_size(mesh, all_axes)
    zero_style = perf().train_sharding == "dp"

    def moment_spec(spec, leaf):
        if isinstance(leaf, Quantized):
            nb = leaf.q.shape[0] if hasattr(leaf.q, "shape") else 0
            qspec = (all_axes, None) if nb % max(1, n_all) == 0 \
                else (None, None)
            nsc = leaf.scale.shape[0] if hasattr(leaf.scale, "shape") else 0
            sspec = (all_axes, None) if nsc % max(1, n_all) == 0 \
                else (None, None)
            return Quantized(_spec(qspec), _spec(sspec), leaf.shape,
                             leaf.pad)
        if zero_style and hasattr(leaf, "shape"):
            # ZeRO-1: shard the first dim divisible by the full device count
            entries = [None] * len(leaf.shape)
            for i, d in enumerate(leaf.shape):
                if d % n_all == 0:
                    entries[i] = all_axes
                    break
            return _spec(entries)
        return spec

    def is_q(x):
        return isinstance(x, Quantized)

    return {
        "step": (),
        "m": _tree_map2(moment_spec, param_spec_tree,
                        opt_state_abstract["m"], is_q),
        "v": _tree_map2(moment_spec, param_spec_tree,
                        opt_state_abstract["v"], is_q),
    }


# ---------------------------------------------------------------------------
# One rank's slice
# ---------------------------------------------------------------------------

def local_shard(x: torch.Tensor, spec: tuple, mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The slice of ``x`` that the rank at mesh coordinates ``coords``
    (axis name -> index) holds under ``spec``: each dim with an entry is
    cut into that entry's axis-size product of equal parts (several axes
    row-major, as the reference's ``NamedSharding`` lays them out).  A
    tensor of its own (never a view of ``x``), contiguous."""
    out = x
    for d, e in enumerate(spec):
        if e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        idx = 0
        for a in names:
            idx = idx * mesh_axis_size(mesh, a) + coords.get(a, 0)
        n = mesh_axis_size(mesh, names)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"{n} ways under spec {spec}")
        size = x.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out.clone(memory_format=torch.contiguous_format)
