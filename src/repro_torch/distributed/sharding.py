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

``local_shard`` gives one rank's slice of a tensor under a spec.  A training
step on a mesh (``repro_torch.launch.mesh.TrainMesh``) applies the specs:
``Trainer(mesh=)`` keeps each rank's shards (``train_layout``,
``shard_tree``), and the model functions take a ``TrainShard`` through
which every weight use (``weight_use``, ``resolve``) gathers what the
compute needs, and ``constrain`` moves activations between the layouts the
logical names give (``LOGICAL_AXES``), through the differentiable
collectives of ``repro_torch.distributed.collectives``.  ``weight_use``'s
serve branch defers to ``param_sharding.tp_use``.  A prefill or decode
step on a training mesh takes the same weights under the forward-only
``serve_shard``, and its dense cache the ``cache_specs`` layout
(``to_cache_block``, ``kv_heads_as``); ``check_mesh_serves`` refuses a
split that does not divide.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.perf import perf

# Logical activation axes -> mesh axes (the reference's table): the model
# names what a dim holds and the mesh decides where it lives.
LOGICAL_AXES = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "dinner": ("model",),
    "experts": ("model",),
    "seq_mp": ("model",),          # sequence-parallel over the model axis
    "seq_dp": ("pod", "data"),     # sequence-parallel over the data axes
    None: (),
}


# ---------------------------------------------------------------------------
# A training step on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainWeight:
    """One rank's shard of a weight on a training mesh under fsdp_tp:
    ``local`` is the slice that ``spec`` gives (entries None, "data" or
    "model") of the full ``shape``.  Use sites read it through
    ``weight_use`` / ``resolve`` (or ``param_sharding.tp_linear`` /
    ``tp_embed``), never as a tensor."""
    local: torch.Tensor
    spec: tuple
    shape: Tuple[int, ...]
    # its "data" entries already gathered (a layer's bucket)
    data_done: bool = False

    @property
    def dtype(self):
        return self.local.dtype


@dataclasses.dataclass(frozen=True)
class TrainShard:
    """What a training step on a mesh hands the model functions (an
    explicit argument, as the serve engine's ``ServeShard``).

    ``mode`` is REPRO_TRAIN_SHARDING.  ``batch_split``: the ranks of the
    batch axes hold different rows (a global batch that does not divide is
    replicated, and then nothing is summed over its copies).  ``tp``: the
    region computes tensor-parallel over "model" (column and row products,
    a rank's heads and experts); ``model_split``: the region's model ranks
    compute on different rows (sequence parallelism), so a weight gathered
    or replicated over "model" sums its gradient there.  ``seq_parallel``
    (REPRO_SEQ_PARALLEL) and ``per_use`` (REPRO_WEIGHT_AG) as the knobs
    say.  ``grad`` False (a prefill or decode step, ``serve_shard``):
    nothing that only a loss reads is summed over the ranks; ``cache``
    then holds the spec tree of a decode step's cache blocks
    (``cache_specs``)."""
    mesh: Any
    mode: str = "fsdp_tp"
    batch_split: bool = True
    tp: bool = True
    model_split: bool = False
    seq_parallel: bool = False
    per_use: bool = False
    grad: bool = True
    cache: Any = None

    @property
    def batch_axis(self) -> str:
        """The axis the batch is split over: "data", or every rank (dp)."""
        return "world" if self.mode == "dp" else "data"

    def seq_region(self) -> "TrainShard":
        """The sequence-parallel MLP's region: no tensor parallelism, the
        model ranks on different sequence slices."""
        return dataclasses.replace(self, tp=False, model_split=True)


def in_tp(shard) -> bool:
    """Whether ``shard`` is a training step's tensor-parallel region."""
    return isinstance(shard, TrainShard) and shard.tp


def attention_shard(cfg, shard):
    """The shard a training step's attention computes under: the step's
    own where the query heads split over "model" (a rank's H/n heads, and
    its KV/n, or where fewer KV heads than model ranks divide them, the one
    its query heads read: ``attention.qkv_project``); else the step's
    without tensor parallelism, the block's weights gathered whole and
    every head computed on every model rank (the same compute on each, so
    nothing is summed over "model"): llama4-maverick's 40 heads and
    whisper's 12 on a model axis of 16."""
    if in_tp(shard) and cfg.n_heads % shard.mesh.shape["model"]:
        return dataclasses.replace(shard, tp=False)
    return shard


def train_shard(mesh, seq_len: int, batch_split: bool) -> TrainShard:
    """The step's ``TrainShard`` under the knobs: sequence parallelism only
    under fsdp_tp, with more than one model rank and a sequence that
    divides over them."""
    p = perf()
    n_model = mesh.shape["model"]
    sp = p.seq_parallel and p.train_sharding == "fsdp_tp" and n_model > 1 \
        and seq_len % n_model == 0
    return TrainShard(mesh=mesh, mode=p.train_sharding,
                      batch_split=batch_split,
                      tp=p.train_sharding == "fsdp_tp", seq_parallel=sp,
                      per_use=p.weight_ag)


def serve_shard(mesh, batch_split: bool, cache=None) -> TrainShard:
    """The forward-only ``TrainShard`` of a prefill or decode step on a
    training mesh: the fsdp_tp layout (the weights as
    ``train_layout(...).params`` lays them out), tensor parallelism on
    "model", no sequence parallelism, REPRO_WEIGHT_AG as the knob says,
    and no gradient bookkeeping.  ``batch_split`` as ``train_shard``'s;
    ``cache`` the spec tree of a decode step's cache blocks."""
    return TrainShard(mesh=mesh, mode="fsdp_tp", batch_split=batch_split,
                      tp=True, per_use=perf().weight_ag, grad=False,
                      cache=cache)


def tp_splits_bad(cfg, n: int) -> list:
    """What ``cfg``'s tensor parallelism splits over a model axis of ``n``
    and does not divide, as "name size" strings (``check_mesh_trains``,
    ``check_mesh_serves``): d_inner (ssm, hybrid), the SSD heads (hybrid),
    and the kv heads where the query heads split and the kv heads neither
    divide nor are divided by ``n``."""
    splits = []
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm.expand * cfg.d_model
        splits.append(("d_inner", di))
        if cfg.family == "hybrid":
            splits.append(("SSD heads", di // cfg.ssm.head_dim))
    bad = [f"{k} {v}" for k, v in splits if v % n]
    kv = cfg.n_kv_heads
    if cfg.family != "ssm" and cfg.n_heads % n == 0 and kv % n and n % kv:
        bad.append(f"kv heads {kv}")
    return bad


def check_mesh_serves(cfg, mesh, spec) -> None:
    """Raise before anything is allocated when a prefill or decode step of
    ``cfg`` at ``spec`` (a ``ShapeSpec``) cannot run on the training mesh
    ``mesh``: it takes the fsdp_tp layout (REPRO_TRAIN_SHARDING=dp
    trains only), and with more than one model rank what the family
    splits over "model" must divide (``tp_splits_bad``), as
    ``trainer.check_mesh_trains`` says.  The batch and the cache need
    nothing: an entry that does not divide is dropped (replicated) by
    ``batch_specs`` and ``cache_specs`` alike."""
    if spec.kind not in ("prefill", "decode"):
        raise ValueError(f"{spec.name}: a {spec.kind} shape is not a "
                         "prefill or decode step")
    if perf().train_sharding != "fsdp_tp":
        raise ValueError(
            f"{cfg.name}: prefill and decode on a mesh take the fsdp_tp "
            f"layout; REPRO_TRAIN_SHARDING={perf().train_sharding} trains "
            "only")
    n = mesh.shape["model"]
    bad = tp_splits_bad(cfg, n) if n > 1 else []
    if bad:
        raise ValueError(
            f"{cfg.name} ({cfg.family}): {', '.join(bad)} do not split over "
            f"a model axis of {n}")


# ---------------------------------------------------------------------------
# A K/V cache on a mesh
# ---------------------------------------------------------------------------
# ``cache_specs`` lays a (B, S, KV, hd) K/V leaf out with its kv heads over
# "model" where they divide, else as a sequence-parallel cache: every kv
# head, the positions over "model" (or over the batch axes where the batch
# does not divide, or over both).  A rank's attention computes the heads
# ``kv_held`` names; these move its K/V between the two.

def kv_held(cfg, shard) -> str:
    """The KV heads a rank's attention projects under ``shard``
    (``attention.qkv_project``): "all" (no tensor parallelism: one device,
    a model axis of one rank, or query heads that do not split,
    ``attention_shard``), "split" (its KV/n) or "one" (the one KV head its
    query heads read, where the KV heads are fewer than the model
    ranks)."""
    s = attention_shard(cfg, shard)
    if not in_tp(s) or s.mesh.shape["model"] == 1:
        return "all"
    return "split" if cfg.n_kv_heads % s.mesh.shape["model"] == 0 \
        else "one"


def kv_heads_as(x: torch.Tensor, held: str, entry, mesh, n_kv: int
                ) -> torch.Tensor:
    """``x`` (B, S, heads ``held``, hd) with the kv heads a cache block of
    heads entry ``entry`` holds: the rank's KV/n ("model") or every one
    (None, gathered over "model": a rank holding one head of each group
    of n/KV ranks keeps the first rank's copy)."""
    if entry == "model":
        if held == "all":
            return mesh.part(x, 2, "model")
        return x
    if held == "all":
        return x
    x = mesh.gather(x, 2, "model")
    if held == "one":
        x = x[:, :, ::mesh.size("model") // n_kv]
    return x


def seq_axis(entry):
    """The mesh axis a cache's sequence entry splits over ("data",
    "model", or "world" for both, whose joint index is the rank), or
    None."""
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    return names[0] if len(names) == 1 else "world"


def seq_start(entry, n_local: int, mesh) -> int:
    """The first position of a rank's block of ``n_local`` positions under
    the sequence entry ``entry``."""
    axis = seq_axis(entry)
    return 0 if axis is None else mesh.index(axis) * n_local


def to_cache_block(x: torch.Tensor, held: str, n_kv: int, shard
                   ) -> torch.Tensor:
    """A rank's K or V of a prefill (B rows as its batch slice, every
    position, heads ``held``) as its block of the cache that
    ``cache_specs`` lays out for the whole (B, S, KV, hd) leaf: its kv
    heads (``kv_heads_as``), then its positions (a slice: every rank
    computed them all)."""
    mesh = shard.mesh
    b = x.shape[0] * (mesh.size(shard.batch_axis) if shard.batch_split
                      else 1)
    spec = _kv_rule((b, x.shape[1], n_kv, x.shape[3]), mesh)
    x = kv_heads_as(x, held, spec[-2], mesh, n_kv)
    if seq_axis(spec[-3]) is not None:
        n = x.shape[1] // mesh_axis_size(mesh, spec[-3])
        x = x.narrow(1, seq_start(spec[-3], n, mesh), n)
    return x.contiguous()


def _data_gathered(ws, shard: TrainShard):
    """``TrainWeight``s with their "data" entries gathered in one bucket
    (``collectives.GatherBucket``; the gradient summed over the data ranks
    when their batches differ), a weight replicated over "data" passed
    through with its gradient summed there."""
    dims = [w.spec.index("data") if "data" in w.spec else None for w in ws]
    outs = col.gather_bucket([w.local for w in ws], dims, shard.mesh,
                             shard.batch_split)
    return [TrainWeight(t, tuple(None if e == "data" else e for e in w.spec),
                        w.shape, data_done=True) for w, t in zip(ws, outs)]


def gather_layer(tree, shard: Optional[TrainShard]):
    """A layer's (or the embedding's) weights with their "data" entries
    gathered in one bucket: the REPRO_WEIGHT_AG=0 path, and the
    embedding's once a step either way.  Anything but a ``TrainWeight``
    tree under fsdp_tp comes back as it is."""
    if shard is None or shard.mode != "fsdp_tp":
        return tree
    from repro_torch.train.tree import leaves
    ws = [w for w in leaves(tree) if isinstance(w, TrainWeight)
          and not w.data_done]
    if not ws:
        return tree
    done = dict(zip(map(id, ws), _data_gathered(ws, shard)))
    return _tree_map(lambda path, x: done.get(id(x), x), tree)


def resolve(w, shard: Optional[TrainShard], split: bool = False,
            keep_model: bool = False):
    """A weight at its use on a training mesh: (tensor, the dim that holds
    only this rank's "model" slice, or None).  Its "data" entry is gathered
    (``_data_gathered``); a "model" entry is kept when ``keep_model`` (the
    use is tensor-parallel on it), else gathered, the gradient summed over
    the model ranks when ``split`` (their compute differs) and kept whole
    when not.  A weight replicated over "model" used where the model ranks
    compute on different rows (``split``: a rank's heads, a sequence
    slice) goes through *f*.  A plain tensor comes back as it is."""
    if not isinstance(w, TrainWeight):
        return w, None
    if not w.data_done:
        w = _data_gathered([w], shard)[0]
    mesh = shard.mesh
    if "model" in w.spec:
        j = w.spec.index("model")
        if keep_model:
            return w.local, j
        return col.gather(w.local, mesh, "model", j, split), None
    if split:
        return col.copy_to(w.local, mesh, "model"), None
    return w.local, None


def weight_use(w, *logical, shard=None, split: bool = False):
    """A weight at its use site (``logical``: the reference's names of its
    dims).  On a training mesh (a ``TrainWeight``, ``shard`` the step's
    ``TrainShard``) it is ``resolve``d whole: gathered over "data" (each use
    under REPRO_WEIGHT_AG=1, a layer's bucket otherwise) and over "model";
    ``split`` says the model ranks compute on different rows here.  The
    tensor-parallel products keep their "model" slice through
    ``param_sharding.tp_linear`` / ``tp_embed`` and the MoE experts.  On
    the serve path with weight tensor parallelism (``shard`` of a
    ``ServeEngine(tp=True)``) this is ``param_sharding.tp_use``: the
    all-gathered weight, or the stored shard under
    REPRO_TP_REDUCE_SCATTER=1."""
    if isinstance(w, TrainWeight):
        return resolve(w, shard, split)[0]
    from repro_torch.distributed import param_sharding
    return param_sharding.tp_use(w, shard)


def constrain(x: torch.Tensor, *logical, shard=None, have=None
              ) -> torch.Tensor:
    """``x`` in the layout the logical names give (the reference's
    ``with_sharding_constraint`` through ``LOGICAL_AXES``).  The port
    tracks no layout on a tensor, so ``have`` names ``x``'s present one
    (default: the wanted one, a no-op).  On a training shard each dim moves
    between them: where an axis becomes sharded, the rank's part
    (``collectives.Split``); where it stops, an ``all_gather`` whose
    backward keeps the rank's part (the computation after it is
    replicated).  A no-op without a training shard, where the names and
    ``x`` differ in rank, on an axis of one rank, or where a dim does not
    divide; under "dp" only the batch names mean anything (the batch over
    every axis), as in the reference."""
    if not isinstance(shard, TrainShard) or len(logical) != x.dim():
        return x
    have = logical if have is None else have
    mesh = shard.mesh
    for dim, (want_name, have_name) in enumerate(zip(logical, have)):
        want = _axes(want_name, shard, mesh, x.shape[dim])
        has = _axes(have_name, shard, mesh, x.shape[dim])
        for axis in ("data", "model"):
            if axis in want and axis not in has:
                x = col.split(x, mesh, axis, dim)
            elif axis in has and axis not in want:
                x = col.gather(x, mesh, axis, dim, False)
    return x


def _axes(name, shard: TrainShard, mesh, size: int) -> tuple:
    """The mesh axes (of more than one rank) that logical ``name`` maps
    to, or () where the dim of ``size`` does not divide over them."""
    table = LOGICAL_AXES.get(name, ())
    if shard.mode == "dp":
        if name in ("batch", "fsdp"):
            table = tuple(mesh.shape.keys())
        elif name not in (None, "seq_dp"):
            table = ()
    axes = tuple(a for a in table if mesh.shape.get(a, 1) > 1)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return axes if axes and size % n == 0 else ()


# ---------------------------------------------------------------------------
# A train state's layout on a mesh
# ---------------------------------------------------------------------------

class Paired(tuple):
    """The spec of a fused in-projection laid out as two halves along its
    "model" dim (Mamba1's ``in_proj`` ``[x | z]``, Mamba2's ``in_proj_zx``
    ``[z | x]``): a rank holds its slice of the first half next to its
    slice of the second, so a column-parallel product gives it its own
    channels of both.  Equal to the plain spec (a tuple subclass), so the
    rules and their comparisons with the reference see the reference's
    spec; ``local_shard`` and ``unshard_tree`` read the halves.  A rank
    holds 1/n of the leaf's bytes, as under the plain spec."""


# the leaves whose "model" dim holds two halves (``Paired``)
PAIRED_LEAVES = ("in_proj", "in_proj_zx")


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """Where a train state lives on a training mesh: the spec tree of the
    weights (``param_specs``, the fused in-projections ``Paired``) and of
    each AdamW moment (``opt_state_specs``: the weight's, ZeRO-1 slices
    under "dp", or for int8 moments a ``Quantized`` of the payload's and
    the scales' specs, a range of the whole leaf's blocks), over
    ``mesh``."""
    mesh: Any
    params: Any
    moments: Any


def train_layout(cfg, params, mesh, opt_state: str = "f32",
                 quant_block: int = 256) -> TrainLayout:
    """The layout of ``params`` (full-shaped leaves, or anything with
    ``.shape``) and of AdamW moments of ``opt_state`` ("f32": shaped like
    them; "int8": block-quantized whole leaves) under
    REPRO_TRAIN_SHARDING."""
    def pair(path, spec):
        if path[-1] in PAIRED_LEAVES and "model" in spec:
            return Paired(spec)
        return spec
    pspecs = _map_specs(pair, param_specs(cfg, params, mesh))
    if opt_state == "int8":
        from repro_torch.train.optimizer import quantized_like
        moments = _tree_map(lambda path, leaf: quantized_like(
            tuple(leaf.shape), quant_block), params)
    else:
        moments = params
    mspecs = opt_state_specs(pspecs, {"m": moments, "v": moments},
                             mesh)["m"]
    return TrainLayout(mesh, pspecs, mspecs)


def _map_specs(fn, specs, path=()):
    """``fn(path, spec)`` over a spec tree (a spec, a tuple, is a leaf)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, path + (str(k),))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v, path + (str(i),))
                for i, v in enumerate(specs)]
    return fn(path, specs)


def _arrays(fn):
    """``fn(spec, tensor)`` lifted to a ``Quantized`` leaf: applied to its
    payload and its scales under their own specs."""
    def one(spec, x):
        from repro_torch.train.optimizer import Quantized
        if isinstance(x, Quantized):
            return Quantized(fn(spec.q, x.q), fn(spec.scale, x.scale),
                             x.shape, x.pad)
        return fn(spec, x)
    return one


def shard_tree(tree, specs, mesh, device=None):
    """Each leaf's slice on this rank (``local_shard`` at ``mesh.coords``),
    on ``device`` (default: the leaf's)."""
    coords = mesh.coords

    def one(spec, x):
        t = local_shard(x, spec, mesh, coords)
        return t if device is None else t.to(device)
    return _tree_map2(_arrays(one), specs, tree)


def unshard_tree(tree, specs, mesh, to_host: bool = False):
    """The whole leaves of a tree of this rank's slices, on every rank
    (``all_gather`` over each sharded dim's axes; several axes, as a ZeRO
    moment's, over every rank in row-major order; a ``Paired`` leaf's
    halves put back in place), each moved to the host as soon as it is
    whole when ``to_host``."""
    def one(spec, x):
        for d, e in enumerate(spec):
            if e is None:
                continue
            names = e if isinstance(e, tuple) else (e,)
            axis = names[0] if len(names) == 1 else "world"
            n = mesh.size(axis)
            x = mesh.gather(x, d, axis)
            if isinstance(spec, Paired) and e == "model" and n > 1:
                # [a_0 b_0 | a_1 b_1 | ...] -> [a_0 a_1 ... | b_0 b_1 ...]
                parts = x.chunk(2 * n, dim=d)
                x = torch.cat(parts[0::2] + parts[1::2], dim=d)
        return x.cpu() if to_host else x
    return _tree_map2(_arrays(one), specs, tree)


def train_weights(params, specs, mesh):
    """A tree of this rank's shards under ``specs`` as the ``TrainWeight``s
    the model functions read on a training mesh under fsdp_tp."""
    return _tree_map2(lambda spec, w: TrainWeight(
        w, tuple(spec), full_shape(w.shape, spec, mesh)), specs, params)


def full_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The whole shape of a slice of ``shape`` under ``spec``."""
    return tuple(n if e is None else n * mesh_axis_size(mesh, e)
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))

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
            return _kv_rule(shape, mesh)
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


def _kv_rule(shape, mesh) -> tuple:
    """``cache_specs``' entries of a (..., B, S, KV, hd) K/V leaf."""
    BA = batch_axes(mesh)
    nb = mesh_axis_size(mesh, BA)
    tp_n = mesh_axis_size(mesh, "model")
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
    return _spec(lead + (bent, s2, kvent, None))


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
    row-major, as the reference's ``NamedSharding`` lays them out; a
    ``Paired`` spec's "model" dim in each of its halves).  A tensor of its
    own (never a view of ``x``), contiguous."""
    out = x
    for d, (lo, size) in enumerate(shard_ranges(x.shape, spec, mesh,
                                                coords)):
        if len(lo) == 1:
            out = out.narrow(d, lo[0], size)
        else:
            out = torch.cat([out.narrow(d, a, size) for a in lo], dim=d)
    return out.clone(memory_format=torch.contiguous_format)


def shard_ranges(shape, spec, mesh, coords):
    """Per dim of a whole ``shape``, (the starts of the ranges the rank at
    ``coords`` holds, their common length): one range of 1/n of the dim
    (n the entry's axis-size product), or under ``Paired`` on "model" one
    in each half.  The rank's slice is their product, in order, so its
    row-major positions map to increasing positions of the whole."""
    out = []
    for d, n_d in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        if e is None:
            out.append(((0,), n_d))
            continue
        names = e if isinstance(e, tuple) else (e,)
        idx = 0
        for a in names:
            idx = idx * mesh_axis_size(mesh, a) + coords.get(a, 0)
        n = mesh_axis_size(mesh, names)
        halves = 2 if isinstance(spec, Paired) and e == "model" else 1
        if n_d % (n * halves):
            raise ValueError(f"dim {d} of size {n_d} does not split "
                             f"{n * halves} ways under spec {spec}")
        size = n_d // (n * halves)
        out.append((tuple(h * (n_d // halves) + idx * size
                          for h in range(halves)), size))
    return out
