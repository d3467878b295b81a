"""Rule-driven tensor-parallel weight sharding for serving (the port of
``src/repro/distributed/param_sharding.py``).

The flow:

  1. :func:`choose_tp_rules` asks Auto Distribution's SBP cost model
     (``repro_torch.core.distribution.choose_tp_layout``) which layout each
     weight family gets over the ``('model',)`` axis (column-parallel
     S(1), row-parallel S(0) or replicated B) and turns the kinds into an
     ordered list of :class:`ShardRule` regex rules.  Only structurally
     replicated leaves (norms, the MoE router) and the embedding table
     carry ``structural:*`` sources.
  2. :func:`tp_param_specs` matches every parameter path against the rules
     (a regex over a contiguous window of the path's keys) and builds a
     tree of specs.  A leaf no rule claims raises.
  3. ``ServeEngine(tp=True)`` keeps on each rank only its slice of every
     sharded leaf (:func:`shard_params`: a :class:`TPWeight`), beside the
     KV pool sharded on kv-heads.

Execution has two modes, set by ``REPRO_TP_REDUCE_SCATTER`` and carried
to the model functions in the engine's :class:`ServeShard` (an explicit
argument: two engines, one sharded and one not, may share a process):

  * off (default): :func:`tp_use` all-gathers each weight at its use, so
    the arithmetic is the single device's, bit for bit; only storage
    scales.
  * on: compute follows the stored layout (:func:`tp_linear`).
    Column-parallel q/k/v and MLP in-projections give the rank's heads and
    features with no collective; the row-parallel attention output and MLP
    down projections give partial sums, one ``all_reduce`` each a layer.
    Those two reorder the reduction, so outputs are fp32-close, not
    bitwise.  The vocab-sharded embedding is a masked local lookup plus an
    ``all_reduce``, and the tied logits are all-gathered over vocab: both
    exact (they add zeros or concatenate).

A training step on a mesh hands the same use sites its ``TrainShard``
(``repro_torch.distributed.sharding``) and ``TrainWeight`` shards, and
they compute in the reference's GSPMD layout on "model", differentiably:
column-parallel in-projections behind *f* (identity forward, an
``all_reduce`` of the input's cotangent), row-parallel out-projections
with *g* (one ``all_reduce`` forward, identity backward), the vocab-sharded
lookup as in reduce-scatter mode behind *g*, and the vocab-sharded logits
kept as the rank's slice for a vocab-parallel cross-entropy
(``collectives.VocabParallelCE``, through ``layers.lm_head_loss``: a
(B, S) max, sum and label logit cross the ranks, never the logits).  A
prefill or decode step's last-position logits are all-gathered (exact).
Serve behaviour is as above.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.hardware import H100, Hardware
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (TrainShard, _tree_map,
                                              local_shard, resolve)
from repro_torch.train.tree import leaves


@dataclasses.dataclass(frozen=True)
class ShardRule:
    """One partition rule: ``patterns`` are regexes matched against a
    contiguous window of the parameter's path keys (``("attn", "w[qkv]")``
    matches ``layers/3/attn/wq`` but not ``layers/3/moe/shared/wq``);
    ``trailing`` gives the mesh-axis entries of the trailing tensor dims
    (leading stack/expert dims are never sharded); ``source`` records
    provenance (``sbp:<kind>`` = emitted by the cost model,
    ``structural:*`` = replicated or derived)."""
    name: str
    patterns: Tuple[str, ...]
    trailing: Tuple[Optional[str], ...]
    source: str


def _match(patterns: Tuple[str, ...], keys: Tuple[str, ...]) -> bool:
    m = len(patterns)
    if m == 0 or m > len(keys):
        return False
    for start in range(len(keys) - m + 1):
        if all(re.fullmatch(p, k)
               for p, k in zip(patterns, keys[start:start + m])):
            return True
    return False


def _trail(kind: str) -> Tuple[Optional[str], ...]:
    """WeightChoice.kind of a 2-D (in, out) weight -> trailing spec."""
    if kind == "column":
        return (None, "model")
    if kind == "row":
        return ("model", None)
    return ()


def _trailing_spec(shape: Tuple[int, ...],
                   trailing: Tuple[Optional[str], ...],
                   n_model: int) -> tuple:
    ndim = len(shape)
    entries: List[Optional[str]] = [None] * ndim
    off = ndim - len(trailing)
    if off >= 0:
        for i, ax in enumerate(trailing):
            if ax is not None and shape[off + i] % n_model == 0:
                entries[off + i] = ax
    return tuple(entries)


def choose_tp_rules(cfg, n_model: int,
                    hw: Hardware = H100) -> List[ShardRule]:
    """The ordered rule list for ``cfg`` over ``n_model`` ranks, the matmul
    layouts chosen by Auto Distribution's SBP cost model on ``hw``
    (canonically: column qkv/up/gate, row wo/down, one collective a
    block)."""
    from repro_torch.core.distribution import choose_tp_layout

    d_ff = cfg.moe.d_ff_expert if cfg.moe is not None else cfg.d_ff
    plan = choose_tp_layout(d_model=cfg.d_model, q_dim=cfg.q_dim,
                            d_ff=d_ff, vocab=cfg.vocab, n_model=n_model,
                            hw=hw)
    qkv = plan.choices["wq"]
    attn_out = plan.choices["wo"]
    mlp_in = plan.choices["wi"]
    mlp_out = plan.choices["wdown"]
    head = plan.choices["wu"]

    rules = [
        ShardRule("attn_qkv", ("attn", "w[qkv]"),
                  _trail(qkv.kind), f"sbp:{qkv.kind}"),
        ShardRule("attn_out", ("attn", "wo"),
                  _trail(attn_out.kind), f"sbp:{attn_out.kind}"),
        ShardRule("mlp_in", ("mlp|shared", "wi(_gate|_up)?"),
                  _trail(mlp_in.kind), f"sbp:{mlp_in.kind}"),
        ShardRule("mlp_out", ("mlp|shared", "wo"),
                  _trail(mlp_out.kind), f"sbp:{mlp_out.kind}"),
        ShardRule("moe_expert_in", ("moe", "wi(_gate|_up)?"),
                  _trail(mlp_in.kind), f"sbp:{mlp_in.kind}"),
        ShardRule("moe_expert_out", ("moe", "wo"),
                  _trail(mlp_out.kind), f"sbp:{mlp_out.kind}"),
        ShardRule("moe_router", ("moe", "router"),
                  (), "structural:replicated"),
    ]
    if cfg.tie_embeddings:
        # the (vocab, d) table doubles as the unembed matmul weight; the
        # head choice on the logical (d, vocab) weight maps transposed
        tied = {"column": ("model", None), "row": (None, "model")}
        rules.append(ShardRule("embed_tied", ("embed", "embed"),
                               tied.get(head.kind, ()), f"sbp:{head.kind}"))
    else:
        rules.append(ShardRule("lm_head", ("embed", "unembed"),
                               _trail(head.kind), f"sbp:{head.kind}"))
        # shard the lookup table on vocab iff the head sharded at all:
        # derived from, not chosen by, the search
        rules.append(ShardRule("embed_table", ("embed", "embed"),
                               ("model", None) if head.kind != "replicated"
                               else (), "structural:vocab"))
    rules.append(ShardRule("replicated_rest", (".*",),
                           (), "structural:replicated"))
    return rules


def tp_param_specs(cfg, params, n_model: int,
                   rules: Optional[List[ShardRule]] = None):
    """Match every param path against the rules: ``(spec_tree, report)``,
    ``report`` mapping ``"a/b/c"`` path strings to the :class:`ShardRule`
    that claimed them.  Raises ``ValueError`` on a leaf no rule matches
    (the catch-all makes that impossible for the default rules; custom
    lists must stay total)."""
    if rules is None:
        rules = choose_tp_rules(cfg, n_model)
    report: Dict[str, ShardRule] = {}

    def claim(keys, leaf):
        for rule in rules:
            if _match(rule.patterns, keys):
                report["/".join(keys)] = rule
                return _trailing_spec(tuple(leaf.shape), rule.trailing,
                                      n_model)
        raise ValueError(f"no sharding rule matched param {'/'.join(keys)}")

    return _tree_map(claim, params), report


def validate_tp_divisibility(cfg, n_model: int,
                             heads_only: bool = False) -> None:
    """Fail at engine construction when ``cfg`` cannot be tensor-parallel
    over ``n_model`` ranks (the matcher would quietly replicate the
    offending leaves).  ``heads_only`` checks just the head counts, what a
    KV pool sharded on kv-heads needs without TP weights."""
    if n_model <= 1:
        return
    d_ff = cfg.moe.d_ff_expert if cfg.moe is not None else cfg.d_ff
    problems = []
    if cfg.n_heads % n_model:
        problems.append(f"n_heads={cfg.n_heads}")
    if cfg.n_kv_heads % n_model:
        problems.append(f"n_kv_heads={cfg.n_kv_heads}")
    if d_ff % n_model and not heads_only:
        problems.append(f"d_ff={d_ff}")
    if problems:
        raise ValueError(
            f"config {cfg.name!r} cannot shard over model axis of "
            f"{n_model}: {', '.join(problems)} not divisible")


# ---------------------------------------------------------------------------
# Stored shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TPWeight:
    """One rank's slice of a tensor-parallel weight: ``local`` is the
    contiguous slice of dim ``dim`` of the full ``shape``.  Use sites read
    it through :func:`tp_use` / :func:`tp_linear` / :func:`tp_embed`; a
    plain ``@`` on it fails."""
    local: torch.Tensor
    dim: int
    shape: Tuple[int, ...]

    @property
    def dtype(self):
        return self.local.dtype


def shard_params(params, specs, mesh):
    """The rank's params: each leaf whose spec names "model" becomes a
    :class:`TPWeight` of its slice; the rest stay the caller's tensors."""
    from repro_torch.distributed.sharding import _tree_map2

    def one(spec, w):
        if "model" not in spec:
            return w
        return TPWeight(local_shard(w, spec, mesh, {"model": mesh.rank}),
                        spec.index("model"), tuple(w.shape))
    return _tree_map2(one, specs, params)


def param_bytes_total(params) -> int:
    """Logical (replicated-equivalent) parameter bytes."""
    total = 0
    for leaf in leaves(params):
        n = leaf.dtype.itemsize
        for d in leaf.shape:
            n *= d
        total += n
    return total


def param_bytes_per_device(params) -> int:
    """Bytes this rank stores: a :class:`TPWeight`'s slice, every other
    leaf whole."""
    total = 0
    for leaf in leaves(params):
        t = leaf.local if isinstance(leaf, TPWeight) else leaf
        total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# Serve-time use sites
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeShard:
    """What a sharded engine hands its model calls: the mesh (this rank of
    the "model" axis) and whether TP weights compute in their stored layout
    (REPRO_TP_REDUCE_SCATTER=1) or are gathered at use."""
    mesh: object
    reduce_scatter: bool = False

    @property
    def n(self) -> int:
        return self.mesh.n_model

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def part(self, size: int) -> slice:
        """This rank's contiguous 1/n of an axis of ``size``."""
        k = size // self.n
        return slice(self.rank * k, (self.rank + 1) * k)


def tp_use(w, shard: Optional[ServeShard] = None):
    """A weight at its use site: a plain tensor as it is; a
    :class:`TPWeight` all-gathered to the full weight (identity mode, so
    the arithmetic is the single device's), or passed through in
    reduce-scatter mode for :func:`tp_linear` to compute in its layout."""
    if not isinstance(w, TPWeight):
        return w
    if shard is None:
        raise ValueError("a tensor-parallel weight used outside a sharded "
                         "call (pass the engine's ServeShard)")
    if shard.reduce_scatter:
        return w
    return shard.mesh.gather(w.local, w.dim)


def tp_hidden(h: torch.Tensor, shard: Optional[ServeShard] = None
              ) -> torch.Tensor:
    """The rank's slice of ``h``'s last (feature) dim, the layout a
    row-parallel weight consumes, in reduce-scatter mode; ``h`` otherwise."""
    if shard is None or not shard.reduce_scatter or shard.n <= 1 \
            or h.shape[-1] % shard.n:
        return h
    return h[..., shard.part(h.shape[-1])]


def tp_linear(x: torch.Tensor, w, shard: Optional[ServeShard] = None,
              x_local: bool = False, transpose: bool = False
              ) -> Tuple[torch.Tensor, bool]:
    """``x @ w`` (``x @ w.T`` with ``transpose``) on a sharded engine:
    returns ``(y, y_local)``, ``y_local`` when ``y`` holds only this rank's
    slice of its last dim.  ``x_local`` says the same of ``x``.

    A plain weight, or any weight in identity mode, multiplies the
    gathered ``x`` by the full weight.  In reduce-scatter mode a
    column-parallel weight (its output dim sharded) gives the local slice
    of ``y`` with no collective; a row-parallel one (its input dim
    sharded) multiplies the local slice of ``x`` and sums the partials
    over the ranks (one ``all_reduce``).  A training shard computes in the
    stored layout, differentiably (``_train_linear``)."""
    if isinstance(shard, TrainShard):
        return _train_linear(x, w, shard, x_local, transpose)
    if shard is None:
        return (x @ w.T if transpose else x @ w), False
    w = tp_use(w, shard)
    if not isinstance(w, TPWeight):
        if x_local:
            x = shard.mesh.gather(x, -1)
        return (x @ w.T if transpose else x @ w), False
    local = w.local.T if transpose else w.local
    out_dim = (1 - w.dim) if transpose else w.dim     # the logical (in, out)
    if out_dim == 1:                                  # column-parallel
        if x_local:
            x = shard.mesh.gather(x, -1)
        return x @ local, True
    if not x_local:                                   # row-parallel
        x = tp_hidden(x, shard)
    return shard.mesh.reduce(x @ local), False


def _train_linear(x, w, shard: TrainShard, x_local: bool,
                  transpose: bool) -> Tuple[torch.Tensor, bool]:
    """``tp_linear`` on a training mesh.  A weight kept sharded on "model"
    in a tensor-parallel region (``shard.tp``) is column-parallel when its
    output dim is the sharded one: ``x`` enters through *f* (or, a rank's
    slice, is gathered with its cotangent summed) and ``y`` is the rank's
    slice; row-parallel otherwise: ``x`` is the rank's slice (cut from a
    replicated ``x`` by ``Split``) and the partial sums meet in *g*.  Any
    other weight is gathered whole (``sharding.resolve``) and multiplies a
    whole ``x``."""
    mesh = shard.mesh
    t, j = resolve(w, shard, split=shard.model_split, keep_model=shard.tp)
    if j is None:
        if x_local:
            x = col.gather(x, mesh, "model", -1, False)
        return (x @ t.T if transpose else x @ t), False
    out_dim = (1 - j) if transpose else j
    local = t.T if transpose else t
    if out_dim == 1:                                  # column-parallel
        x = col.gather(x, mesh, "model", -1, True) if x_local \
            else col.copy_to(x, mesh, "model")
        return x @ local, True
    if not x_local:                                   # row-parallel
        x = col.split(x, mesh, "model", -1)
    return col.reduce_from(x @ local, mesh, "model"), False


def tp_whole(y: torch.Tensor, local: bool,
             shard: Optional[ServeShard] = None) -> torch.Tensor:
    """``y`` whole on its last dim: all-gathered over the ranks when it
    holds only this rank's slice (``local``, as :func:`tp_linear` says); on
    a training mesh the gather keeps the rank's part of the cotangent (what
    follows is replicated over "model").  The training loss does not gather
    its logits (``layers.lm_head_loss``)."""
    if not local:
        return y
    if isinstance(shard, TrainShard):
        return col.gather(y, shard.mesh, "model", -1, False)
    return shard.mesh.gather(y, -1)


def tp_embed(table, tokens: torch.Tensor,
             shard: Optional[ServeShard] = None) -> torch.Tensor:
    """Rows ``tokens`` of the embedding ``table``.  A vocab-sharded table
    in reduce-scatter mode looks up the rows this rank holds, zeros the
    rest and sums over the ranks (exact: each row has one nonzero
    source); a table sharded on d gathers its columns.  On a training
    mesh the vocab-sharded lookup is the same masked one behind *g*."""
    if isinstance(shard, TrainShard):
        return _train_embed(table, tokens, shard)
    table = tp_use(table, shard)
    if not isinstance(table, TPWeight):
        return table[tokens.long()]
    ids = tokens.long()
    if table.dim == 0:
        rows = table.local.shape[0]
        lo = shard.rank * rows
        mine = (ids >= lo) & (ids < lo + rows)
        out = table.local[(ids - lo).clamp(0, rows - 1)]
        out = torch.where(mine[..., None], out, torch.zeros_like(out))
        return shard.mesh.reduce(out)
    return shard.mesh.gather(table.local[ids], -1)


def _train_embed(table, tokens: torch.Tensor, shard: TrainShard
                 ) -> torch.Tensor:
    """``tp_embed`` on a training mesh: a table kept sharded on vocab
    looks up the rows this rank holds, zeros the rest and sums over
    "model" (*g*: exact, each row has one nonzero source); sharded on d,
    its columns are gathered (the rank's part of the cotangent kept)."""
    mesh = shard.mesh
    t, j = resolve(table, shard, split=shard.model_split, keep_model=shard.tp)
    ids = tokens.long()
    if j is None:
        return t[ids]
    if j == 1:
        return col.gather(t[ids], mesh, "model", -1, False)
    rows = t.shape[0]
    lo = mesh.coords["model"] * rows
    mine = (ids >= lo) & (ids < lo + rows)
    out = t[(ids - lo).clamp(0, rows - 1)]
    out = torch.where(mine[..., None], out, torch.zeros_like(out))
    return col.reduce_from(out, mesh, "model")
