"""Auto Distribution (§3.1.3): SBP strategy search embedded in the e-graph.

Implements the BuildEGraph algorithm of Fig. 5:

  1. *Input phase*: every graph input gets one Boxing e-node per feasible
     ND-SBP (host -> device split is free).
  2. *Compute phase*: topological walk; for each op, the Cartesian product of
     its inputs' available SBP classes (plus explicit *Resharding Boxing*
     candidates) is filtered through the op's SBP signature; resulting nodes
     with identical output SBP are unioned into one e-class ("same logic +
     same SBP => equivalent").  The per-logical-node dict {ndsbp: eclass} is
     the paper's E-Cluster.
  3. *Output phase*: Unshard Boxing to Broadcast, unioned into a single root.

Extraction = WPMaxSAT with roofline compute costs on *local shard shapes* and
alpha-beta boxing costs, under a hard per-device memory constraint.

The searched logical graphs are 2-D (tokens x features) block graphs — the
paper's Fig. 6 granularity.  Costs read the :class:`Hardware` record passed
as ``hw`` (default: the H100 SXM).

``ndsbp_to_pspec`` turns a chosen ND-SBP into the spec tuple that
``repro_torch.distributed.sharding`` and ``param_sharding`` use (the
reference's ``PartitionSpec`` entries).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.core.egraph import EGraph, ENode
from repro_torch.core.extraction import greedy_extract, wpmaxsat_extract
from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.sbp import (B, NdSbp, P, Placement, S, boxing_cost,
                            elementwise_axis_signatures, matmul_axis_signatures,
                            memory_bytes, resolve_tag, shard_shape, valid_ndsbps)
from repro_torch.core.tensor_ir import Term


def _tag_of(sbp) -> str:
    if isinstance(sbp, S):
        return f"S{sbp.axis}"
    return "B" if sbp is B else "P"


def _signatures_for(op: str, kind: Optional[str], arity: int):
    if op == "matmul":
        return matmul_axis_signatures()
    linear = kind in ("add", "sub", "neg", None) and op == "binary"
    return elementwise_axis_signatures(arity, linear=linear)


def _apply_signature(op, kind, in_sbps: Tuple[NdSbp, ...], ndim_out: int,
                     pl: Placement) -> Optional[NdSbp]:
    """Per-axis signature check; returns the output ND-SBP or None."""
    sigs = _signatures_for(op, kind, len(in_sbps))
    out = []
    for ax in range(pl.ndim):
        tags = tuple(_tag_of(s[ax]) for s in in_sbps)
        matched = None
        for inputs, result in sigs:
            if inputs == tags:
                matched = result
                break
        if matched is None:
            return None
        r = resolve_tag(matched, ndim_out)
        if r is None:
            return None
        out.append(r)
    return tuple(out)


@dataclasses.dataclass
class DistEGraph:
    eg: EGraph
    root: int
    placement: Placement
    terms: List[Term]
    eclusters: Dict[int, Dict[NdSbp, int]]   # term index -> {ndsbp: eclass}


def build_distributed_egraph(root_term: Term, pl: Placement,
                             max_sbps_per_tensor: int = 24) -> DistEGraph:
    """BuildEGraph (Fig. 5): embed every feasible SBP strategy of ``root_term``
    into one e-graph over placement ``pl``.

    Node vocabulary of the result:
      * ``input`` leaves — one per (graph input, feasible SBP) pair, each fed
        through a free ``box comm="split"`` node (host -> device split).  The
        split box *is* the input's placement choice, and its per-device
        memory (``make_mem_fn``) is how weight storage enters the capacity
        constraint: a replicated weight charges full bytes, a sharded one
        bytes/n.
      * compute nodes — one per (op, input-SBP combo) that an SBP signature
        accepts; the chosen input SBPs are recorded in the ``in_sbps`` attr
        (consumed by ``make_cost_fn(input_traffic=True)``) and nodes with the
        same output SBP are unioned into one e-class (the paper's E-Cluster:
        "same logic + same SBP => equivalent").
      * ``box comm="reshard"`` nodes — explicit Resharding Boxing candidates
        (all-gather / all-to-all / all-reduce / reduce-scatter) wherever
        ``boxing_cost`` says the conversion exists.

    The returned ``DistEGraph`` carries the topo-ordered ``terms`` list (term
    index == the ``term_id`` attr on every node) and the per-term
    ``eclusters`` dict mapping each ND-SBP to its e-class."""
    eg = EGraph()
    # collect unique terms in topo order
    topo: List[Term] = []
    seen = {}

    def walk(t: Term):
        if t in seen:
            return
        for c in t.children:
            walk(c)
        seen[t] = len(topo)
        topo.append(t)
    walk(root_term)

    from repro_torch.core.tensor_ir import term_shape
    shape_cache: Dict[Term, Tuple[int, ...]] = {}
    for t in topo:
        shape_cache[t] = term_shape(t, shape_cache)

    eclusters: Dict[int, Dict[NdSbp, int]] = {}

    def add_box(src_class: int, tid: int, src: NdSbp, dst: NdSbp,
                shape) -> Optional[int]:
        if boxing_cost(src, dst, shape, pl) is None:
            return None
        node = ENode("box", (src_class,),
                     tuple(sorted({"term_id": tid, "src": src, "sbp": dst,
                                   "comm": "reshard"}.items())))
        return eg.add(node)

    for tid, t in enumerate(topo):
        shape = shape_cache[t]
        cluster: Dict[NdSbp, int] = {}
        if t.op == "input":
            # 1. Input phase: host split boxing, one class per feasible SBP
            for nd in valid_ndsbps(shape, pl)[:max_sbps_per_tensor]:
                leaf = eg.add(ENode("input", (),
                                    t.attrs + (("term_id", tid),)))
                node = ENode("box", (leaf,),
                             tuple(sorted({"term_id": tid, "src": None,
                                           "sbp": nd, "comm": "split"}.items())))
                cluster[nd] = eg.add(node)
        else:
            # 2. Compute phase: reuse + resharding candidates per input
            in_grps: List[List[Tuple[NdSbp, int]]] = []
            for c in t.children:
                cin = eclusters[seen[c]]
                cands: Dict[NdSbp, int] = dict(cin)
                cshape = shape_cache[c]
                targets = valid_ndsbps(cshape, pl,
                                       allow_partial=False)[:max_sbps_per_tensor]
                for dst in targets:
                    if dst in cands:
                        continue
                    # reshard from the (arbitrary) first available source
                    for src, cls in cin.items():
                        bid = add_box(cls, seen[c], src, dst, cshape)
                        if bid is not None:
                            cands[dst] = bid
                            break
                in_grps.append(list(cands.items()))
            kind = t.attr("kind")
            for combo in itertools.product(*in_grps):
                in_sbps = tuple(nd for nd, _ in combo)
                out_sbp = _apply_signature(t.op, kind, in_sbps, len(shape), pl)
                if out_sbp is None:
                    continue
                if shard_shape(shape, out_sbp, pl) is None:
                    continue
                node = ENode(t.op, tuple(cls for _, cls in combo),
                             t.attrs + tuple(sorted(
                                 {"term_id": tid, "sbp": out_sbp,
                                  "in_sbps": in_sbps}.items())))
                nid = eg.add(node)
                if out_sbp in cluster:
                    cluster[out_sbp] = eg.union(cluster[out_sbp], nid)
                else:
                    cluster[out_sbp] = nid
        eclusters[tid] = cluster

    # 3. Output phase: unshard to full Broadcast
    root_tid = seen[root_term]
    rshape = shape_cache[root_term]
    full_b = tuple(B for _ in range(pl.ndim))
    root_class = None
    for src, cls in eclusters[root_tid].items():
        if src == full_b:
            rid = cls
        else:
            rid = add_box(cls, root_tid, src, full_b, rshape)
        if rid is None:
            continue
        root_class = rid if root_class is None else eg.union(root_class, rid)
    eg.rebuild()
    # re-canonicalize cluster ids
    for tid in eclusters:
        eclusters[tid] = {nd: eg.find(c) for nd, c in eclusters[tid].items()}
    return DistEGraph(eg, eg.find(root_class), pl, topo, eclusters)


# ---------------------------------------------------------------------------
# Costs on shard shapes
# ---------------------------------------------------------------------------

def make_cost_fn(dg: DistEGraph, dtype_bytes: int = 2,
                 input_traffic: bool = False, hw: Hardware = H100):
    """Per-ENode roofline cost on *local shard shapes* (seconds).

    Boxing nodes cost their alpha-beta collective time (``boxing_cost``);
    host-split boxing and raw input leaves are free.  Compute nodes cost
    ``max(flops / hw.matrix_flops, bytes / hw.mem_bw)`` over the *local* output
    shard, so a sharded strategy is cheaper exactly when it shrinks the
    per-device working set.

    ``input_traffic=True`` switches the matmul HBM term from the legacy
    ``3 * out_bytes`` approximation to the true local traffic
    ``(lhs_local + rhs_local + out_local) bytes``, using the per-node
    ``in_sbps`` attr to shard the operand shapes.  That makes weight-read
    traffic visible to the search — a column/row-sharded weight streams
    ``1/n`` of its bytes per device — which is what lets
    ``choose_tp_layout`` discriminate tensor-parallel layouts whose output
    shards are identical.  The legacy form stays the default because
    existing extraction tests pin layouts chosen under it.
    """
    pl = dg.placement
    from repro_torch.core.tensor_ir import term_shape
    shape_cache: Dict[Term, Tuple[int, ...]] = {}
    shapes = [term_shape(t, shape_cache) for t in dg.terms]
    tmap = {t: i for i, t in enumerate(dg.terms)}

    def cost(node: ENode) -> float:
        tid = node.attr("term_id")
        sbp = node.attr("sbp")
        if node.op == "input":
            return 0.0
        shape = shapes[tid]
        if node.op == "box":
            if node.attr("comm") == "split":
                return 0.0
            return boxing_cost(node.attr("src"), sbp, shape, pl,
                               dtype_bytes, hw=hw) or 0.0
        local = shard_shape(shape, sbp, pl)
        if local is None:
            return 1e9
        elems = 1
        for d in local:
            elems *= d
        if node.op == "matmul":
            in_sbps = node.attr("in_sbps")
            if input_traffic and in_sbps is not None:
                term = dg.terms[tid]
                a_full = shapes[tmap[term.children[0]]]
                b_full = shapes[tmap[term.children[1]]]
                a_local = shard_shape(a_full, in_sbps[0], pl)
                b_local = shard_shape(b_full, in_sbps[1], pl)
                if a_local is None or b_local is None:
                    return 1e9
                k_local = a_local[-1]
                in_elems = 1
                for d in a_local:
                    in_elems *= d
                b_elems = 1
                for d in b_local:
                    b_elems *= d
                in_elems += b_elems
                flops = 2 * elems * k_local
                return max(flops / hw.matrix_flops,
                           (in_elems + elems) * dtype_bytes / hw.mem_bw)
            # legacy approximation: full contraction dim, 3x output bytes
            k_local = shape[1]  # fallback
            ch_sbp = None
            for n2 in dg.eg.nodes(node.children[0]):
                ch_sbp = n2.attr("sbp")
                break
            flops = 2 * elems * k_local
            return max(flops / hw.matrix_flops,
                       3 * elems * dtype_bytes / hw.mem_bw)
        return max(elems * 4 / hw.vector_flops,
                   3 * elems * dtype_bytes / hw.mem_bw)

    return cost


def make_mem_fn(dg: DistEGraph, dtype_bytes: int = 2):
    """Per-ENode *per-device* memory in bytes (``memory_bytes`` of the local
    shard; Partial tensors charge full size since every device holds an
    unreduced copy).  Input split boxes charge the placed weight/activation,
    so summing over a chosen extraction approximates per-device peak
    residency — the quantity ``auto_distribute(mem_capacity=...)`` caps."""
    pl = dg.placement
    from repro_torch.core.tensor_ir import term_shape
    shape_cache: Dict[Term, Tuple[int, ...]] = {}
    shapes = [term_shape(t, shape_cache) for t in dg.terms]

    def mem(node: ENode) -> int:
        tid = node.attr("term_id")
        sbp = node.attr("sbp")
        if node.op == "input" or sbp is None:
            return 0
        return memory_bytes(shapes[tid], sbp, pl, dtype_bytes)

    return mem


@dataclasses.dataclass
class DistributedPlan:
    """Result of :func:`auto_distribute`.

    Attributes:
      cost: modelled execution time of the chosen strategy (seconds).
      assignments: term index (into the builder's topo order) -> chosen
        ND-SBP.  Input terms map to their host-split placement — for a
        weight input this *is* its tensor-parallel layout.
      boxing: ``(term_id, src, dst)`` resharding collectives the plan
        inserts between producer and consumer.
      peak_memory: summed per-device bytes of every chosen node (the value
        checked against ``mem_capacity``).
    """
    cost: float
    assignments: Dict[int, NdSbp]        # term index -> chosen ND-SBP
    boxing: List[Tuple[int, NdSbp, NdSbp]]
    peak_memory: int


def auto_distribute(root_term: Term, pl: Placement,
                    mem_capacity: Optional[int] = None,
                    use_sat: bool = True,
                    input_traffic: bool = False,
                    dtype_bytes: int = 2,
                    hw: Hardware = H100) -> DistributedPlan:
    """Search the SBP strategy space of ``root_term`` over placement ``pl``.

    Builds the distributed e-graph (every feasible per-tensor SBP plus
    resharding boxing) and extracts the min-cost strategy:

      * ``mem_capacity`` set -> exact branch-and-bound with a hard
        per-device byte cap (raises ``ValueError`` when no strategy fits);
      * otherwise WPMaxSAT (``use_sat=True``) or greedy extraction.

    ``input_traffic``/``dtype_bytes``/``hw`` configure :func:`make_cost_fn`;
    see there for why weight-read traffic is opt-in.
    """
    dg = build_distributed_egraph(root_term, pl)
    cost_fn = make_cost_fn(dg, dtype_bytes=dtype_bytes,
                           input_traffic=input_traffic, hw=hw)
    mem_fn = make_mem_fn(dg, dtype_bytes=dtype_bytes)
    if mem_capacity is not None:
        # hard per-device memory capacity: the specialized exact B&B prunes
        # over-capacity branches monotonically (see extraction.py)
        from repro_torch.core.extraction import branch_bound_extract
        total, choice = branch_bound_extract(dg.eg, dg.root, cost_fn,
                                             mem_fn=mem_fn, cap=mem_capacity)
    elif use_sat:
        total, choice = wpmaxsat_extract(dg.eg, dg.root, cost_fn)
    else:
        total, choice = greedy_extract(dg.eg, dg.root, cost_fn)
    assignments: Dict[int, NdSbp] = {}
    boxing = []
    peak = 0
    for cid, node in choice.items():
        tid = node.attr("term_id")
        peak += mem_fn(node)
        if node.op == "box":
            if node.attr("comm") == "split":
                # input placement choice = the initial shard boxing target
                assignments[tid] = node.attr("sbp")
            else:
                boxing.append((tid, node.attr("src"), node.attr("sbp")))
        elif node.op != "input":
            assignments[tid] = node.attr("sbp")
    return DistributedPlan(total, assignments, boxing, peak)


def ndsbp_to_pspec(nd: NdSbp, pl: Placement, tensor_ndim: int) -> tuple:
    """A placement's partition spec (the reference's ``PartitionSpec``
    entries as a tuple): dim d gets every mesh axis whose SBP is S(d), a
    bare name for one axis, a tuple for several, None for none."""
    entries: List[Optional[Tuple[str, ...]]] = [None] * tensor_ndim
    for axis_name, sbp in zip(pl.axes, nd):
        if isinstance(sbp, S):
            cur = entries[sbp.axis] or ()
            entries[sbp.axis] = tuple(cur) + (axis_name,)
    return tuple(e if e is None or len(e) > 1 else e[0] for e in entries)


# ---------------------------------------------------------------------------
# Tensor-parallel layout choice for serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeightChoice:
    """Layout the search picked for one weight matrix.

    ``kind`` classifies the single-mesh-axis SBP of a 2-D ``(in, out)``
    weight: ``"column"`` = S(1) (output features sharded, no collective on
    this matmul), ``"row"`` = S(0) (contraction sharded, produces Partial
    output that costs one all-reduce), ``"replicated"`` = B.
    """
    name: str
    sbp: object
    kind: str


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Per-weight tensor-parallel layout emitted by :func:`choose_tp_layout`.

    ``choices`` maps weight name -> :class:`WeightChoice`; ``fallback``
    lists blocks where branch-and-bound found no strategy under the memory
    cap (non-divisible dims) and replicated layouts were substituted.
    ``cost``/``peak_memory`` aggregate the per-block plans for reporting.
    """
    n_model: int
    choices: Dict[str, WeightChoice]
    cost: float
    peak_memory: int
    fallback: Tuple[str, ...]


def _weight_kind(sbp) -> str:
    if isinstance(sbp, S):
        return "column" if sbp.axis == 1 else "row"
    return "replicated"


def choose_tp_layout(*, d_model: int, q_dim: int, d_ff: int, vocab: int,
                     n_model: int, tokens: int = 8,
                     dtype_bytes: int = 2, hw: Hardware = H100) -> TPPlan:
    """Have Auto Distribution pick the tensor-parallel weight layout.

    Models a decode step as three block graphs at the paper's Fig. 6
    granularity — attention projections ``x @ wq -> silu -> @ wo``, the MLP
    ``x @ wi -> silu -> @ wdown``, and the LM head ``x @ wu`` — and runs
    each through :func:`auto_distribute` over a 1-D ``('model',)`` placement
    of ``n_model`` devices with:

      * a per-device memory cap that admits only ``1/n``-sharded weight
        storage (full activations allowed), so replicating any weight is
        infeasible by construction, and
      * ``input_traffic=True`` compute costs plus alpha-beta boxing costs,
        so among the feasible sharded layouts the one with the fewest /
        cheapest collectives wins (canonically: column-parallel wq/wi,
        row-parallel wo/wdown — exactly one all-reduce per block).

    The chosen per-weight ND-SBPs come back as :class:`WeightChoice`
    entries; blocks whose dims don't divide ``n_model`` fall back to
    replicated and are recorded in ``TPPlan.fallback``.  The sharded serve
    engine takes its partition rules from here
    (``repro_torch.distributed.param_sharding.choose_tp_rules``).
    """
    from repro_torch.core.tensor_ir import inp, matmul, term_shape, unary

    pl = Placement(("model",), (n_model,))

    def chain(weights):
        t = inp("x", (tokens, d_model))
        for i, (name, shape) in enumerate(weights):
            t = matmul(t, inp(name, shape))
            if i < len(weights) - 1:
                t = unary(t, "silu")
        return t

    blocks = [
        ("attn", chain([("wq", (d_model, q_dim)), ("wo", (q_dim, d_model))])),
        ("mlp", chain([("wi", (d_model, d_ff)), ("wdown", (d_ff, d_model))])),
        ("head", chain([("wu", (d_model, vocab))])),
    ]
    weight_names = {
        "attn": ("wq", "wo"),
        "mlp": ("wi", "wdown"),
        "head": ("wu",),
    }

    choices: Dict[str, WeightChoice] = {}
    total_cost = 0.0
    peak = 0
    fallback: List[str] = []
    for bname, root in blocks:
        wnames = weight_names[bname]
        dg = build_distributed_egraph(root, pl)
        shape_cache: Dict[Term, Tuple[int, ...]] = {}
        w_bytes = 0
        other_bytes = 0
        for t in dg.terms:
            nb = dtype_bytes
            for d in term_shape(t, shape_cache):
                nb *= d
            if t.op == "input" and t.attr("name") in wnames:
                w_bytes += nb
            else:
                other_bytes += nb
        root_nb = dtype_bytes
        for d in term_shape(root, shape_cache):
            root_nb *= d
        # weights must fit 1/n-sharded; activations may stay full; the root
        # unshard box charges one extra full copy of the output
        cap = w_bytes // n_model + other_bytes + root_nb
        weight_terms = [(tid, t) for tid, t in enumerate(dg.terms)
                        if t.op == "input" and t.attr("name") in wnames]
        try:
            plan = auto_distribute(root, pl, mem_capacity=cap,
                                   input_traffic=True,
                                   dtype_bytes=dtype_bytes, hw=hw)
        except ValueError:
            fallback.append(bname)
            for _, t in weight_terms:
                name = t.attr("name")
                choices[name] = WeightChoice(name, (B,), "replicated")
            continue
        total_cost += plan.cost
        peak = max(peak, plan.peak_memory)
        for tid, t in weight_terms:
            name = t.attr("name")
            nd = plan.assignments.get(tid, (B,))
            choices[name] = WeightChoice(name, nd, _weight_kind(nd[0]))
    return TPPlan(n_model, choices, total_cost, peak, tuple(fallback))
