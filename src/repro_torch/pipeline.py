"""Unified end-to-end nncase pipeline on PyTorch: one call from Term to an
executable over torch tensors.

The paper's framing is an *end-to-end* compiler — an e-graph term-rewriting
engine feeding Auto Vectorize, Auto Distribution, and Auto Schedule, closed
out by a buffer-aware Codegen.  This module is that driver, the port of
``src/repro/pipeline.py``: every pass is chained behind one entry point,

    from repro_torch.pipeline import compile
    result = compile(term, target=CompileTarget(...), options=CompileOptions(...))
    y = result(**inputs)                  # executable callable
    result.report.pass_times              # per-pass wall time
    result.report.modeled_speedup         # extraction cost vs baseline

Every pass reads the target's :class:`Hardware` record
(``CompileTarget.hardware``, default ``hardware.H100``), and the record is
part of the cache key.  Public names are the reference's, except:

  * ``CompileTarget.use_pallas`` -> ``CompileTarget.use_kernels`` (logical
    ``matmul`` runs the hand-written CUDA matmul kernel);
  * ``CompileTarget.hardware`` is new;
  * the schedule report's ``vmem_peak`` -> ``smem_peak`` (on-chip bytes:
    shared memory on the card), as is ``Schedule.smem_peak``; the report
    also carries the schedule's ``feasible`` flag.

Pass chain (each stage timed into ``CompileReport.pass_times``):

  rewrite     e-graph construction + transpose-rule equality saturation
  extract     cost-aware extraction — greedy / branch-and-bound / WPMaxSAT
  vectorize   MetaPackOperation saturation + re-extraction (packed variants)
  distribute  SBP strategy search (skipped on 1-device targets)
  schedule    Term -> TileGraph bridge, MCTS structure + MINLP tiles
  buffer      liveness + bin-packing memory plan (greedy or exact)
  codegen     compile_term -> callable over torch tensors (matmul kernel
              or ``@``)

Compilation results are cached content-addressed on
(package, term fingerprint, target with its hardware record, options) —
in-memory per ``Compiler`` and optionally on disk — so repeated serve /
benchmark invocations skip saturation and extraction entirely and only
re-run codegen.  The package name in the key keeps this package and the
JAX reference from ever loading each other's pickles out of one
``REPRO_CACHE_DIR``.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.buffer_schedule import (liveness_from_term, naive_peak,
                                              plan_greedy, plan_optimal)
from repro_torch.core.codegen import KernelPlan, compile_term, kernel_plan
from repro_torch.core.egraph import EGraph
from repro_torch.core.extraction import (branch_bound_extract, extract_term,
                                         greedy_extract, wpmaxsat_extract)
from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.rewrite import TRANSPOSE_RULES
from repro_torch.core.sbp import Placement
from repro_torch.core.schedule import auto_schedule
from repro_torch.core.schedule.ntt import op_ukernel
from repro_torch.core.schedule.tile_graph import (Buffer, Group, OpSpec,
                                                  TileGraph)
from repro_torch.core.tensor_ir import Term, term_shape
from repro_torch.core.vectorize import vectorize_rules

PIPELINE_VERSION = 1
# part of every cache key: an entry written by another package is never read
PACKAGE = "repro_torch"

PASS_NAMES = ("rewrite", "extract", "vectorize", "distribute", "schedule",
              "buffer", "codegen")

EXTRACTION_BACKENDS = ("greedy", "branch-and-bound", "wpmaxsat")


# ---------------------------------------------------------------------------
# Targets / options / report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompileTarget:
    """Where the compiled program runs: device mesh, per-device memory and
    the device's hardware record."""
    mesh_axes: Tuple[str, ...] = ("data",)
    mesh_sizes: Tuple[int, ...] = (1,)
    memory_capacity: Optional[int] = None    # bytes/device for distribution
    use_kernels: bool = False
    dtype_bytes: int = 2
    hardware: Hardware = H100

    @property
    def placement(self) -> Placement:
        return Placement(tuple(self.mesh_axes), tuple(self.mesh_sizes))

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.mesh_sizes:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Pass toggles and search budgets."""
    extraction: str = "wpmaxsat"         # one of EXTRACTION_BACKENDS
    saturation_iters: int = 8
    node_limit: int = 8000
    vectorize: bool = True
    distribute: Optional[bool] = None    # None = auto: only when devices > 1
    # the SBP e-graph is much larger than the vectorize one; WPMaxSAT there
    # is minutes-slow, so the distribution extractor is chosen separately
    # (memory-capped targets always use the exact branch & bound)
    distribution_use_sat: bool = False
    schedule: bool = True
    schedule_iterations: int = 25
    buffer_plan: str = "greedy"          # "greedy" | "optimal"
    cache: bool = True

    def __post_init__(self):
        if self.extraction not in EXTRACTION_BACKENDS:
            raise ValueError(f"extraction must be one of {EXTRACTION_BACKENDS},"
                             f" got {self.extraction!r}")
        if self.buffer_plan not in ("greedy", "optimal"):
            raise ValueError(f"unknown buffer_plan {self.buffer_plan!r}")


@dataclasses.dataclass
class CompileReport:
    """Per-pass telemetry for one compile() invocation."""
    pass_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    egraph: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extraction_backend: str = ""
    baseline_cost: float = 0.0           # greedy cost of the unrewritten term
    optimized_cost: float = 0.0          # cost of the final extracted term
    modeled_speedup: float = 1.0
    distribution: Optional[Dict[str, Any]] = None
    schedule: Optional[Dict[str, Any]] = None
    kernel_plan: Optional[KernelPlan] = None
    buffer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cache_hit: bool = False
    cache_key: str = ""
    total_seconds: float = 0.0

    def summary(self) -> str:
        lines = [f"cache_hit={self.cache_hit} "
                 f"backend={self.extraction_backend} "
                 f"total={self.total_seconds * 1e3:.1f}ms"]
        for name in PASS_NAMES:
            if name in self.pass_times:
                lines.append(f"  {name:10s} {self.pass_times[name] * 1e3:8.2f}ms")
        lines.append(f"  modeled: baseline {self.baseline_cost:.3e}s -> "
                     f"optimized {self.optimized_cost:.3e}s "
                     f"({self.modeled_speedup:.2f}x)")
        if self.distribution:
            lines.append(f"  distribute: cost {self.distribution['cost']:.3e}s "
                         f"peak {self.distribution['peak_memory'] / 1e6:.1f} MB/dev")
        if self.schedule:
            lines.append(f"  schedule: {self.schedule['baseline_latency']:.3e}s -> "
                         f"{self.schedule['latency']:.3e}s, "
                         f"smem peak {self.schedule['smem_peak'] / 2**10:.1f} KB")
        if self.buffer:
            lines.append(f"  buffer: peak {self.buffer['peak']} B "
                         f"(naive {self.buffer['naive']} B)")
        return "\n".join(lines)


@dataclasses.dataclass
class CompileResult:
    """Executable + the term it runs + full telemetry."""
    fn: Callable
    term: Term                           # final (possibly packed) term
    logical_term: Term                   # pre-vectorize logical term
    report: CompileReport

    def __call__(self, **inputs):
        return self.fn(**inputs)


# ---------------------------------------------------------------------------
# Term -> TileGraph bridge (feeds Auto Schedule from arbitrary 2-D terms)
# ---------------------------------------------------------------------------

_SCHEDULABLE_OPS = ("input", "matmul", "unary", "binary")


def tile_graph_from_term(term: Term) -> Optional[TileGraph]:
    """Lower a 2-D logical Term DAG to a TileGraph for Auto Schedule.

    Loop names come from unifying tensor dimensions across ops: matmul ties
    (A row, out row), (B col, out col) and (A col, B row) — the contraction
    loop; elementwise ops tie every dim to their inputs'.  Returns None when
    the term contains ops the schedule space doesn't model (packed/boxed
    forms are scheduled at kernel granularity instead).
    """
    topo: List[Term] = []
    seen: Dict[Term, int] = {}

    def walk(t: Term):
        if t in seen:
            return
        for c in t.children:
            walk(c)
        seen[t] = len(topo)
        topo.append(t)
    walk(term)

    shape_cache: Dict[Term, Tuple[int, ...]] = {}
    for t in topo:
        if t.op not in _SCHEDULABLE_OPS:
            return None
        if len(term_shape(t, shape_cache)) != 2:
            return None

    # union-find over (term index, dim) pairs -> shared loop names
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    contraction: Dict[int, Tuple[int, int]] = {}
    for t in topo:
        ti = seen[t]
        if t.op == "matmul":
            a, b = seen[t.children[0]], seen[t.children[1]]
            union((ti, 0), (a, 0))
            union((ti, 1), (b, 1))
            union((a, 1), (b, 0))
            contraction[ti] = (a, 1)
        elif t.op in ("unary", "binary"):
            for c in t.children:
                ci = seen[c]
                union((ti, 0), (ci, 0))
                union((ti, 1), (ci, 1))

    # name each dim class in first-seen topo order; verify extents agree
    loop_name: Dict[Tuple[int, int], str] = {}
    extents: List[Tuple[str, int]] = []
    extent_of: Dict[str, int] = {}
    for t in topo:
        ti = seen[t]
        for d, size in enumerate(term_shape(t, shape_cache)):
            root = find((ti, d))
            if root not in loop_name:
                name = f"l{len(extents)}"
                loop_name[root] = name
                extents.append((name, size))
                extent_of[name] = size
            elif extent_of[loop_name[root]] != size:
                return None

    def loops_of(ti: int, t: Term) -> Tuple[str, ...]:
        return tuple(loop_name[find((ti, d))]
                     for d in range(len(term_shape(t, shape_cache))))

    buffers: Dict[int, Buffer] = {}
    for t in topo:
        ti = seen[t]
        buffers[ti] = Buffer(f"t{ti}", loops_of(ti, t),
                             elem_bytes=2)

    ops: List[OpSpec] = []
    groups: List[Group] = []
    for t in topo:
        if t.op == "input":
            continue
        ti = seen[t]
        out_loops = loops_of(ti, t)
        if t.op == "matmul":
            k_loop = loop_name[find(contraction[ti])]
            op_loops = out_loops + (k_loop,)
        else:
            op_loops = out_loops
        reads = tuple(buffers[seen[c]] for c in t.children)
        spec = OpSpec(f"op{ti}", op_ukernel(t.op, t.attr("kind")),
                      op_loops, reads, buffers[ti])
        ops.append(spec)
        groups.append(Group((spec.name,), op_loops))
    if not ops:
        return None
    return TileGraph(tuple(ops), tuple(extents), tuple(groups))


# ---------------------------------------------------------------------------
# Fingerprinting (content-addressed cache keys)
# ---------------------------------------------------------------------------

def term_fingerprint(term: Term) -> str:
    """Stable content hash of a term tree (repr is deterministic: attrs are
    sorted tuples, children ordered)."""
    return hashlib.sha256(repr(term).encode()).hexdigest()


def cache_key(term: Term, target: CompileTarget,
              options: CompileOptions) -> str:
    payload = json.dumps({
        "package": PACKAGE,
        "v": PIPELINE_VERSION,
        "term": term_fingerprint(term),
        "target": repr(dataclasses.astuple(target)),
        "options": repr(dataclasses.astuple(options)),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# The compiler driver
# ---------------------------------------------------------------------------

class _Timer:
    def __init__(self, report: CompileReport, name: str):
        self.report, self.name = report, name

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.report.pass_times[self.name] = time.monotonic() - self.t0
        return False


def _extract(backend: str, eg: EGraph, root: int, hw: Hardware):
    if backend == "greedy":
        return greedy_extract(eg, root, hw=hw)
    if backend == "branch-and-bound":
        return branch_bound_extract(eg, root, hw=hw)
    return wpmaxsat_extract(eg, root, hw=hw)


class Compiler:
    """Stateful driver: owns the compile cache.

    By default the on-disk location comes from ``REPRO_CACHE_DIR`` (unset ->
    memory-only); pass ``cache_dir=<path>`` to persist extracted terms +
    reports across processes, or an explicit ``cache_dir=None`` to force a
    memory-only cache regardless of the environment.  Cache hits skip
    saturation/extraction/search and only re-run codegen (callables are not
    serializable; everything else is).
    """

    _FROM_ENV = object()

    def __init__(self, cache_dir=_FROM_ENV):
        if cache_dir is Compiler._FROM_ENV:
            cache_dir = os.environ.get("REPRO_CACHE_DIR") or None
        self.cache_dir = cache_dir
        self._memory: Dict[str, Dict[str, Any]] = {}
        self.stats = {"hits": 0, "misses": 0}

    # -- cache plumbing ----------------------------------------------------
    def _disk_path(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{key}.pkl")

    def _cache_get(self, key: str) -> Optional[Dict[str, Any]]:
        if key in self._memory:
            return self._memory[key]
        path = self._disk_path(key)
        if path and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    entry = pickle.load(f)
                self._memory[key] = entry
                return entry
            except Exception:
                return None
        return None

    def _cache_put(self, key: str, entry: Dict[str, Any]):
        self._memory[key] = entry
        path = self._disk_path(key)
        if not path:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        # atomic write: never leave a torn pickle for concurrent readers
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(entry, f)
            os.replace(tmp, path)
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # -- passes ------------------------------------------------------------
    def _run_pipeline(self, term: Term, target: CompileTarget,
                      options: CompileOptions, report: CompileReport
                      ) -> Tuple[Term, Term]:
        """Saturate/extract/search; returns (logical, packed) terms and
        fills in every report field except codegen timing."""
        hw = target.hardware
        # 1. rewrite: e-graph + transpose-rule equality saturation
        with _Timer(report, "rewrite"):
            eg = EGraph()
            root = eg.add_term(term)
            report.baseline_cost, _ = greedy_extract(eg, root, hw=hw)
            stats = eg.saturate(TRANSPOSE_RULES,
                                max_iters=options.saturation_iters,
                                node_limit=options.node_limit)
            report.egraph = {"rewrite_iters": stats["iters"],
                            "rewrite_applications": stats["applications"],
                            "size_after_rewrite": eg.size()}

        # 2. extract: cost-aware extraction with the selected backend
        with _Timer(report, "extract"):
            cost, choice = _extract(options.extraction, eg, root, hw)
            logical = extract_term(eg, root, choice)
            report.optimized_cost = cost

        # 3. vectorize: packed-variant saturation over the extracted term
        packed = logical
        if options.vectorize:
            with _Timer(report, "vectorize"):
                veg = EGraph()
                vroot = veg.add_term(logical)
                vstats = veg.saturate(vectorize_rules(hw) + TRANSPOSE_RULES,
                                      max_iters=options.saturation_iters,
                                      node_limit=options.node_limit)
                vcost, vchoice = _extract(options.extraction, veg, vroot, hw)
                packed = extract_term(veg, vroot, vchoice)
                report.optimized_cost = vcost
                report.egraph.update(
                    {"vectorize_iters": vstats["iters"],
                     "vectorize_applications": vstats["applications"],
                     "size_after_vectorize": veg.size()})
        report.modeled_speedup = (report.baseline_cost
                                  / max(report.optimized_cost, 1e-30))

        # 4. distribute: SBP search on the logical term (Fig. 6 granularity);
        # a 1-device mesh has exactly one strategy, so the search is skipped
        # unless explicitly forced with distribute=True
        do_dist = options.distribute
        if do_dist is None:
            do_dist = target.n_devices > 1
        if do_dist:
            from repro_torch.core.distribution import auto_distribute
            with _Timer(report, "distribute"):
                plan = auto_distribute(
                    logical, target.placement,
                    mem_capacity=target.memory_capacity,
                    use_sat=options.distribution_use_sat, hw=hw)
                report.distribution = {
                    "cost": plan.cost,
                    "peak_memory": plan.peak_memory,
                    "n_boxing": len(plan.boxing),
                    "assignments": plan.assignments,
                }

        # 5. schedule: MCTS structure + MINLP tiles over the tile graph
        if options.schedule:
            with _Timer(report, "schedule"):
                tg = tile_graph_from_term(logical)
                if tg is not None:
                    state, sched, base = auto_schedule(
                        tg, iterations=options.schedule_iterations, hw=hw)
                    report.schedule = {
                        "latency": sched.latency,
                        "baseline_latency": base.latency,
                        "t_mem": sched.t_mem,
                        "t_comp": sched.t_comp,
                        "smem_peak": sched.smem_peak,
                        "feasible": sched.feasible,
                        "groups": [list(g.ops) for g in state.groups],
                    }
                    report.kernel_plan = kernel_plan(sched, hw=hw)

        # 6. buffer: liveness + bin-packing plan on the final packed term
        with _Timer(report, "buffer"):
            bufs = liveness_from_term(packed, dtype_bytes=target.dtype_bytes)
            planner = plan_optimal if options.buffer_plan == "optimal" \
                else plan_greedy
            offsets, peak = planner(bufs)
            report.buffer = {"peak": peak, "naive": naive_peak(bufs),
                             "n_buffers": len(bufs),
                             "offsets": offsets}
        return logical, packed

    # -- entry point -------------------------------------------------------
    def compile(self, term: Term,
                target: Optional[CompileTarget] = None,
                options: Optional[CompileOptions] = None) -> CompileResult:
        target = target or CompileTarget()
        options = options or CompileOptions()
        if not isinstance(term, Term):
            raise TypeError(f"compile() expects a Term, got {type(term)!r}")
        t0 = time.monotonic()
        key = cache_key(term, target, options)

        entry = self._cache_get(key) if options.cache else None
        if entry is not None:
            self.stats["hits"] += 1
            # deep copy: the report's nested dicts must not alias the cache
            # entry, or caller mutation would poison every later hit
            report = CompileReport(**copy.deepcopy(entry["report"]))
            report.cache_hit = True
            report.cache_key = key
            with _Timer(report, "codegen"):
                fn = compile_term(entry["packed"],
                                  use_kernels=target.use_kernels)
            report.total_seconds = time.monotonic() - t0
            return CompileResult(fn, entry["packed"], entry["logical"],
                                 report)

        self.stats["misses"] += 1
        report = CompileReport(extraction_backend=options.extraction,
                               cache_key=key)
        logical, packed = self._run_pipeline(term, target, options, report)

        # 7. codegen: Term -> executable callable
        with _Timer(report, "codegen"):
            fn = compile_term(packed, use_kernels=target.use_kernels)
        report.total_seconds = time.monotonic() - t0

        if options.cache:
            # field-wise deep copy (dataclasses.asdict would mangle the SBP
            # objects nested in the distribution dict, and sharing dicts with
            # the returned report would let callers mutate the cache);
            # cache_hit/total_seconds are per-invocation, recomputed on hit
            stored = {f.name: copy.deepcopy(getattr(report, f.name))
                      for f in dataclasses.fields(report)
                      if f.name not in ("cache_hit", "total_seconds")}
            self._cache_put(key, {"packed": packed, "logical": logical,
                                  "report": stored})
        return CompileResult(fn, packed, logical, report)


_DEFAULT_COMPILER: Optional[Compiler] = None


def default_compiler() -> Compiler:
    global _DEFAULT_COMPILER
    if _DEFAULT_COMPILER is None:
        _DEFAULT_COMPILER = Compiler()
    return _DEFAULT_COMPILER


def compile(term: Term,
            target: Optional[CompileTarget] = None,
            options: Optional[CompileOptions] = None) -> CompileResult:
    """One-call end-to-end compile through the module-level default
    ``Compiler`` (shares its cache across callers in the process)."""
    return default_compiler().compile(term, target=target, options=options)
