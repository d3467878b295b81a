"""Paged-KV continuous-batching serve engine over a tiered KVStore (the
single-device port of ``src/repro/serve/engine.py``).

KV memory is owned by ``repro_torch.serve.kv_store``: refcounted block
handles in named storage tiers — the device block pool
(``repro_torch.serve.paged_cache``) and a pinned host swap tier.  Each
request holds an ordered table of handles, blocks are allocated as its
sequence grows and released the step it retires.  On top of the handles:

  * **Prefix sharing (copy-on-write)** — completed prompts register their
    blocks in the store's budgeted prefix registry; a later request whose
    prompt shares a prefix ``fork()``s the same physical blocks instead of
    re-prefilling them, and any write into a still-shared block is
    privatized by a device-side copy first.
  * **Preemption-by-swap** — optimistic admission's evictions park the
    victim's KV on the host tier (``REPRO_KV_SWAP=1``, the default) and
    restore it on re-admission, resuming mid-generation; with the knob off,
    preemption falls back to drop-and-restart-from-prompt.

Scheduling is continuous batching with **chunked prefill**: every engine step
runs (a) at most one prompt chunk for one admitting request and (b) one
batched decode step for every live request.  Admission is worst-case by
default (``prompt + max_new - 1`` written KV positions, plus one spare block
when the prefix registry may force a copy-on-write of the prompt's partial
tail block); ``admission="optimistic"`` reserves only the prompt footprint
and preempts the youngest request when the pool runs dry.

Per-request sampling: greedy, temperature, top-k — Gumbel-max draws keyed on
(request seed, token index), stateless and host-side.

Multi-LoRA: requests name a tenant in ``adapter_id``.  Tenants share the
base weights and the KV pool; their low-rank deltas live in one device slab
(``repro_torch.serve.adapters.AdapterStore``, loaded with
``load_adapter``), and every dispatch with an adapter row carries a
``lora`` descriptor through which the segmented LoRA kernels apply each
row's own delta.  Prefixes are registered per tenant namespace, and a
dispatch without adapter rows runs no LoRA code at all.  An MoE arch's
tenants adapt the four attention projections only (its experts are routed
per token); the stateful families' are refused.

The dense and moe families hold KV only.  The vlm and audio families are
refused (see ``__init__``).  An MoE layer routes each token in
the model call itself: a prefill chunk dispatches its tokens with a
capacity computed for that chunk, so where experts overflow, the tokens a
chunk drops depend on the chunking (as in the reference engine).

Kernel planning (``plan_kernels=True``, the default) compiles the paged
decode and prefill-chunk attention terms through ``repro_torch.pipeline`` on
the engine's hardware record, as the reference engine does; the plan's kv
tile becomes the paged-attention kernel's ``pages_per_fetch`` and its LoRA
tile the expand kernel's ``block_out``.

Stateful families (ssm, hybrid) carry each request's O(1) recurrent state
in a ``StateSlab`` beside the block pool: one slab slot per live request
(slot 0 is the null slot of padded decode rows), claimed at admission,
swapped whole to the slab's host tier when the request is preempted and
released on every terminal path.  The attention-free ssm family reserves
and grows no KV blocks at all; the hybrid holds both.  Prefix sharing is
off for both (adopted KV blocks cannot rebuild a scan state), and their
prefill chunks are rounded up to the scan granule ``cfg.ssm.chunk``.

The model functions run eagerly and update the KV slab and the state slab
in place.  Paged attention launches the CUDA kernel for CUDA tensors and
takes the gather path for CPU tensors (REPRO_PAGED_ATTN).

Multi-device serving (``mesh=``, REPRO_SERVE_MESH): one process per
device, each rank a replicated state machine over its own shard.  Every
rank builds the same engine; its pool holds KV/n heads of every block
(the block ids, refcounts and tables are the same on every rank), its host
tier parks that slice, and with ``tp=True`` (REPRO_SERVE_TP) it stores its
1/n of the weights (``repro_torch.distributed.param_sharding``; an MoE
arch's expert stacks are split inside each expert, ``models/moe.py``).
Rank 0 owns the inputs: ``submit`` and ``cancel`` there are carried to
every rank by the one ``broadcast_object_list`` that opens each ``step()``,
with rank 0's clock, which is the clock the deadline reaper reads on every
rank; the other ranks run ``follow()`` (or ``follow_all`` over several
engines on one mesh, whose steps rank 0 takes one at a time under
``MESH_LOCK``) until rank 0's ``close()``.  Each step ends with one
``all_gather``, on the mesh's control group, of a triple from every rank: a
digest of its plan (admissions, chunks, decode rows, sampled tokens) or
the request its crash blames, and the model collectives it entered.  Ranks
that all planned alike go on; ranks that all crashed blaming the same
request after the same collectives quarantine it alike under
``step_guarded``; any other outcome raises ``MeshDivergence`` on every
rank rather than letting the ranks' collectives drift apart.  Adapters and the ssm and hybrid
families are refused on a mesh, as in the reference.

``cancel(rid)`` aborts a request wherever it lives and frees its blocks the
same call; ``note_gateway_shed`` counts the gateway's refusals at the door.
Both serve ``repro_torch.serve.async_engine`` and ``serve.gateway``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.codegen import lora_tiles, paged_pages_per_fetch
from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.tensor_ir import inp, matmul, unary
from repro_torch.distributed import param_sharding
from repro_torch.distributed.param_sharding import ServeShard
from repro_torch.models import build_model
from repro_torch.perf import perf
from repro_torch.pipeline import (CompileOptions, CompileTarget, Compiler,
                                  default_compiler)
from repro_torch.serve.adapters import AdapterStore, AdapterStoreFull
from repro_torch.serve.faults import (FaultInjector, InjectedFault,
                                      check_kv_invariants)
from repro_torch.serve.kv_store import (DEVICE, HOST, Block, BlockTable,
                                        DeviceTier, HostTier, KVStore,
                                        SlabDeviceView, StateSlab)
from repro_torch.serve.paged_cache import (BlockPool, PoolExhausted,
                                           ServeMetrics, blocks_for_tokens,
                                           dense_equiv_blocks,
                                           worst_case_blocks)


class MeshDivergence(RuntimeError):
    """The ranks of a sharded engine planned different steps, or did not
    crash alike."""


# Every collective of a mesh engine in this process runs under this lock:
# two engines on one mesh (the gateway's models, each stepped by a thread
# of its own on rank 0) must not interleave collectives on one process
# group, and concurrent NCCL communicators on one card can deadlock.  Rank
# 0 holds it from a step's broadcast to its digest gather.
MESH_LOCK = threading.RLock()
# the id each mesh engine's broadcasts carry, so a follower of several
# engines (``follow_all``) knows which one steps; ranks build their engines
# in one order, so the ids agree
_MESH_IDS = itertools.count()


def _mesh_from_knob():
    """REPRO_SERVE_MESH: "0"/""/"off" = one device (None), "auto" = every
    rank of the process group, an int = a group of exactly that many."""
    knob = perf().serve_mesh
    if knob in ("", "0", "off"):
        return None
    from repro_torch.launch.mesh import make_serve_mesh
    return make_serve_mesh(None if knob == "auto" else int(knob))


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding strategy.  temperature <= 0 means greedy;
    top_k == 0 means the full vocabulary."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    sampling: SamplingParams = GREEDY
    # multi-LoRA tenant (None = base model); must be loaded (or evicted to
    # the host tier) on the engine, see ServeEngine.load_adapter
    adapter_id: Optional[str] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False
    cancelled: bool = False
    reject_reason: str = ""
    # fault-tolerance terminal states
    expired: bool = False       # deadline reaper killed it
    shed: bool = False          # bounded queue refused it at submit
    errored: bool = False       # quarantined by a step-loop crash
    error: str = ""             # why (crash message)
    # per-request deadline in ms from submit; None consults the
    # REPRO_SERVE_DEADLINE_MS default, 0 disables
    deadline_ms: Optional[float] = None
    _deadline_at: float = 0.0
    # timing (monotonic seconds; filled in by the engine)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # engine-owned adapter bookkeeping: the device slot this request's rows
    # use (-1 = base) and whether it still holds a ref on the store
    _adapter_slot: int = -1
    _adapter_held: bool = False
    # streaming hooks, run inside the step loop: on_token(token_id, index)
    # the moment a token is sampled; on_finish(request) exactly once, after
    # the terminal flag is set and the request's blocks are back in the pool
    on_token: Optional[Callable[[int, int], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None

    @property
    def finish_reason(self) -> str:
        """OpenAI-style terminal state ("" while still running)."""
        if self.cancelled:
            return "cancelled"
        if self.expired:
            return "expired"
        if self.shed:
            return "shed"
        if self.errored:
            return "error"
        if self.rejected:
            return "rejected"
        if self.done:
            return "length"
        return ""


@dataclasses.dataclass
class _Active:
    """A request occupying a batch slot."""
    req: Request
    table: BlockTable
    reserved_left: int          # blocks still earmarked in the pool for us
    admit_seq: int              # admission order (preemption picks the max)
    next_prefill: int = 0       # prompt tokens already prefilled
    pos: int = 0                # KV entries written (valid only post-prefill)
    # stateful families (ssm/hybrid): the request's recurrent-state slab
    # slot (a one-block handle in the engine's StateSlab)
    state: Optional[Block] = None

    @property
    def prefill_done(self) -> bool:
        return self.next_prefill >= len(self.req.prompt)


@dataclasses.dataclass
class _Parked:
    """A preempted request's KV, waiting on the host tier for re-admission.
    ``blocks`` mixes tiers: exclusive blocks were swapped to host; blocks
    shared with the prefix registry stay device-resident."""
    blocks: List[Block]
    next_prefill: int
    pos: int
    # stateful families: the recurrent state, swapped whole to the slab's
    # host tier (a state is never shared, so it always moves on park)
    state: Optional[Block] = None


# ---------------------------------------------------------------------------
# Pipeline terms: the attention shapes serving actually executes
# ---------------------------------------------------------------------------

def _attn_term(q_rows: int, kv_span: int, head_dim: int):
    """O = MatMul(Exp(MatMul(Q, K)), V) with ``q_rows`` queries against a
    ``kv_span``-position KV — the one attention inner block every serving
    shape instantiates."""
    q = inp("Q", (q_rows, head_dim))
    k = inp("K", (head_dim, kv_span))
    v = inp("V", (kv_span, head_dim))
    return matmul(unary(matmul(q, k), kind="exp"), v)


def attention_block_term(seq_len: int, head_dim: int):
    """Square attention inner block (kept for inspection tooling)."""
    return _attn_term(seq_len, seq_len, head_dim)


def paged_decode_attention_term(span: int, head_dim: int):
    """One decode token's attention against a request's pooled KV span
    (``span`` = max_blocks_per_seq * block_size gathered positions)."""
    return _attn_term(1, span, head_dim)


def chunked_prefill_attention_term(chunk: int, span: int, head_dim: int):
    """A prefill chunk's attention: ``chunk`` queries against the span."""
    return _attn_term(chunk, span, head_dim)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_len: int = 256, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 admission: str = "conservative",
                 host_blocks: Optional[int] = None,
                 prefix_cache_blocks: Optional[int] = None,
                 compiler: Optional[Compiler] = None,
                 plan_kernels: bool = True,
                 hardware: Hardware = H100,
                 mesh=None,
                 tp: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 fault_injector=None):
        # compiler: the Compiler that plans the attention shapes (None = the
        # process-wide default, whose cache a second engine hits).
        # hardware: the record the plan is made for.  mesh: this rank's
        # ``launch.mesh.ServeMesh`` to shard the KV pool over (kv-heads),
        # None to consult REPRO_SERVE_MESH, False to force one device.  tp:
        # also store the weights tensor-parallel (None consults
        # REPRO_SERVE_TP; it needs a mesh).  max_queue: bound on
        # the admission queue (None consults REPRO_SERVE_MAX_QUEUE, 0 =
        # unbounded).  fault_injector: None consults REPRO_FAULT, False
        # forces off.  The device is the one ``params`` live on; every rank
        # of a mesh passes the full weights.
        # vlm and audio are refused, as the reference's engine refuses
        # them: the paged path embeds token ids at (B,S) positions, which
        # would silently drop a stub frontend's embeds and M-RoPE streams
        # (and the encoder-decoder has no paged path); both serve through
        # launch.steps' prefill and decode steps over a dense cache
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(
                f"the paged engine serves token-frontend decoder LMs "
                f"(dense, moe, ssm, hybrid), not family {cfg.family!r}; "
                f"serve it with launch.steps.make_prefill_step and "
                f"make_decode_step")
        assert admission in ("conservative", "optimistic")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks_per_seq = blocks_for_tokens(max_len, block_size)
        if num_blocks is None:
            num_blocks = max_batch * self.max_blocks_per_seq + 1
        self.pool = BlockPool(num_blocks, block_size)
        self.admission = admission
        self.prefill_chunk_tokens = prefill_chunk_tokens or block_size
        self.fns = build_model(cfg, self.device)
        # stateful families (ssm, hybrid) carry O(1) recurrent state per
        # request in a StateSlab beside the block pool; attention-free
        # families never touch the block table at all
        self.has_attention = cfg.family in ("dense", "moe", "hybrid")
        self.has_state = self.fns.state_slot_copy is not None
        if self.has_state:
            # engine chunk boundaries land on multiples of the scan granule,
            # as in the JAX engine (whose associative-scan tree must match
            # the dense oracle's); the port's sequential scan gives the same
            # state wherever a chunk ends, so this keeps the two engines'
            # dispatches one for one
            g = cfg.ssm.chunk
            self.prefill_chunk_tokens = max(
                g * ((self.prefill_chunk_tokens + g - 1) // g), g)
        self._init_mesh(cfg, mesh, tp, hardware)

        # unified pipeline: compile the paged attention shapes once (cached,
        # so a second engine on the same shapes skips the search passes)
        self.compile_reports: Dict[str, object] = {}
        self.compile_report = None
        self.kernel_plan = None
        if plan_kernels and self.has_attention:
            compiler = compiler or default_compiler()
            hd = cfg.resolved_head_dim
            span = self.max_blocks_per_seq * block_size
            target = CompileTarget(hardware=hardware)
            opts = CompileOptions(extraction="greedy", schedule_iterations=10)
            dec = compiler.compile(paged_decode_attention_term(span, hd),
                                   target=target, options=opts)
            pre = compiler.compile(
                chunked_prefill_attention_term(self.prefill_chunk_tokens,
                                               span, hd),
                target=target, options=opts)
            self.compile_reports = {"decode": dec.report, "prefill": pre.report}
            self.compile_report = dec.report
            self.kernel_plan = dec.report.kernel_plan
        # multi-LoRA adapter store: per-tenant low-rank deltas in a
        # refcounted two-tier slab (device + host write-through).  Zero
        # device bytes until the first load.  In-flight requests hold a
        # ref, so a live tenant is never evicted under its own decode.
        self.adapters = AdapterStore(cfg, device=self.device)

        # the compiler's kv tile for the *decode* shape sets how many pages
        # the paged-attention kernel fetches at a time, on both the decode
        # and the prefill-chunk path; the same plan sets the LoRA expand
        # kernel's output tile
        self.pages_per_fetch = 1
        self.lora_block_out = 256
        if self.kernel_plan is not None:
            self.pages_per_fetch = paged_pages_per_fetch(
                self.kernel_plan, block_size, self.max_blocks_per_seq)
            self.lora_block_out, _ = lora_tiles(
                self.kernel_plan, cfg.d_model, self.adapters.rank_cap)

        # tiered KV store: device slab + pinned host swap tier + prefix registry
        self.swap_enabled = perf().kv_swap and (host_blocks is None
                                                or host_blocks > 0)
        n_host = (host_blocks if host_blocks is not None else num_blocks) \
            if self.swap_enabled else 0
        prefix_budget = prefix_cache_blocks if prefix_cache_blocks \
            is not None else self.pool.usable_blocks // 4
        if self.has_state:
            # adopted KV blocks cannot reproduce a request's scan state, so
            # prefix sharing is off for stateful families: budget 0 makes
            # match_prefix miss and register_prefix a no-op
            prefix_budget = 0
        self.param_bytes_replicated = param_sharding.param_bytes_total(
            self.params)
        self.param_bytes_per_device = param_sharding.param_bytes_per_device(
            self.params)
        # slot 0 of the state slab is the null slot (padded decode rows)
        self.state_slots = max_batch + 1 if self.has_state else 0
        if self.has_state:
            cache0 = self.fns.make_paged_cache(num_blocks, block_size,
                                               state_slots=self.state_slots)
        elif self.mesh is not None:
            # this rank's KV/n heads of every block
            cache0 = self.fns.make_paged_cache(num_blocks, block_size,
                                               n_model=self.mesh.n_model)
        else:
            cache0 = self.fns.make_paged_cache(num_blocks, block_size)
        device = DeviceTier(cache0, self.pool,
                            copy_block=self.fns.paged_block_copy,
                            read_block=self.fns.paged_block_read,
                            write_block=self.fns.paged_block_write)
        self.store = KVStore(device, HostTier(n_host),
                             prefix_cache_blocks=prefix_budget)

        # state slab: per-request recurrent state as the one-block case of
        # the block pool (same refcounted handles, host swap tier and
        # invariants); the slab view shares the DeviceTier's cache, and its
        # data plane touches only the state leaves
        self.state_store: Optional[StateSlab] = None
        if self.has_state:
            slab_view = SlabDeviceView(device, BlockPool(self.state_slots, 1),
                                       self.fns.state_slot_copy,
                                       self.fns.state_slot_read,
                                       self.fns.state_slot_write)
            # parked states can outnumber the live slots; a full host tier
            # downgrades the park to drop-and-restart (perf, not correctness)
            n_state_host = 4 * max_batch if self.swap_enabled else 0
            self.state_store = StateSlab(slab_view, HostTier(n_state_host))

        if fault_injector is False:
            self.faults = None
        else:
            self.faults = fault_injector if fault_injector is not None \
                else FaultInjector.from_env()
        self.pool.fault_injector = self.faults
        self.store.fault_injector = self.faults
        if self.state_store is not None:
            self.state_store.fault_injector = self.faults
            self.state_store.device.pool.fault_injector = self.faults
        self.max_queue = perf().serve_max_queue if max_queue is None \
            else max_queue
        self.default_deadline_ms = perf().serve_deadline_ms
        self.shed_pressure = perf().serve_shed_pressure
        self.max_consecutive_crashes = max(perf().serve_max_crashes, 1)
        self.degraded = False
        self.invariant_violations: List[str] = []
        self._blame_rid: Optional[int] = None    # request under the knife now
        self._crash_rid: Optional[int] = None    # captured at raise time
        self._consecutive_crashes = 0
        self._step_crashes = 0
        self._swap_failures = 0
        self._gateway_shed = 0   # 429s the gateway refused before submit

        self.slots: List[Optional[_Active]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.cancelled: List[Request] = []
        self.expired: List[Request] = []
        self.errored: List[Request] = []
        self.shed: List[Request] = []
        self._parked: Dict[int, _Parked] = {}
        self.steps = 0
        self._admit_seq = 0
        self._t0: Optional[float] = None
        self._t_last = 0.0
        self._submitted = 0
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self._preemptions = 0
        self._re_prefill_avoided = 0
        # per-tenant delivery tallies (key: adapter_id, "base" for None)
        self._tenant_tokens: Dict[str, int] = {}
        self._tenant_finished: Dict[str, int] = {}
        # mesh: rank 0's submissions and cancellations since the last step;
        # the current step's clock (rank 0's); this step's plan record
        self._outbox: List[tuple] = []
        self._step_clock = 0.0
        self._plan: List[int] = []
        self._closed = False
        self._released = 0

    def _init_mesh(self, cfg: ModelConfig, mesh, tp, hardware) -> None:
        """Resolve ``mesh``/``tp`` and, on a mesh, check the split and keep
        this rank's slice of the weights (``self.params``, ``self.shard``)."""
        self.mesh = None if mesh is False else (
            mesh if mesh is not None else _mesh_from_knob())
        self.tp = bool(tp) if tp is not None else perf().serve_tp
        if self.mesh is None and self.tp and mesh is not False:
            raise ValueError(
                "tensor-parallel serving (tp=True or REPRO_SERVE_TP=1) needs "
                "a serve mesh (mesh= or REPRO_SERVE_MESH), and none is set")
        self.tp = self.tp and self.mesh is not None
        self.tp_rules = None
        self.tp_report = None
        self.mesh_id: Optional[int] = None
        self.shard: Optional[ServeShard] = None
        self._model_kw: Dict[str, object] = {}
        if self.mesh is None:
            return
        if self.has_state:
            raise NotImplementedError(
                "sharded serving of the ssm/hybrid families is not supported: "
                "the state slab has no mesh partition; serve them on one "
                "device")
        self.mesh_id = next(_MESH_IDS)
        n = self.mesh.n_model
        # the pool is sharded per KV head (GQA groups stay on one rank);
        # TP weights also split d_ff
        param_sharding.validate_tp_divisibility(cfg, n, heads_only=not self.tp)
        if self.tp:
            # rules chosen by Auto Distribution's SBP cost model, matched
            # against the param paths; each rank keeps its slices
            self.tp_rules = param_sharding.choose_tp_rules(cfg, n, hardware)
            specs, self.tp_report = param_sharding.tp_param_specs(
                cfg, self.params, n, rules=self.tp_rules)
            self.params = param_sharding.shard_params(self.params, specs,
                                                      self.mesh)
        self.shard = ServeShard(self.mesh, reduce_scatter=self.tp
                                and perf().tp_reduce_scatter)
        self._model_kw = {"shard": self.shard}

    @property
    def is_leader(self) -> bool:
        """Rank 0 of a mesh, or a single-device engine: the rank that takes
        submissions."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def cache(self):
        return self.store.device.cache

    @cache.setter
    def cache(self, value):
        self.store.device.cache = value

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- multi-LoRA adapters -----------------------------------------------
    def load_adapter(self, name: str, weights=None,
                     rank: Optional[int] = None,
                     alpha: Optional[float] = None) -> int:
        """Make tenant ``name``'s adapter device-resident (synthesizing
        deterministic factors from the name when ``weights`` is None) and
        return its slot.  A mesh engine refuses adapters (its ranks hold
        1/n of the heads; the LoRA delta has no sharded path)."""
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-LoRA serving is not supported on a sharded serve "
                "mesh; run adapters on a single-device engine")
        return self.adapters.load(name, weights=weights, rank=rank,
                                  alpha=alpha)

    def _release_adapter(self, req: Request) -> None:
        """Drop ``req``'s adapter ref exactly once, whichever terminal path
        runs first (retire / reject / expire / quarantine)."""
        if req._adapter_held:
            req._adapter_held = False
            self.adapters.release(req.adapter_id)

    def _tenant_count(self, req: Request, n: int = 1) -> None:
        t = req.adapter_id or "base"
        self._tenant_tokens[t] = self._tenant_tokens.get(t, 0) + n

    def _lora_descriptor(self, ids: np.ndarray) -> Optional[dict]:
        """``batch["lora"]`` for one dispatch (``ids``: adapter slot per
        row, -1 = base), or None when no row uses an adapter.  The None
        keeps every LoRA op out of the dispatch: that absence is the
        ``adapter_id=None`` bitwise-identity contract."""
        if not (ids >= 0).any():
            return None
        slabs = self.adapters.slabs()
        assert slabs is not None, "row holds an adapter slot but no slab"
        return {"ids": self._to_device(ids), "slabs": slabs}

    # -- request lifecycle -----------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue ``req`` (FIFO); admission control runs inside ``step``.
        A bounded queue sheds instead of enqueueing; the deadline cutoff is
        stamped here and enforced by the step loop's reaper.  On a mesh only
        rank 0 submits, and the request reaches every rank's queue at the
        next ``step()``."""
        req.t_submit = time.monotonic()
        if self.mesh is not None:
            if not self.is_leader:
                raise RuntimeError("submit on rank 0: the other ranks of a "
                                   "serve mesh replay rank 0's submissions")
            if req.adapter_id is not None:
                raise NotImplementedError(
                    "multi-LoRA serving is not supported on a sharded serve "
                    "mesh yet")
            self._outbox.append(("submit", req))
            return
        self._enqueue(req)

    def _enqueue(self, req: Request) -> None:
        self._submitted += 1
        if self.max_queue and len(self.queue) >= self.max_queue:
            req.shed = True
            req.done = True
            req.t_done = req.t_submit
            self.shed.append(req)
            if req.on_finish is not None:
                req.on_finish(req)
            return
        if req.adapter_id is not None:
            if self.has_state:
                # the stateful families' layers read no LoRA factors: refuse
                # rather than serve the base model's tokens under a tenant
                self._reject(req, f"LoRA adapters are served for the dense "
                             f"family only (and moe's attention), not "
                             f"{self.cfg.family!r} (see ROADMAP)")
                return
            if not self.adapters.known(req.adapter_id):
                self._reject(req, f"unknown adapter {req.adapter_id!r}")
                return
            try:
                if not self.adapters.is_loaded(req.adapter_id):
                    # evicted to the host tier; a slab write brings it back
                    self.adapters.load(req.adapter_id)
                req._adapter_slot = self.adapters.acquire(req.adapter_id)
            except AdapterStoreFull as e:
                self._reject(req, f"adapter store full: {e}")
                return
            req._adapter_held = True
        dl = req.deadline_ms if req.deadline_ms is not None \
            else self.default_deadline_ms
        if dl and dl > 0:
            req._deadline_at = req.t_submit + dl / 1e3
        self.queue.append(req)

    def _reject(self, req: Request, reason: str) -> None:
        self._release_adapter(req)
        req.rejected = True
        req.done = True
        req.reject_reason = reason
        self.rejected.append(req)
        if req.on_finish is not None:
            req.on_finish(req)

    def _admission_need(self, req: Request, parked: Optional[_Parked]) -> int:
        """Blocks to reserve at admission: the exact lifetime bound plus a
        copy-on-write spare (conservative), or just the prompt (optimistic).
        A restored request reserves its remaining growth plus one slot per
        host block to swap back in.  Attention-free families reserve
        nothing: their footprint is one state slot, bounded by the batch
        slots."""
        if not self.has_attention:
            return 0
        plen, bs = len(req.prompt), self.block_size
        worst = worst_case_blocks(plen, req.max_new, bs)
        if parked is not None:
            swap_ins = sum(1 for b in parked.blocks if b.tier == HOST)
            if self.admission == "optimistic":
                return swap_ins
            cow_spare = 1 if (self.store.prefix_cache_blocks > 0 and plen % bs
                              and req.max_new >= 2 and parked.pos == 0) else 0
            return worst - len(parked.blocks) + swap_ins + cow_spare
        if self.admission == "optimistic":
            return blocks_for_tokens(plen, bs)
        cow_spare = 1 if (self.store.prefix_cache_blocks > 0 and plen % bs
                          and req.max_new >= 2) else 0
        return min(worst + cow_spare, self.pool.usable_blocks)

    def _admit(self) -> int:
        """Move queued requests into free slots, FIFO, under admission
        control; the head of the queue is never overtaken."""
        admitted = 0
        while self.queue:
            req = self.queue[0]
            worst = worst_case_blocks(len(req.prompt), req.max_new,
                                      self.block_size)
            if not req.prompt:
                self.queue.pop(0)
                self._reject(req, "empty prompt")
                continue
            if req.max_new < 1:
                self.queue.pop(0)
                self._reject(req, f"max_new must be >= 1, got {req.max_new}")
                continue
            if len(req.prompt) + req.max_new > self.max_len:
                self.queue.pop(0)
                self._reject(req, f"prompt+max_new {len(req.prompt) + req.max_new}"
                                  f" exceeds max_len {self.max_len}")
                continue
            if self.has_attention and worst > self.pool.usable_blocks:
                self.queue.pop(0)
                self._reject(req, f"worst-case footprint {worst} blocks exceeds "
                                  f"pool capacity {self.pool.usable_blocks}")
                continue
            slot = next((i for i, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                break
            parked = self._parked.get(req.rid)
            need = self._admission_need(req, parked)
            if not self.pool.reserve(need):
                # pressure-relief ladder: drop prefix cache, then move other
                # parked requests' stranded device blocks to the host tier
                self.store.evict_prefixes(need - self.pool.available())
                if not self.pool.reserve(need):
                    self._swap_parked_out(need - self.pool.available(),
                                          exclude_rid=req.rid)
                    if not self.pool.reserve(need):
                        break
            a = _Active(req=req, table=BlockTable(self.block_size),
                        reserved_left=need, admit_seq=self._admit_seq)
            if parked is not None:
                try:
                    with self._blame(req.rid):
                        self._restore(a, parked)
                except BaseException:
                    # ``a`` was never slotted: release what it holds here
                    a.table.release_to(self.store)
                    self.pool.release(a.reserved_left)
                    a.reserved_left = 0
                    if a.state is not None:
                        self.state_store.decref(a.state)
                        a.state = None
                    raise
            elif self.state_store is not None:
                # a fresh stateful request claims its slab slot now; a free
                # batch slot implies a free slab slot, so a raise here is an
                # injected slab_alloc fault, and quarantine finds the
                # request still at the queue head holding nothing
                try:
                    with self._blame(req.rid):
                        a.state = self.state_store.alloc()
                except BaseException:
                    self.pool.release(a.reserved_left)
                    a.reserved_left = 0
                    raise
            self.slots[slot] = a
            self._admit_seq += 1
            self.queue.pop(0)
            admitted += 1
            self._plan += [-1, req.rid, slot, need]
        return admitted

    def _restore(self, a: _Active, parked: _Parked) -> None:
        """Re-admission of a preempted request: swap its parked blocks back
        onto the device and resume exactly where it stopped.  Blocks leave
        ``parked.blocks`` only once restored, so a failure midway leaves
        nothing double-owned.  A parked recurrent state comes back first, into
        a fresh slab slot."""
        if parked.state is not None:
            dst = self.state_store.alloc()
            try:
                a.state = self.state_store.swap_in(parked.state, dst)
            except BaseException:
                self.state_store.decref(dst)
                raise
            parked.state = None
        while parked.blocks:
            b = parked.blocks[0]
            if b.tier == DEVICE:
                a.table.blocks.append(b)       # stayed resident (shared)
            else:
                dst = self.store.alloc(reserved=True)
                a.reserved_left -= 1
                try:
                    restored = self.store.swap_in(b, dst)
                except BaseException:
                    self.store.decref(dst)     # undo: dst never held data
                    self.pool.reserve(1)       # re-earmark the freed block
                    a.reserved_left += 1
                    raise
                a.table.blocks.append(restored)
            parked.blocks.pop(0)
        a.next_prefill = parked.next_prefill
        a.pos = parked.pos
        self._re_prefill_avoided += parked.next_prefill
        del self._parked[a.req.rid]

    # -- block accounting --------------------------------------------------
    def _alloc_device(self, a: _Active) -> Optional[Block]:
        """One device block for ``a``: reservation first, then the open pool;
        under pressure evict prefix-cache entries, swap parked stragglers
        out, and finally preempt the youngest active request.  None means
        ``a`` itself was the youngest and got preempted."""
        while True:
            if a.reserved_left > 0:
                blk = self.store.alloc(reserved=True)
                a.reserved_left -= 1
                return blk
            try:
                return self.store.alloc()
            except PoolExhausted:
                if self.store.evict_prefixes(1) > 0:
                    continue
                if self._swap_parked_out(1) > 0:
                    continue
                victim = max((s for s in self.slots if s is not None),
                             key=lambda s: s.admit_seq)
                self._requeue(victim)
                if victim is a:
                    return None

    def _swap_parked_out(self, min_blocks: int,
                         exclude_rid: Optional[int] = None) -> int:
        """Push parked requests' stranded device blocks (shared at
        preemption, exclusive since) to the host tier."""
        freed = 0
        for rid, parked in self._parked.items():
            if rid == exclude_rid:
                continue
            for j, b in enumerate(parked.blocks):
                if (b.tier == DEVICE and not b.shared
                        and self.store.host.num_free > 0):
                    try:
                        parked.blocks[j] = self.store.swap_out(b)
                    except InjectedFault:
                        self._swap_failures += 1
                        continue
                    freed += 1
                    if freed >= min_blocks:
                        return freed
        return freed

    def _grow(self, a: _Active, n_tokens: int) -> bool:
        """Grow ``a``'s table to hold ``n_tokens`` positions; False if
        preemption evicted ``a`` itself."""
        if not self.has_attention:
            return True  # attention-free: no KV table to grow
        while a.table.capacity < n_tokens:
            blk = self._alloc_device(a)
            if blk is None:
                return False
            a.table.blocks.append(blk)
        return True

    def _make_writable(self, a: _Active, start: int, end: int) -> bool:
        """Copy-on-write every shared block overlapping write positions
        [start, end).  False if allocating a copy preempted ``a`` itself."""
        if not self.has_attention:
            return True
        bs = self.block_size
        for i in range(start // bs, min((end - 1) // bs + 1,
                                        len(a.table.blocks))):
            while a.table.blocks[i].shared:
                dst = self._alloc_device(a)
                if dst is None:
                    return False
                if not a.table.blocks[i].shared:
                    self.store.decref(dst)
                    break
                a.table.blocks[i] = self.store.cow_into(a.table.blocks[i], dst)
        return True

    def _requeue(self, victim: _Active) -> None:
        """Preempt ``victim`` back to the queue head, parking its KV (and its
        recurrent state) on the host tiers when swap is enabled and the
        tiers have room; otherwise drop it and restart from the prompt."""
        self.pool.release(victim.reserved_left)
        victim.reserved_left = 0
        req = victim.req
        # attention families park only victims that hold KV (an empty table
        # would re-admit with no reservation and ping-pong back into
        # preemption); stateful families park whenever their state can move,
        # since the state slot is the resumable footprint
        parked: Optional[List[Block]] = None
        state_parked: Optional[Block] = None
        holds = bool(victim.table.blocks) or victim.state is not None
        can = self.swap_enabled and holds \
            and self.store.can_swap_out(victim.table.blocks)
        if can and self.state_store is not None:
            can = victim.state is not None \
                and self.state_store.can_swap_out([victim.state])
        if can:
            park_ok = True
            if self.state_store is not None:
                try:
                    state_parked = self.state_store.swap_out(victim.state)
                    victim.state = None
                except Exception as e:  # noqa: BLE001 — downgrade
                    self._swap_failures += 1
                    print(f"serve-engine: state swap_out failed parking "
                          f"request {req.rid} ({type(e).__name__}: {e}); "
                          "dropping its state (restart from prompt)",
                          file=sys.stderr)
                    park_ok = False
            if park_ok:
                parked = []
                try:
                    for b in victim.table.blocks:
                        parked.append(self.store.swap_out(b))
                except Exception as e:  # noqa: BLE001 — downgrade
                    self._swap_failures += 1
                    print(f"serve-engine: swap_out failed parking request "
                          f"{req.rid} ({type(e).__name__}: {e}); dropping "
                          "its KV (restart from prompt)", file=sys.stderr)
                    for b in parked:
                        self.store.decref(b)
                    for b in victim.table.blocks[len(parked):]:
                        self.store.decref(b)
                    victim.table.blocks = []
                    parked = None
                    if state_parked is not None:
                        # already on the slab's host tier; the restart
                        # rebuilds the state from the prompt
                        self.state_store.decref(state_parked)
                        state_parked = None
        if parked is not None:
            victim.table.blocks = []
            self._parked[req.rid] = _Parked(
                blocks=parked, next_prefill=victim.next_prefill,
                pos=victim.pos, state=state_parked)
        else:
            victim.table.release_to(self.store)
            if victim.state is not None:
                self.state_store.decref(victim.state)
                victim.state = None
            # counters report *delivered* work: back out discarded tokens
            self._prefill_tokens -= victim.next_prefill
            self._decode_tokens -= max(len(req.out) - 1, 0)
            self._tenant_count(req, -len(req.out))  # the replay re-emits them
            req.out.clear()
        self.queue.insert(0, req)
        self.slots[self.slots.index(victim)] = None
        self._preemptions += 1

    def _retire(self, a: _Active, now: Optional[float] = None) -> None:
        self._release_adapter(a.req)
        t = a.req.adapter_id or "base"
        self._tenant_finished[t] = self._tenant_finished.get(t, 0) + 1
        a.req.done = True
        a.req.t_done = time.monotonic() if now is None else now
        a.table.release_to(self.store)
        self.pool.release(a.reserved_left)
        a.reserved_left = 0
        if a.state is not None:
            self.state_store.decref(a.state)
            a.state = None
        self.finished.append(a.req)
        self.slots[self.slots.index(a)] = None
        if a.req.on_finish is not None:
            a.req.on_finish(a.req)

    # -- fault tolerance ---------------------------------------------------
    @contextlib.contextmanager
    def _blame(self, rid: int):
        """Attribute any exception raised in the body to request ``rid``
        (innermost attribution at raise time wins)."""
        prev = self._blame_rid
        self._blame_rid = rid
        try:
            yield
        except BaseException:
            if self._crash_rid is None:
                self._crash_rid = rid
            raise
        finally:
            self._blame_rid = prev

    def _release_active(self, a: _Active) -> None:
        a.table.release_to(self.store)
        self.pool.release(a.reserved_left)
        a.reserved_left = 0
        if a.state is not None:
            self.state_store.decref(a.state)
            a.state = None
        self.slots[self.slots.index(a)] = None

    def _drop_parked(self, rid: int) -> None:
        """Free the KV blocks (and state) a preempted request parked, if
        any."""
        parked = self._parked.pop(rid, None)
        if parked is not None:
            for b in parked.blocks:
                self.store.decref(b)
            if parked.state is not None:
                self.state_store.decref(parked.state)

    def _finish_cancel(self, req: Request) -> None:
        self._release_adapter(req)
        req.cancelled = True
        req.done = True
        req.t_done = time.monotonic()
        self.cancelled.append(req)
        if req.on_finish is not None:
            req.on_finish(req)

    def cancel(self, rid: int) -> bool:
        """Abort request ``rid`` wherever it lives — queued, in a batch
        slot, or parked on the host tier after a swap (a parked request
        also sits in the queue) — and return every block it held (and its
        state-slab slot) the same call.  Tokens already sampled stay in
        ``req.out``.  False if the id is unknown or already done.  On a
        mesh (rank 0 only) a submitted request is cancelled at once and a
        live one at the start of the next ``step()`` on every rank, before
        anything else runs."""
        if self.mesh is not None:
            if not self.is_leader:
                raise RuntimeError("cancel on rank 0 of a serve mesh")
            for i, (op, req) in enumerate(self._outbox):
                if op == "submit" and req.rid == rid:
                    self._outbox.pop(i)
                    self._finish_cancel(req)
                    return True
            if any(r.rid == rid for r in self.queue) or any(
                    a is not None and a.req.rid == rid for a in self.slots):
                self._outbox.append(("cancel", rid))
                return True
            return False
        return self._cancel_now(rid)

    def _cancel_now(self, rid: int) -> bool:
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                self._drop_parked(rid)
                self._finish_cancel(req)
                return True
        for a in self.slots:
            if a is not None and a.req.rid == rid:
                self._release_active(a)
                self._finish_cancel(a.req)
                return True
        return False

    def _finish_expired(self, req: Request) -> None:
        self._release_adapter(req)
        req.expired = True
        req.done = True
        req.t_done = time.monotonic()
        self.expired.append(req)
        if req.on_finish is not None:
            req.on_finish(req)

    def _fail_request(self, req: Request, msg: str) -> None:
        """Terminal error state (quarantine outcome); a raising on_finish
        hook must not re-crash the recovery path."""
        self._release_adapter(req)
        req.errored = True
        req.error = msg
        req.done = True
        req.t_done = time.monotonic()
        self.errored.append(req)
        if req.on_finish is not None:
            try:
                req.on_finish(req)
            except Exception as e:  # noqa: BLE001
                print(f"serve-engine: on_finish hook raised for errored "
                      f"request {req.rid}: {type(e).__name__}: {e}",
                      file=sys.stderr)

    def _reap_deadlines(self) -> int:
        """Expire queued, parked and active requests past their deadline
        (on a mesh, by rank 0's clock of this step on every rank)."""
        now = self._step_clock if self.mesh is not None else time.monotonic()
        n = 0
        for req in [r for r in self.queue
                    if r._deadline_at and now > r._deadline_at]:
            self.queue.remove(req)
            self._drop_parked(req.rid)
            self._finish_expired(req)
            n += 1
            self._plan += [-3, req.rid]
        for a in [s for s in self.slots
                  if s is not None and s.req._deadline_at
                  and now > s.req._deadline_at]:
            self._release_active(a)
            self._finish_expired(a.req)
            n += 1
            self._plan += [-3, a.req.rid]
        return n

    def _quarantine(self, rid: int, msg: str) -> bool:
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                self._drop_parked(rid)
                self._fail_request(req, msg)
                return True
        for a in self.slots:
            if a is not None and a.req.rid == rid:
                self._release_active(a)
                self._fail_request(a.req, msg)
                return True
        if rid in self._parked:
            self._drop_parked(rid)
            return True
        return False

    def _crash_blame(self) -> Optional[int]:
        """The request a step crash blames: the innermost ``_blame`` scope
        at raise time, else the youngest live request, else None."""
        if self._crash_rid is not None:
            return self._crash_rid
        live = [s for s in self.slots if s is not None]
        if live:
            return max(live, key=lambda s: s.admit_seq).req.rid
        return None

    def _on_step_crash(self, exc: BaseException,
                       rid: Optional[int]) -> None:
        """Quarantine request ``rid`` (the blamed one), count consecutive
        crashes toward ``degraded``, check the KV invariants."""
        self._step_crashes += 1
        self._consecutive_crashes += 1
        if self._consecutive_crashes >= self.max_consecutive_crashes:
            self.degraded = True
        msg = f"engine step crashed: {type(exc).__name__}: {exc}"
        print(f"serve-engine: {msg} (crash {self._step_crashes}, "
              f"{self._consecutive_crashes} consecutive"
              + (f"; quarantining request {rid}" if rid is not None else
                 "; no request to blame")
              + (", engine DEGRADED" if self.degraded else "") + ")",
              file=sys.stderr)
        if rid is not None:
            self._quarantine(rid, msg)
        violations = self.check_invariants()
        if violations:
            self.invariant_violations.extend(violations)
            for v in violations:
                print(f"serve-engine: KV-LEAK INVARIANT VIOLATED: {v}",
                      file=sys.stderr)

    def step_guarded(self) -> bool:
        """``step()`` with crash isolation: an exception quarantines the
        request that poisoned the batch and the loop keeps going.  On a
        mesh (rank 0; the others follow) every rank catches its own step's
        exception and the ranks agree in the step's closing gather: if every
        rank crashed blaming the same request after the same model
        collectives, every rank quarantines it and counts the crash alike;
        any other crash raises ``MeshDivergence`` on every rank.  (The
        injector's ``step`` site fires before the model call's first
        collective, so a fault seeded alike on every rank is isolated; a
        rank that crashes inside a collective leaves the others to the
        collective timeout.)"""
        if self.mesh is not None:
            self._require_leader("step_guarded")
            with MESH_LOCK:
                self._lead({"now": time.monotonic(), "step": True,
                            "guarded": True})
                return self._step(guarded=True)
        self._crash_rid = None
        try:
            worked = self.step()
        except Exception as e:  # noqa: BLE001 — isolate, quarantine, go on
            self._on_step_crash(e, self._crash_blame())
            return True
        self._guarded_ok(worked)
        return worked

    def _guarded_ok(self, worked: bool) -> None:
        """A guarded step that did not crash: a working one ends the run of
        consecutive crashes."""
        if worked:
            self._consecutive_crashes = 0
            self.degraded = False

    def overload_reason(self) -> str:
        """Why a new submit should be shed right now ("" = accept)."""
        if self.max_queue and len(self.queue) >= self.max_queue:
            return (f"admission queue full "
                    f"({len(self.queue)} >= {self.max_queue})")
        if self.shed_pressure > 0 and self.queue:
            frac = (self.pool.usable_blocks - self.pool.available()) \
                / self.pool.usable_blocks
            if frac >= self.shed_pressure:
                return (f"block pool pressure {frac:.2f} >= "
                        f"{self.shed_pressure:g} with "
                        f"{len(self.queue)} queued")
        return ""

    def note_gateway_shed(self) -> None:
        """Count a request the gateway refused before submit (429)."""
        self._gateway_shed += 1

    def check_invariants(self) -> List[str]:
        """KV-leak invariants (see ``repro_torch.serve.faults``); empty list
        = healthy."""
        return check_kv_invariants(self)

    # -- sampling ----------------------------------------------------------
    @staticmethod
    def _sample(logits_row: np.ndarray, sp: SamplingParams, n_emitted: int) -> int:
        """Gumbel-max sampling keyed on (seed, token index): stateless, so a
        preempted request replays the same draws on restart, and host-side,
        so the decode hot loop pays no per-token device dispatches."""
        if sp.temperature <= 0.0:
            return int(np.argmax(logits_row))
        x = logits_row.astype(np.float64) / sp.temperature
        if 0 < sp.top_k < x.size:
            kth = np.partition(x, -sp.top_k)[-sp.top_k]
            x = np.where(x < kth, -np.inf, x)
        rng = np.random.default_rng(
            np.random.SeedSequence([sp.seed & (2**63 - 1), n_emitted]))
        return int(np.argmax(x + rng.gumbel(size=x.size)))

    # -- prefill -----------------------------------------------------------
    def _adopt_prefix(self, a: _Active) -> None:
        """First chunk of a fresh request: fork the longest registered prompt
        prefix instead of recomputing it (capped at ``plen - 1``: the last
        prompt position must run to produce the first token's logits)."""
        req = a.req
        plen, bs = len(req.prompt), self.block_size
        # prefixes are namespaced by tenant: one prompt under two adapters
        # has two different KVs, and a cross-tenant hit would serve one
        # tenant's activations to another
        n, blocks = self.store.match_prefix(req.prompt,
                                            namespace=req.adapter_id)
        n = min(n, plen - 1)
        if n <= 0:
            return
        a.table.blocks = self.store.fork(blocks[:blocks_for_tokens(n, bs)])
        release = min(n // bs, a.reserved_left)
        if release:
            self.pool.release(release)
            a.reserved_left -= release
        a.next_prefill = n
        self._re_prefill_avoided += n

    def _prefill_step(self) -> bool:
        """Run ONE prompt chunk for the oldest admitting request."""
        pending = [s for s in self.slots if s is not None and not s.prefill_done]
        if not pending:
            return False
        a = min(pending, key=lambda s: s.admit_seq)
        with self._blame(a.req.rid):
            return self._prefill_chunk_for(a)

    def _prefill_chunk_for(self, a: _Active) -> bool:
        req, c = a.req, self.prefill_chunk_tokens
        plen = len(req.prompt)
        if a.next_prefill == 0 and not a.table.blocks:
            self._adopt_prefix(a)
        start = a.next_prefill
        # realign to the canonical chunk grid after an adopted or restored
        # prefix, so the attended span takes the same few values for every
        # request
        end = min(plen, start + c, (start // c + 1) * c)
        if not self._grow(a, end):
            return True  # preempted ourselves; the step still did work
        if not self._make_writable(a, start, end):
            return True
        chunk = req.prompt[start:end] + [0] * (c - (end - start))
        batch = {
            "tokens": self._to_device(np.asarray([chunk], np.int32)),
            "block_table": self._to_device(np.asarray(
                [a.table.padded(self.max_blocks_per_seq)], np.int32)),
            "start": start,
            "prompt_len": end,
            "pages_per_fetch": self.pages_per_fetch,
            "lora_block_out": self.lora_block_out,
        }
        if a.state is not None:
            batch["state_slot"] = a.state.idx
        lora = self._lora_descriptor(
            np.asarray([a.req._adapter_slot], np.int32))
        if lora is not None:
            batch["lora"] = lora
        # attention-free prefill attends over no span
        m_used = min(blocks_for_tokens(end, self.block_size),
                     self.max_blocks_per_seq) if self.has_attention else 0
        if self.faults is not None:
            self.faults.check("step")
        self.cache, logits = self.fns.prefill_chunk(self.params, self.cache,
                                                    batch, m_used=m_used,
                                                    **self._model_kw)
        self._plan += [-2, req.rid, start, end]
        a.next_prefill = end
        self._prefill_tokens += end - start
        if a.prefill_done:
            a.pos = plen
            self.store.register_prefix(
                req.prompt,
                a.table.blocks[:blocks_for_tokens(plen, self.block_size)],
                namespace=req.adapter_id)
            # one logit row to the host, not the whole (1, C, V) chunk
            row = logits[0, plen - 1 - start].float().cpu().numpy()
            first = self._sample(row, req.sampling, 0)
            self._plan.append(first)
            req.out.append(first)
            self._tenant_count(req)
            req.t_first = time.monotonic()
            if req.on_token is not None:
                req.on_token(first, 0)
            if req.max_new <= 1:
                self._retire(a)
        return True

    # -- decode ------------------------------------------------------------
    def _decode_step(self) -> bool:
        """One batched decode step for every live (prefill-complete) slot."""
        live = [s for s in self.slots if s is not None and s.prefill_done]
        for a in live:
            if a in self.slots:
                with self._blame(a.req.rid):
                    if self._grow(a, a.pos + 1):
                        self._make_writable(a, a.pos, a.pos + 1)
        live = [a for a in live if a in self.slots]
        if not live:
            return False

        m = self.max_blocks_per_seq
        tok = np.zeros((self.max_batch, 1), np.int32)
        tables = np.zeros((self.max_batch, m), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        state_slots = np.zeros((self.max_batch,), np.int32)  # 0 = null slot
        adapter_ids = np.full((self.max_batch,), -1, np.int32)
        rows = []
        for a in live:
            i = self.slots.index(a)
            rows.append((i, a))
            tok[i, 0] = a.req.out[-1]
            tables[i] = a.table.padded(m)
            lens[i] = a.pos
            if a.state is not None:
                state_slots[i] = a.state.idx
            adapter_ids[i] = a.req._adapter_slot
        batch = {"token": self._to_device(tok),
                 "block_tables": self._to_device(tables),
                 "seq_lens": self._to_device(lens),
                 "pages_per_fetch": self.pages_per_fetch,
                 "lora_block_out": self.lora_block_out}
        if self.has_state:
            batch["state_slots"] = self._to_device(state_slots)
        lora = self._lora_descriptor(adapter_ids)
        if lora is not None:
            batch["lora"] = lora
        if self.faults is not None:
            self.faults.check("step")
        self.cache, logits = self.fns.decode_paged(self.params, self.cache,
                                                   batch, **self._model_kw)
        idx = [i for i, _ in rows]
        logits_np = logits[idx].float().cpu().numpy()
        now = time.monotonic()
        for j, (i, a) in enumerate(rows):
            req = a.req
            with self._blame(req.rid):
                nxt = self._sample(logits_np[j], req.sampling, len(req.out))
                self._plan += [i, req.rid, a.pos, nxt]
                req.out.append(nxt)
                a.pos += 1
                self._decode_tokens += 1
                self._tenant_count(req)
                if req.on_token is not None:
                    req.on_token(nxt, len(req.out) - 1)
                if len(req.out) >= req.max_new or a.pos >= self.max_len:
                    self._retire(a, now=now)
        return True

    # -- engine loop -------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: reap deadlines, admit, one prefill chunk,
        one batched decode step.  False when there is nothing left to do.
        On a mesh, rank 0's step first broadcasts what was submitted and
        cancelled since its last step, with its clock; the other ranks run
        the same step from ``follow()``."""
        if self.mesh is not None:
            self._require_leader("step")
            with MESH_LOCK:
                self._lead({"now": time.monotonic(), "step": True})
                return self._step()
        return self._step()

    def _require_leader(self, what: str) -> None:
        if not self.is_leader:
            raise RuntimeError(f"{what} on rank 0 of a serve mesh; the "
                               "other ranks run follow()")

    def _step(self, guarded: bool = False) -> bool:
        if self.mesh is None:
            return self._run_step()
        self._crash_rid = None
        issued = self.mesh.issued
        try:
            worked, crash = self._run_step(), None
        except Exception as e:  # noqa: BLE001 — the ranks agree below
            worked, crash = True, e
        self._check_in_step(worked, crash, guarded,
                            self.mesh.issued - issued)
        return worked

    def _run_step(self) -> bool:
        if self._t0 is None:
            self._t0 = time.monotonic()
        self._plan = []
        worked = self._reap_deadlines() > 0
        worked = self._admit() > 0 or worked
        worked = self._prefill_step() or worked
        worked = self._decode_step() or worked
        if worked:
            self.steps += 1
            self._t_last = time.monotonic()
        return worked

    # -- the replicated state machine (mesh) --------------------------------
    def _lead(self, msg: dict) -> None:
        """Rank 0: send ``msg`` with the ops since the last message to
        every rank, and apply them here (under ``MESH_LOCK``)."""
        ops = [(op, _request_record(x, self.default_deadline_ms)
                if op == "submit" else x) for op, x in self._outbox]
        mine = self._outbox
        self._outbox = []
        msg = dict(msg, ops=ops, engine=self.mesh_id)
        self.mesh.broadcast(msg)
        self._apply(msg, mine)

    def _apply(self, msg: dict, mine=None) -> None:
        """Apply one message's ops in order (rank 0 passes its own Request
        objects as ``mine``; the other ranks build theirs)."""
        self._step_clock = msg["now"]
        for k, (op, x) in enumerate(msg["ops"]):
            if op == "submit":
                self._enqueue(mine[k][1] if mine is not None
                              else _request_from(x))
            elif op == "cancel":
                self._cancel_now(x)
            elif op == "release_prefix_cache":
                self._released = self.store.drop_prefixes()
            elif op == "reset_metrics":
                self._reset_metrics()
            else:
                raise ValueError(f"unknown mesh op {op!r}")

    def _check_in_step(self, worked: bool, crash: Optional[Exception],
                       guarded: bool, issued: int) -> None:
        """All-gather one triple a rank: (0, a digest of this step's plan),
        or (1, the request its crash blames, -1 for none), and the model
        collectives it entered this step.  Every rank planned alike: go on.
        Every rank crashed blaming one request after the same collectives
        (so none is left waiting in one): quarantine it here as on every
        rank (``guarded``), or raise the crash on every rank.  Anything else
        raises ``MeshDivergence`` on every rank."""
        if crash is None:
            plan = [self.steps, int(worked), len(self.queue)] + self._plan
            h = hashlib.blake2b(np.asarray(plan, np.int64).tobytes(),
                                digest_size=8).digest()
            mine = [0, int.from_bytes(h, "little", signed=True), issued]
        else:
            rid = self._crash_blame()
            mine = [1, -1 if rid is None else rid, issued]
        try:
            triples = [tuple(p) for p in self.mesh.gather_ints(mine)]
        except BaseException:
            self._closed = True     # the other ranks are gone or stuck
            raise
        if len(set(triples)) > 1:
            self._closed = True     # every rank stops here; nothing to release
            what = "plan digests" if all(c == 0 for c, _, _ in triples) \
                else "crashes (crashed, blamed request, collectives)"
            raise MeshDivergence(
                f"rank {self.mesh.rank}: step {self.steps} {what} differ "
                f"across the serve mesh ({triples}): the ranks diverged") \
                from crash
        if crash is None:
            if guarded:
                self._guarded_ok(worked)
            return
        if not guarded:
            self._closed = True     # every rank raises this step's crash
            raise crash
        self._on_step_crash(crash, None if mine[1] < 0 else mine[1])

    def follow(self, on_step: Optional[Callable[[], None]] = None) -> int:
        """Ranks other than 0: replay rank 0's steps and ops until rank 0
        calls ``close()``, calling ``on_step()`` after each step; returns
        the steps run."""
        return follow_all([self], on_step)

    def close(self) -> None:
        """Rank 0: release the other ranks from following this engine
        (once; a no-op without a mesh)."""
        if self.mesh is not None and self.is_leader and not self._closed:
            with MESH_LOCK:
                self._closed = True
                self.mesh.broadcast({"stop": True, "engine": self.mesh_id})

    def _control(self, op: str) -> None:
        """Rank 0 of a mesh: run a state-changing op on every rank now,
        outside a step."""
        self._outbox.append((op, None))
        with MESH_LOCK:
            self._lead({"now": time.monotonic(), "step": False})

    def run_until_done(self, max_steps: int = 100_000) -> List[Request]:
        """Drive ``step`` until queue and slots drain; returns the finished
        requests in completion order."""
        for _ in range(max_steps):
            if not self.step():
                break
        return list(self.finished)

    def release_prefix_cache(self) -> int:
        if self.mesh is not None:
            self._control("release_prefix_cache")
            return self._released
        return self.store.drop_prefixes()

    def reset_metrics(self) -> None:
        """Zero the run counters (a warm-up workload first, then a clean
        measured window)."""
        if self.mesh is not None:
            self._control("reset_metrics")
        else:
            self._reset_metrics()

    def _reset_metrics(self) -> None:
        assert all(s is None for s in self.slots) and not self.queue, \
            "reset_metrics with requests in flight"
        self.steps = 0
        self._t0 = None
        self._t_last = 0.0
        self._submitted = 0
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self._preemptions = 0
        self._re_prefill_avoided = 0
        self._tenant_tokens = {}
        self._tenant_finished = {}
        self.store.reset_counters()
        if self.state_store is not None:
            self.state_store.reset_counters()
        self.finished = []
        self.rejected = []
        self.cancelled = []
        self.expired = []
        self.errored = []
        self.shed = []
        self._gateway_shed = 0
        self._step_crashes = 0
        self._consecutive_crashes = 0
        self._swap_failures = 0
        self.degraded = False
        self.invariant_violations = []
        self.pool.peak_used = self.pool.num_used

    # -- metrics -----------------------------------------------------------
    def metrics(self) -> ServeMetrics:
        wall = max(self._t_last - self._t0, 1e-9) if self._t0 else 0.0
        fin = self.finished
        ttfts = [r.t_first - r.t_submit for r in fin if r.t_first > 0]
        itl_num = sum(r.t_done - r.t_first for r in fin if len(r.out) > 1)
        itl_den = sum(len(r.out) - 1 for r in fin if len(r.out) > 1)
        am = self.adapters.metrics()
        tenants = sorted(set(self._tenant_tokens) | set(self._tenant_finished))
        return ServeMetrics(
            wall_s=wall,
            requests_submitted=self._submitted,
            requests_finished=len(fin),
            requests_rejected=len(self.rejected),
            prefill_tokens=self._prefill_tokens,
            decode_tokens=self._decode_tokens,
            engine_steps=self.steps,
            tokens_per_sec=self._decode_tokens / wall if wall else 0.0,
            ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
            ttft_max_s=float(np.max(ttfts)) if ttfts else 0.0,
            itl_mean_s=itl_num / itl_den if itl_den else 0.0,
            peak_blocks_used=self.pool.peak_used,
            pool_blocks=self.pool.usable_blocks,
            block_size=self.block_size,
            peak_pool_utilization=self.pool.peak_used / self.pool.usable_blocks,
            dense_equiv_blocks=dense_equiv_blocks(self.max_batch, self.max_len,
                                                  self.block_size),
            preemptions=self._preemptions,
            shared_blocks=self.store.shared_blocks,
            cow_copies=self.store.cow_copies,
            # the state slab is the one-block case of the pool: its swaps
            # are the same tier movement, folded into the same counters
            swap_out_blocks=self.store.swapped_out
            + (self.state_store.swapped_out if self.state_store else 0),
            swap_in_blocks=self.store.swapped_in
            + (self.state_store.swapped_in if self.state_store else 0),
            re_prefill_avoided=self._re_prefill_avoided,
            requests_expired=len(self.expired),
            requests_shed=len(self.shed) + self._gateway_shed,
            requests_errored=len(self.errored),
            step_crashes=self._step_crashes,
            swap_failures=self._swap_failures,
            degraded=self.degraded,
            mesh_devices=self.mesh.n_model if self.mesh is not None else 1,
            tp_devices=self.mesh.n_model if self.tp else 1,
            param_bytes_per_device=self.param_bytes_per_device,
            param_bytes_replicated=self.param_bytes_replicated,
            adapters_loaded=am["adapters_loaded"],
            adapter_loads=am["adapter_loads"],
            adapter_evictions=am["adapter_evictions"],
            adapter_host_reloads=am["adapter_host_reloads"],
            adapter_device_bytes=am["adapter_device_bytes"],
            adapter_host_bytes=am["adapter_host_bytes"],
            per_tenant={
                t: {"tokens": self._tenant_tokens.get(t, 0),
                    "requests_finished": self._tenant_finished.get(t, 0)}
                for t in tenants},
        )


def follow_all(engines: List[ServeEngine],
               on_step: Optional[Callable[[], None]] = None) -> int:
    """Ranks other than 0 of one mesh: replay rank 0's steps and ops on
    ``engines`` (built in rank 0's order: each broadcast names the engine
    it is for) until rank 0 has closed every one of them, calling
    ``on_step()`` after each step; returns the steps run.  A rank 0 that
    steps several engines (the gateway's models, each from a thread of its
    own) takes their steps one at a time under ``MESH_LOCK``, and these
    ranks take them in the order it broadcasts them."""
    by_id = {}
    for eng in engines:
        if eng.mesh is None or eng.is_leader:
            raise RuntimeError("follow() runs on ranks other than 0 of a "
                               "serve mesh")
        by_id[eng.mesh_id] = eng
    mesh = engines[0].mesh
    open_ids = set(by_id)
    n = 0
    while open_ids:
        msg = mesh.broadcast(None)
        eng = by_id.get(msg.get("engine"))
        if eng is None or eng.mesh_id not in open_ids:
            raise MeshDivergence(
                f"rank {mesh.rank}: a message for engine "
                f"{msg.get('engine')!r}, which this rank does not follow "
                f"(it follows {sorted(open_ids)})")
        if msg.get("stop"):
            eng._closed = True
            open_ids.discard(eng.mesh_id)
            continue
        eng._apply(msg)
        if msg["step"]:
            eng._step(guarded=msg.get("guarded", False))
            n += 1
            if on_step is not None:
                on_step()
    return n


def _request_record(req: Request, default_deadline_ms) -> tuple:
    """What the other ranks of a mesh need of a submitted request: its
    scheduling inputs, rank 0's submit time and its deadline as rank 0
    resolves it (no hooks: they run on rank 0 only)."""
    dl = req.deadline_ms if req.deadline_ms is not None \
        else default_deadline_ms
    return (req.rid, list(req.prompt), req.max_new, req.sampling, dl,
            req.t_submit)


def _request_from(record: tuple) -> Request:
    rid, prompt, max_new, sampling, deadline_ms, t_submit = record
    return Request(rid=rid, prompt=prompt, max_new=max_new,
                   sampling=sampling, deadline_ms=deadline_ms,
                   t_submit=t_submit)
