"""Paged KV-cache bookkeeping: block pool, per-request block tables, metrics.

This module is the *allocator* half of the paged serve engine — pure Python /
numpy, no jax — so it can be unit-tested in milliseconds and reasoned about
independently of the model code.  The device-side layout it manages is

    cache["k"], cache["v"]: (n_layers, num_blocks, block_size, n_kv, head_dim)

Block 0 is the **null block**: never allocated, used as the scatter/gather
target for padded batch rows and padded block-table entries.  Garbage written
there is never read unmasked (attention masks by per-request sequence length),
so collisions on the null block are harmless by construction.

Admission control works on *worst-case footprints*: a request writes at most
``len(prompt) + max_new - 1`` KV positions over its lifetime (the last sampled
token's KV never lands), i.e. ``worst_case_blocks`` blocks.  The conservative
policy reserves that up front so a request, once admitted, can never fail a
mid-flight allocation; the optimistic policy reserves only the prompt's blocks
and relies on preemption when the pool runs dry (MNN-LLM-style block-wise
management, arXiv 2506.10443).

This module owns the *physical* allocator and metrics only.  Refcounted block
handles, tier movement (host swap), copy-on-write sharing, and the per-request
``BlockTable`` live one level up in ``repro_torch.serve.kv_store``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

NULL_BLOCK = 0


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``n_tokens`` KV entries."""
    return -(-n_tokens // block_size)  # ceil div


def worst_case_blocks(prompt_len: int, max_new: int, block_size: int) -> int:
    """Exact upper bound on blocks a request's KV can ever occupy.

    The last sampled token's KV is never written (generation stops before its
    decode step), so a request writes exactly ``prompt + max_new - 1``
    positions.  Admission reserves this bound — the old ``prompt + max_new``
    bound over-reserved one block whenever the total crossed a block edge.
    """
    return blocks_for_tokens(prompt_len + max(max_new - 1, 0), block_size)


class PoolExhausted(Exception):
    """Raised by ``alloc`` when no free block exists (callers that admit
    conservatively should never see this; optimistic callers catch it and
    preempt)."""


class BlockPool:
    """Fixed-size pool of KV blocks with reservation accounting.

    ``num_blocks`` counts the device-side slabs *including* the null block;
    ``usable_blocks`` is what requests can actually hold.  ``reserve`` /
    ``release`` move blocks between the free and reserved ledgers without
    touching device memory — an admitted request draws its actual blocks out
    of its own reservation via ``alloc(reserved=True)``.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list keeps recently-freed (cache-warm) blocks hot.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._reserved = 0
        self.peak_used = 0
        # optional chaos hook (repro_torch.serve.faults.FaultInjector): checked at
        # alloc entry, BEFORE any ledger mutation, so an injected allocator
        # failure can never corrupt the free list it is testing.  The site
        # name is an attribute so derived pools (the state slab's slot pool)
        # fault under their own REPRO_FAULT site.
        self.fault_injector = None
        self.fault_site = "alloc"

    # -- introspection ----------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Blocks not handed out (ignores reservations)."""
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.usable_blocks - len(self._free)

    @property
    def num_reserved(self) -> int:
        return self._reserved

    def available(self) -> int:
        """Blocks free AND not spoken for by a reservation."""
        return len(self._free) - self._reserved

    def utilization(self) -> float:
        return self.num_used / self.usable_blocks

    # -- reservations -----------------------------------------------------
    def can_reserve(self, n: int) -> bool:
        return n <= self.available()

    def reserve(self, n: int) -> bool:
        """Logically earmark ``n`` free blocks; False if they don't exist."""
        if not self.can_reserve(n):
            return False
        self._reserved += n
        return True

    def release(self, n: int) -> None:
        """Return ``n`` unused reservation slots to the available ledger."""
        if n > self._reserved:
            raise ValueError(f"releasing {n} > reserved {self._reserved}")
        self._reserved -= n

    # -- alloc / free -----------------------------------------------------
    def alloc(self, reserved: bool = False) -> int:
        """Pop one free block id.  ``reserved=True`` draws the block out of an
        existing reservation (the caller must have reserved it); otherwise the
        block must be available over and above all reservations."""
        if self.fault_injector is not None:
            self.fault_injector.check(self.fault_site)
        if reserved:
            if self._reserved < 1:
                raise ValueError("alloc(reserved=True) without a reservation")
            if not self._free:
                raise PoolExhausted("reservation ledger corrupt: no free block")
            self._reserved -= 1
        else:
            if self.available() < 1:
                raise PoolExhausted(
                    f"no unreserved block free (used {self.num_used}/"
                    f"{self.usable_blocks}, reserved {self._reserved})")
        blk = self._free.pop()
        self.peak_used = max(self.peak_used, self.num_used)
        return blk

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("attempt to free the null block")
            if not (0 < b < self.num_blocks):
                raise ValueError(f"block id {b} out of range")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)


@dataclasses.dataclass
class ServeMetrics:
    """One serving run's scorecard (emitted into BENCH_serve.json).

    Counters report *delivered* work: tokens discarded by a legacy
    (non-swap) preemption are backed out, so throughput can't be inflated
    by churn.  Field groups: wall/request/token tallies, latency
    (``ttft_*`` submit->first-token, ``itl_mean_s`` between tokens), pool
    footprint vs the dense slot cache, tiered-KVStore traffic, and the
    serve-mesh width.
    """
    wall_s: float = 0.0                  # first step -> last productive step
    requests_submitted: int = 0
    requests_finished: int = 0
    requests_rejected: int = 0           # failed admission validation
    prefill_tokens: int = 0              # prompt tokens actually run
    decode_tokens: int = 0               # sampled tokens actually delivered
    engine_steps: int = 0
    tokens_per_sec: float = 0.0          # decode tokens / wall
    ttft_mean_s: float = 0.0             # submit -> first token
    ttft_max_s: float = 0.0
    itl_mean_s: float = 0.0              # mean inter-token latency
    peak_blocks_used: int = 0            # high-water mark of live KV blocks
    pool_blocks: int = 0                 # usable blocks in the pool
    block_size: int = 0
    peak_pool_utilization: float = 0.0   # peak_blocks_used / pool_blocks
    dense_equiv_blocks: int = 0          # max_batch * ceil(max_len/block_size)
    preemptions: int = 0
    # tiered-KVStore traffic (prefix sharing, copy-on-write, host swap)
    shared_blocks: int = 0               # block adoptions via fork()
    cow_copies: int = 0                  # shared blocks privatized before a write
    swap_out_blocks: int = 0             # device -> host (preemption parking)
    swap_in_blocks: int = 0              # host -> device (restore on readmission)
    re_prefill_avoided: int = 0          # prompt tokens NOT re-prefilled (shared
    #                                      prefixes + restored preemptions)
    # fault tolerance (PR 8): terminal outcomes past the happy path
    requests_expired: int = 0            # deadline reaper kills (queued/active)
    requests_shed: int = 0               # load-shed submits (bounded queue /
    #                                      gateway 429 pressure threshold)
    requests_errored: int = 0            # quarantined by a step-loop crash
    step_crashes: int = 0                # step() exceptions survived
    swap_failures: int = 0               # swap_out faults downgraded to the
    #                                      legacy drop-and-restart path
    degraded: bool = False               # >= max consecutive crashes; /health
    #                                      answers 503 until a clean step
    mesh_devices: int = 1                # "model"-axis width the pool is
    #                                      sharded over (1 = single device)
    tp_devices: int = 1                  # "model"-axis width the WEIGHTS are
    #                                      sharded over (1 = replicated)
    param_bytes_per_device: int = 0      # bytes one device stores
    param_bytes_replicated: int = 0      # logical (unsharded) param bytes
    # multi-LoRA (PR 9): AdapterStore footprint + per-tenant delivery
    adapters_loaded: int = 0             # device-resident adapters now
    adapter_loads: int = 0               # load() calls that wrote a slot
    adapter_evictions: int = 0           # LRU slot evictions (to host tier)
    adapter_host_reloads: int = 0        # evicted adapters brought back
    adapter_device_bytes: int = 0        # allocated slab footprint
    adapter_host_bytes: int = 0          # write-through host copies
    per_tenant: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)            # adapter_id ("base") -> tallies

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"{self.requests_finished}/{self.requests_submitted} requests, "
                f"{self.decode_tokens} decode tokens in {self.wall_s:.2f}s -> "
                f"{self.tokens_per_sec:.1f} tok/s | ttft {self.ttft_mean_s*1e3:.0f}ms "
                f"| itl {self.itl_mean_s*1e3:.1f}ms | pool peak "
                f"{self.peak_blocks_used}/{self.pool_blocks} blocks "
                f"({self.peak_pool_utilization:.0%}) | "
                f"{self.preemptions} preemptions, {self.requests_rejected} rejected"
                f" | {self.shared_blocks} shared / {self.cow_copies} CoW blocks, "
                f"swap {self.swap_out_blocks} out / {self.swap_in_blocks} in, "
                f"{self.re_prefill_avoided} prefill tokens avoided"
                + (f" | {self.requests_shed} shed / {self.requests_expired} "
                   f"expired / {self.requests_errored} errored, "
                   f"{self.step_crashes} step crashes"
                   + (" [DEGRADED]" if self.degraded else "")
                   if (self.requests_shed or self.requests_expired
                       or self.requests_errored or self.step_crashes) else "")
                + (f" | {self.adapters_loaded} adapters resident "
                   f"({self.adapter_device_bytes / 1e6:.2f} MB slab, "
                   f"{self.adapter_evictions} evictions)"
                   if self.adapters_loaded or self.adapter_loads else "")
                + (f" | pool sharded over {self.mesh_devices} devices"
                   if self.mesh_devices > 1 else "")
                + (f" | TP x{self.tp_devices}: "
                   f"{self.param_bytes_per_device / 1e6:.2f} MB/device of "
                   f"{self.param_bytes_replicated / 1e6:.2f} MB params"
                   if self.tp_devices > 1 else ""))


def dense_equiv_blocks(max_batch: int, max_len: int, block_size: int) -> int:
    """KV footprint (in blocks) of the old dense slot cache: every slot
    preallocates max_len positions regardless of the request in it."""
    return max_batch * blocks_for_tokens(max_len, block_size)
