"""Tiered KV storage: refcounted copy-on-write blocks across named tiers.

This module is the engine<->cache boundary the serve stack speaks: a
``KVStore`` owns refcounted ``Block`` handles living in named storage tiers —
``DeviceTier`` wraps the torch block slab
(``repro_torch.serve.paged_cache.BlockPool`` is its allocator), ``HostTier``
holds blocks in host memory (pinned CPU tensors for a CUDA slab) — and moves
KV between them:

  * ``fork(blocks)``   — copy-on-write prefix sharing: a second request maps
    the *same* physical blocks (refcount bumped); writes to a shared block go
    through ``cow_into`` first, so sharers never observe each other's tokens.
  * ``swap_out/swap_in`` — preemption parks a request's cold blocks on the
    host tier instead of discarding them; re-admission restores them and the
    request resumes mid-generation (the paper's heterogeneous-storage angle
    applied to serving; block-wise management after MNN-LLM, arXiv
    2506.10443).
  * a budgeted prefix registry — completed prompt prefixes stay mapped (LRU,
    capped at ``prefix_cache_blocks``) so identical prefixes across requests
    prefill exactly once.

Only the *data plane* touches tensors: tier read/copy/write callbacks come
from the model family (``ModelFns.paged_block_*``), so the store itself stays
family-agnostic and the bookkeeping is plain Python — unit-testable in
milliseconds with stub tiers.

A copy of ``src/repro/serve/kv_store.py`` for the single-device port: the
recurrent-state slab (``SlabDeviceView`` / ``StateSlab``) of the ssm and
hybrid families is here; the mesh-sharded slab (``shardings`` / ``_pin``)
is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.paged_cache import (NULL_BLOCK, BlockPool, PoolExhausted,
                                     blocks_for_tokens)

DEVICE = "device"
HOST = "host"


@dataclasses.dataclass(eq=False)
class Block:
    """A refcounted handle on one physical KV block in some tier.

    Identity semantics (``eq=False``): two handles are the same block only if
    they are the same object.  ``idx`` is the physical slot in ``tier``;
    refcounts are managed exclusively by the owning ``KVStore``.
    """
    tier: str
    idx: int
    refcount: int = 1

    @property
    def shared(self) -> bool:
        return self.refcount > 1


class DeviceTier:
    """The torch block slab behind a ``BlockPool`` allocator.

    ``cache`` is the dict of slabs the model fns update in place (shape per
    leaf: ``(n_layers, num_blocks, block_size, n_kv, head_dim)``); the
    engine passes it to every dispatch and stores what comes back, so the
    tier holds the *current* reference between dispatches.  Data-plane ops
    (copy/read/write of one block) are injected by the model family so the
    tier never assumes a leaf layout.
    """

    name = DEVICE

    def __init__(self, cache, pool: BlockPool,
                 copy_block: Callable, read_block: Callable,
                 write_block: Callable):
        self.cache = cache
        self.pool = pool
        self._copy = copy_block
        self._read = read_block
        self._write = write_block

    @property
    def block_size(self) -> int:
        return self.pool.block_size

    def alloc(self, reserved: bool = False) -> int:
        """Pop one free physical block id (``reserved=True`` draws it out of
        an admission reservation).  Raises ``PoolExhausted`` under pressure."""
        return self.pool.alloc(reserved=reserved)

    def free(self, idx: int) -> None:
        """Return physical block ``idx`` to the pool's free list."""
        self.pool.free([idx])

    def copy(self, src: int, dst: int) -> None:
        """Device-side block copy (the CoW data plane)."""
        self.cache = self._copy(self.cache, src, dst)

    def read(self, idx: int):
        """Block ``idx`` -> host tensors (device -> host swap traffic)."""
        return self._read(self.cache, idx)

    def write(self, idx: int, data) -> None:
        """Host tensors -> block ``idx`` (host -> device swap traffic)."""
        self.cache = self._write(self.cache, idx, data)


def _own(v):
    """A private host copy of one leaf (pinned memory stays pinned)."""
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype,
                           pin_memory=v.is_pinned()).copy_(v)
    return np.array(v)


class HostTier:
    """Host-DRAM tier: per-block host buffers (pinned CPU tensors for a CUDA
    slab, numpy arrays for stub tiers).

    Blocks are stored block-major — ``slab[leaf][i]`` is block ``i``'s data —
    so a swap moves one contiguous chunk per leaf.  There is no null block:
    host blocks are never indexed by device-side tables.
    """

    name = HOST

    def __init__(self, num_blocks: int):
        if num_blocks < 0:
            raise ValueError("host tier size must be >= 0")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._data: Dict[int, object] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted("host tier full")
        return self._free.pop()

    def free(self, idx: int) -> None:
        if not (0 <= idx < self.num_blocks):
            raise ValueError(f"host block {idx} out of range")
        if idx in self._free:
            raise ValueError(f"double free of host block {idx}")
        self._data.pop(idx, None)
        self._free.append(idx)

    def write(self, idx: int, data) -> None:
        # keep our own copy so a later device-side overwrite can't alias it
        self._data[idx] = {k: _own(v) for k, v in data.items()} \
            if isinstance(data, dict) else _own(data)

    def read(self, idx: int):
        return self._data[idx]


@dataclasses.dataclass
class _PrefixEntry:
    tokens: Tuple[int, ...]
    blocks: List[Block]
    # tenant namespace (the request's adapter id): entries only ever match
    # requests in the same namespace, so tenant A's KV blocks are never
    # served to tenant B even for bit-identical prompts.  None = the shared
    # base namespace (pre-multi-LoRA behavior).
    namespace: Optional[str] = None


class KVStore:
    """Refcounted block handles across named tiers + the prefix registry.

    The engine allocates through the store (``alloc`` returns a handle with
    refcount 1), shares through ``fork``, privatizes shared blocks through
    ``cow_into`` before writing, and parks/restores KV through
    ``swap_out``/``swap_in``.  ``decref`` returns a block to its tier's
    allocator when the last reference drops — blocks are never freed behind a
    live holder's back.
    """

    # chaos sites (repro_torch.serve.faults): class attributes so derived stores
    # (the recurrent-state slab) fault under their own REPRO_FAULT sites
    SITE_SWAP_OUT = "swap_out"
    SITE_SWAP_IN = "swap_in"

    def __init__(self, device: DeviceTier, host: Optional[HostTier] = None,
                 prefix_cache_blocks: int = 0):
        self.device = device
        self.host = host or HostTier(0)
        self.tiers: Dict[str, object] = {DEVICE: self.device, HOST: self.host}
        self.prefix_cache_blocks = prefix_cache_blocks
        self._prefixes: List[_PrefixEntry] = []   # oldest first (LRU order)
        # optional chaos hook (repro_torch.serve.faults.FaultInjector): checked at
        # swap entry, before any tier state moves, so an injected swap fault
        # leaves both tiers consistent (the engine downgrades or quarantines)
        self.fault_injector = None
        # traffic counters (engine folds these into ServeMetrics)
        self.shared_blocks = 0
        self.cow_copies = 0
        self.swapped_out = 0
        self.swapped_in = 0

    # -- refcounting -------------------------------------------------------
    def alloc(self, reserved: bool = False) -> Block:
        """One fresh device block (refcount 1).  Raises PoolExhausted under
        pressure — callers evict prefix-cache entries and/or preempt."""
        return Block(DEVICE, self.device.alloc(reserved=reserved))

    def incref(self, block: Block) -> Block:
        if block.refcount < 1:
            raise ValueError("incref on a freed block")
        block.refcount += 1
        return block

    def decref(self, block: Block) -> None:
        if block.refcount < 1:
            raise ValueError("decref on a freed block")
        block.refcount -= 1
        if block.refcount == 0:
            self.tiers[block.tier].free(block.idx)

    def fork(self, blocks: Sequence[Block]) -> List[Block]:
        """Map the same physical blocks into another holder (CoW sharing):
        refcounts bump, no data moves.  Writers must go through
        ``cow_into`` first."""
        out = [self.incref(b) for b in blocks]
        self.shared_blocks += len(out)
        return out

    def cow_into(self, block: Block, dst: Block) -> Block:
        """Privatize a shared device block before a write: device-copy its
        contents into ``dst`` (a fresh block the caller allocated) and drop
        our reference on the original.  Returns ``dst``."""
        assert block.tier == DEVICE and dst.tier == DEVICE
        if not block.shared:
            raise ValueError("cow_into on an exclusive block — write in place")
        self.device.copy(block.idx, dst.idx)
        self.decref(block)
        self.cow_copies += 1
        return dst

    # -- tier movement -----------------------------------------------------
    def swap_out(self, block: Block) -> Block:
        """Move one device block to the host tier.

        Shared blocks are NOT copied: other holders (prefix registry, other
        requests) pin them on-device anyway, so the handle is returned
        unchanged and the caller keeps its reference — a restore finds the
        block already resident.  Exclusive blocks move: data is read back to
        host, the device slot is freed, and a host-tier handle comes back.
        """
        assert block.tier == DEVICE
        if block.shared:
            return block
        if self.fault_injector is not None:
            self.fault_injector.check(self.SITE_SWAP_OUT)
        hidx = self.host.alloc()
        self.host.write(hidx, self.device.read(block.idx))
        self.decref(block)
        self.swapped_out += 1
        return Block(HOST, hidx)

    def swap_in(self, block: Block, dst: Block) -> Block:
        """Restore one host block into ``dst`` (a fresh device block the
        caller allocated under its reservation).  The host slot is freed."""
        if block.tier == DEVICE:
            return block                      # was never swapped (shared)
        assert dst.tier == DEVICE
        if self.fault_injector is not None:
            self.fault_injector.check(self.SITE_SWAP_IN)
        self.device.write(dst.idx, self.host.read(block.idx))
        self.decref(block)
        self.swapped_in += 1
        return dst

    def can_swap_out(self, blocks: Sequence[Block]) -> bool:
        need = sum(1 for b in blocks if b.tier == DEVICE and not b.shared)
        return need <= self.host.num_free

    # -- prefix registry ---------------------------------------------------
    def match_prefix(self, tokens: Sequence[int],
                     namespace: Optional[str] = None
                     ) -> Tuple[int, List[Block]]:
        """Longest registered prefix of ``tokens`` within ``namespace``
        (the request's adapter id; None = base): (shared token count, the
        registry's blocks covering it).  Entries from other namespaces never
        match — prefix KV encodes the adapter that wrote it, so a
        cross-tenant hit would replay tenant A's activations for tenant B.
        Blocks are NOT incref'd — adopt them with ``fork``.  A hit refreshes
        the entry's LRU position."""
        best_len, best = 0, None
        for e in self._prefixes:
            if e.namespace != namespace:
                continue
            lim = min(len(tokens), len(e.tokens), len(e.blocks) * self.block_size)
            n = 0
            while n < lim and tokens[n] == e.tokens[n]:
                n += 1
            if n > best_len:
                best_len, best = n, e
        if best is None:
            return 0, []
        self._prefixes.remove(best)
        self._prefixes.append(best)           # LRU touch
        return best_len, best.blocks[:blocks_for_tokens(best_len,
                                                        self.block_size)]

    def register_prefix(self, tokens: Sequence[int],
                        blocks: Sequence[Block],
                        namespace: Optional[str] = None) -> bool:
        """Retain a completed prompt's blocks for future sharers *in the
        same namespace*.  The registry holds its own references (truncated
        to the block budget, evicting LRU entries to make room); False if
        the budget is 0 or the prefix is already covered."""
        if self.prefix_cache_blocks <= 0 or not blocks:
            return False
        covered, _ = self.match_prefix(tokens, namespace=namespace)
        if covered >= len(tokens):
            return False
        keep = list(blocks[:self.prefix_cache_blocks])
        while (self._registry_blocks() + len(keep) > self.prefix_cache_blocks
               and self._prefixes):
            self._evict_one()
        entry = _PrefixEntry(tuple(tokens), [self.incref(b) for b in keep],
                             namespace=namespace)
        self._prefixes.append(entry)
        return True

    def _registry_blocks(self) -> int:
        return sum(len(e.blocks) for e in self._prefixes)

    def _evict_one(self) -> int:
        e = self._prefixes.pop(0)
        freed = 0
        for b in e.blocks:
            was = b.refcount
            self.decref(b)
            freed += int(was == 1)
        return freed

    def evict_prefixes(self, min_blocks: int = 1) -> int:
        """Drop LRU registry entries until >= ``min_blocks`` device blocks
        came free (or the registry drains).  Returns blocks actually freed —
        0 means eviction can't help the caller's allocation failure."""
        freed = 0
        while freed < min_blocks and self._prefixes:
            freed += self._evict_one()
        return freed

    def drop_prefixes(self) -> int:
        """Release the whole prefix cache (benchmarks call this between
        measured windows; tests call it to assert the pool drains to 0)."""
        n = 0
        while self._prefixes:
            n += self._evict_one()
        return n

    @property
    def num_prefixes(self) -> int:
        return len(self._prefixes)

    @property
    def block_size(self) -> int:
        return self.device.block_size

    def reset_counters(self) -> None:
        self.shared_blocks = 0
        self.cow_copies = 0
        self.swapped_out = 0
        self.swapped_in = 0


@dataclasses.dataclass
class BlockTable:
    """A request's ordered block-handle list: token position p lives at
    ``blocks[p // block_size]`` offset ``p % block_size``.  Handles may be
    shared (forked prefixes) — the engine privatizes via CoW before any
    write.  Device-side batching consumes ``padded()`` physical ids."""
    block_size: int
    blocks: List[Block] = dataclasses.field(default_factory=list)

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.block_size

    def block_ids(self) -> List[int]:
        assert all(b.tier == DEVICE for b in self.blocks), \
            "device batching over non-device blocks (missing swap_in?)"
        return [b.idx for b in self.blocks]

    def padded(self, max_blocks: int) -> List[int]:
        """Fixed-width physical-id view for the device (null-block padded)."""
        ids = self.block_ids()
        if len(ids) > max_blocks:
            raise ValueError(f"table {len(ids)} blocks > max {max_blocks}")
        return ids + [NULL_BLOCK] * (max_blocks - len(ids))

    def release_to(self, store: KVStore) -> None:
        for b in self.blocks:
            store.decref(b)
        self.blocks = []


class SlabDeviceView:
    """Device tier over the recurrent-state *slots* of a shared cache.

    SSM/hybrid requests carry O(1) state (conv window + scan state) instead
    of, or for hybrids beside, per-token KV.  The state lives in the same
    cache the block tier hands to the model functions (one holder: the base
    ``DeviceTier``); this view indexes its *slot* axis instead of the block
    axis.  Slot 0 is the null slot (as ``NULL_BLOCK``): padded decode rows
    scatter there, and it is never allocated.  Data-plane callbacks come
    from the model family (``ModelFns.state_slot_*``), so the view assumes
    no leaf layout: for hybrids they touch only the ``ssm`` leaves and the
    block callbacks only the ``k``/``v`` leaves of one cache.
    """

    name = DEVICE

    def __init__(self, base: DeviceTier, pool: BlockPool,
                 copy_slot: Callable, read_slot: Callable,
                 write_slot: Callable):
        self.base = base
        self.pool = pool
        self._copy = copy_slot
        self._read = read_slot
        self._write = write_slot

    @property
    def cache(self):
        return self.base.cache

    @property
    def block_size(self) -> int:
        return 1                      # one slot holds one request's state

    def alloc(self, reserved: bool = False) -> int:
        return self.pool.alloc(reserved=reserved)

    def free(self, idx: int) -> None:
        self.pool.free([idx])

    def copy(self, src: int, dst: int) -> None:
        self.base.cache = self._copy(self.base.cache, src, dst)

    def read(self, idx: int):
        return self._read(self.base.cache, idx)

    def write(self, idx: int, data) -> None:
        self.base.cache = self._write(self.base.cache, idx, data)


class StateSlab(KVStore):
    """Recurrent-state tier: the one-block case of the block pool.

    A request's scan state has a fixed size, so its "table" is a single
    refcounted ``Block`` whose ``idx`` is a slot of the state slab.  The
    KVStore machinery carries over unchanged: refcounting, ``fork`` +
    ``cow_into`` (state CoW), ``swap_out``/``swap_in`` to a host tier (a
    parked state survives preemption as parked KV does).  Only the chaos
    sites are renamed, so ``REPRO_FAULT`` can target slab traffic apart
    from block traffic.  The prefix registry is inherited and unused (a
    state snapshot encodes the whole prefix, not a block-aligned piece).
    """

    SITE_SWAP_OUT = "slab_swap_out"
    SITE_SWAP_IN = "slab_swap_in"

    def __init__(self, device: SlabDeviceView,
                 host: Optional[HostTier] = None):
        super().__init__(device, host, prefix_cache_blocks=0)
        device.pool.fault_site = "slab_alloc"
