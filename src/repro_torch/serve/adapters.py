"""AdapterStore: multi-tenant LoRA adapters over one shared paged base (the
port of ``src/repro/serve/adapters.py``).

N tenants share one set of base weights and one KV block pool; the only
per-tenant state is a pair of low-rank deltas ``(A, B)`` per adapted
projection per layer.  This module owns that state, in the same two-tier
shape as the KV store:

* **device tier** — one stacked slab per projection, torch tensors
  ``A (L, S, d_in, R)`` and ``B (L, S, R, d_out)`` on the engine's device in
  the config's dtype, where ``S`` is the slot capacity
  (``REPRO_LORA_MAX_ADAPTERS``) and ``R`` the shared rank pad.  The layer
  axis leads so the model's layer loop slices one layer off each slab; the
  slot axis is what the segmented kernels (``ops.lora_shrink`` /
  ``ops.lora_expand``) gather over with per-row slot indices.  Writing a
  slot is an in-place ``copy_`` into the slab (the JAX store rebuilds its
  slab functionally).
* **host swap tier** — a write-through numpy copy of every loaded adapter's
  padded weights.  Evicting an adapter just frees its device slot; loading
  it again is a slab write from the host copy, no checkpoint I/O.

Slots are refcounted (one ref per in-flight request using the adapter) and
LRU-ordered; ``load`` past capacity evicts the least-recently-used idle
(refcount-0, unpinned) slot or raises ``AdapterStoreFull`` when every slot
is busy — a full store must reject new tenants, never corrupt a live one.
``pin`` exempts an adapter from eviction (resident system tenants).

Adapters with a rank below the slot pad are zero-padded: the padding
contributes exactly zero through the kernels, so ragged ranks share one
slab shape and a rank-0 adapter is token-identical to the base model.  The
``alpha / rank`` LoRA scale is folded into ``B`` at load time, keeping the
kernels scale-free.

When no checkpoint exists, adapters are *materialized from their name*:
``make_lora_params`` derives a deterministic seed from the adapter name
(numpy and crc32, as the JAX package does), so a tenant's factors are
bit-identical in both packages.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.perf import perf


class AdapterStoreFull(RuntimeError):
    """Every device slot is held by a pinned or in-flight adapter."""


def adapted_projections(cfg) -> "Dict[str, Tuple[int, int]]":
    """name -> (d_in, d_out) of every projection the store adapts: the four
    attention projections always; the MLP projections only for dense FFNs
    (MoE experts are routed per token, so MoE archs get attention-only
    LoRA)."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    projs = {"q": (d, q), "k": (d, kv), "v": (d, kv), "o": (q, d)}
    if cfg.moe is None:
        if cfg.act == "swiglu":
            projs.update({"gate": (d, cfg.d_ff), "up": (d, cfg.d_ff)})
        else:
            projs.update({"wi": (d, cfg.d_ff)})
        projs.update({"down": (cfg.d_ff, d)})
    return projs


def make_lora_params(cfg, rank: int, seed: int, scale: float = 0.5
                     ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Synthesize per-layer LoRA weights: name -> (A (L, d_in, r),
    B (L, r, d_out)) float32.  Both factors are nonzero and deliberately
    large (scale 0.5) so distinct tenants generate distinct tokens on
    random-weight models.  rank=0 yields empty factors (exact base
    behaviour)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (di, do) in adapted_projections(cfg).items():
        a = rng.standard_normal((cfg.n_layers, di, rank)) * scale
        b = rng.standard_normal((cfg.n_layers, rank, do)) * scale
        out[name] = (a.astype(np.float32), b.astype(np.float32))
    return out


def seed_for(name: str) -> int:
    """Deterministic adapter seed from its name (crc32, stable across
    processes, unlike ``hash``)."""
    return zlib.crc32(name.encode("utf-8"))


@dataclasses.dataclass
class _Slot:
    name: str
    rank: int
    refcount: int = 0
    pinned: bool = False
    tick: int = 0               # LRU clock value of the last touch


class AdapterStore:
    """Refcounted, LRU-evictable slab of per-tenant LoRA deltas."""

    def __init__(self, cfg, max_adapters: Optional[int] = None,
                 rank_cap: Optional[int] = None, dtype=None, device=None):
        p = perf()
        self.cfg = cfg
        self.max_adapters = max(1, max_adapters or p.lora_max_adapters)
        cap = rank_cap if rank_cap is not None else max(16, p.lora_rank)
        # rank slot padded to a multiple of 8, as the reference pads it
        self.rank_cap = max(8, ((cap + 7) // 8) * 8)
        self.dtype = dtype or torch_dtype(cfg)
        self.device = resolve_device(device)
        self.projs = adapted_projections(cfg)
        self._slabs: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._slots: List[Optional[_Slot]] = [None] * self.max_adapters
        self._by_name: Dict[str, int] = {}
        self._host: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
        self._host_rank: Dict[str, int] = {}
        self._tick = 0
        self.loads = 0
        self.evictions = 0
        self.host_reloads = 0

    # -- byte accounting ----------------------------------------------------

    def _itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def device_bytes(self) -> int:
        """Allocated device-slab footprint (zero until the first load: the
        slab only exists once a tenant does)."""
        if self._slabs is None:
            return 0
        return self.per_adapter_bytes() * self.max_adapters

    def host_bytes(self) -> int:
        """Write-through host-tier footprint (every loaded adapter, resident
        or evicted)."""
        return sum(a.nbytes + b.nbytes for w in self._host.values()
                   for a, b in w.values())

    def per_adapter_bytes(self, rank: Optional[int] = None) -> int:
        """Device bytes one slot spends on one adapter (at the padded
        rank): the unit the ``REPRO_LORA_MAX_ADAPTERS`` cap multiplies."""
        r = self.rank_cap if rank is None else rank
        return sum(self.cfg.n_layers * r * (di + do)
                   for di, do in self.projs.values()) * self._itemsize()

    # -- tiers --------------------------------------------------------------

    def _alloc_slabs(self):
        slabs = {}
        for name, (di, do) in self.projs.items():
            shape_a = (self.cfg.n_layers, self.max_adapters, di,
                       self.rank_cap)
            shape_b = (self.cfg.n_layers, self.max_adapters, self.rank_cap,
                       do)
            slabs[name] = {
                "a": torch.zeros(shape_a, dtype=self.dtype,
                                 device=self.device),
                "b": torch.zeros(shape_b, dtype=self.dtype,
                                 device=self.device)}
        self._slabs = slabs

    def _write_slot(self, slot: int, weights):
        """Copy one adapter's padded (A, B) factors into device slot
        ``slot`` of every projection slab, in place."""
        for name in self.projs:
            a, b = weights[name]
            sl = self._slabs[name]
            sl["a"][:, slot].copy_(torch.from_numpy(a))
            sl["b"][:, slot].copy_(torch.from_numpy(b))

    def _pad_weights(self, weights, rank: int, alpha: float):
        """Zero-pad factors to the shared rank slot and fold the
        ``alpha/rank`` scale into B (host-tier canonical form)."""
        scale = (alpha / rank) if rank else 0.0
        out = {}
        for name, (di, do) in self.projs.items():
            a, b = weights[name]
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32) * scale
            if a.shape != (self.cfg.n_layers, di, rank) or \
                    b.shape != (self.cfg.n_layers, rank, do):
                raise ValueError(
                    f"adapter projection {name!r}: got A{a.shape} B{b.shape}"
                    f", want A({self.cfg.n_layers},{di},{rank}) "
                    f"B({self.cfg.n_layers},{rank},{do})")
            pad = self.rank_cap - rank
            out[name] = (np.pad(a, ((0, 0), (0, 0), (0, pad))),
                         np.pad(b, ((0, 0), (0, pad), (0, 0))))
        return out

    def _evict_one(self) -> int:
        """Free the least-recently-used idle slot, or raise."""
        victims = [(s.tick, i) for i, s in enumerate(self._slots)
                   if s is not None and s.refcount == 0 and not s.pinned]
        if not victims:
            raise AdapterStoreFull(
                f"all {self.max_adapters} adapter slots pinned or in use")
        _, idx = min(victims)
        # the host tier already holds the write-through copy: drop the slot
        del self._by_name[self._slots[idx].name]
        self._slots[idx] = None
        self.evictions += 1
        return idx

    # -- public API ---------------------------------------------------------

    def load(self, name: str, weights=None, rank: Optional[int] = None,
             alpha: Optional[float] = None) -> int:
        """Make ``name`` device-resident; returns its slot index.  Already
        loaded -> LRU touch only.  ``weights=None`` reloads from the host
        tier if the adapter was evicted, else materializes synthetic
        factors from the adapter name (rank/alpha default to the
        ``REPRO_LORA_*`` knobs)."""
        if name in self._by_name:
            idx = self._by_name[name]
            self._touch(idx)
            return idx
        p = perf()
        if weights is None and name in self._host:
            padded = self._host[name]
            rank = self._host_rank[name]
            self.host_reloads += 1
        else:
            rank = p.lora_rank if rank is None else rank
            alpha = p.lora_alpha if alpha is None else alpha
            if rank > self.rank_cap:
                raise ValueError(f"adapter {name!r} rank {rank} exceeds "
                                 f"store rank cap {self.rank_cap}")
            if weights is None:
                weights = make_lora_params(self.cfg, rank, seed_for(name))
            padded = self._pad_weights(weights, rank, alpha)
        if self._slabs is None:
            self._alloc_slabs()
        try:
            idx = self._slots.index(None)
        except ValueError:
            idx = self._evict_one()
        self._write_slot(idx, padded)
        self._slots[idx] = _Slot(name=name, rank=rank)
        self._by_name[name] = idx
        self._host[name] = padded
        self._host_rank[name] = rank
        self._touch(idx)
        self.loads += 1
        return idx

    def _touch(self, idx: int):
        self._tick += 1
        self._slots[idx].tick = self._tick

    def acquire(self, name: str) -> int:
        """Slot index for a request entering flight; increfs (pair with
        ``release``).  Raises ``KeyError`` if not device-resident: the
        caller decides whether to ``load`` first."""
        idx = self._by_name[name]
        self._slots[idx].refcount += 1
        self._touch(idx)
        return idx

    def release(self, name: str):
        idx = self._by_name.get(name)
        if idx is not None and self._slots[idx].refcount > 0:
            self._slots[idx].refcount -= 1

    def pin(self, name: str):
        self._slots[self._by_name[name]].pinned = True

    def unpin(self, name: str):
        self._slots[self._by_name[name]].pinned = False

    def unload(self, name: str):
        """Drop an adapter from BOTH tiers.  Refuses while in flight."""
        idx = self._by_name.get(name)
        if idx is not None:
            s = self._slots[idx]
            if s.refcount > 0:
                raise RuntimeError(
                    f"adapter {name!r} has {s.refcount} requests in flight")
            del self._by_name[name]
            self._slots[idx] = None
        self._host.pop(name, None)
        self._host_rank.pop(name, None)

    def refcount(self, name: str) -> int:
        idx = self._by_name.get(name)
        return self._slots[idx].refcount if idx is not None else 0

    def is_loaded(self, name: str) -> bool:
        return name in self._by_name

    def known(self, name: str) -> bool:
        """Loaded on either tier."""
        return name in self._by_name or name in self._host

    def loaded(self) -> List[str]:
        """Device-resident adapter names, slot order."""
        return [s.name for s in self._slots if s is not None]

    def rank_of(self, name: str) -> int:
        return self._host_rank[name]

    def slabs(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """The stacked device slabs (projection -> {"a", "b"}), or None
        before any adapter was loaded."""
        return self._slabs

    def metrics(self) -> dict:
        return {
            "adapters_loaded": len(self._by_name),
            "adapter_loads": self.loads,
            "adapter_evictions": self.evictions,
            "adapter_host_reloads": self.host_reloads,
            "adapter_device_bytes": self.device_bytes(),
            "adapter_host_bytes": self.host_bytes(),
            "adapter_slot_cap": self.max_adapters,
        }
