"""Seeded fault injection + KV-leak invariants for the serving stack.

Production failure handling is only trustworthy if the failure paths
actually run.  This module gives the serve engine a deterministic way to
make them run: a ``FaultInjector`` parsed from the ``REPRO_FAULT`` env knob
(or built explicitly) raises ``InjectedFault`` from well-defined *sites* —
the entry points of ``BlockPool.alloc``, ``KVStore.swap_out``/``swap_in``,
and the engine's jitted prefill/decode dispatch ("step") — and the engine's
recovery machinery (quarantine, swap-failure downgrade, degraded health)
does the rest.  Faults fire at operation *entry*, before any bookkeeping
mutates, so a surviving engine must still satisfy the block-accounting
invariants ``check_invariants`` asserts (the
chaos tests hold it to that).

Spec grammar (comma-separated, one rule per clause)::

    REPRO_FAULT="alloc:p=0.05,swap_out:after=3,step:exc=1"

    site := alloc | swap_out | swap_in | step
          | slab_alloc | slab_swap_out | slab_swap_in   (state-slab ops)
    mode := p=<float>   each check at the site fires with probability p
                        (seeded RNG: REPRO_FAULT_SEED, default 0)
          | after=<N>   the (N+1)-th check fires, exactly once
          | exc=<N>     the first N checks fire

Multiple clauses may name the same site; any firing rule raises.  The
injector is plain Python (no jax) and cheap enough to leave wired in — a
``None`` injector costs one attribute test per site.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional

SITES = ("alloc", "swap_out", "swap_in", "step",
         # recurrent-state slab (SSM / hybrid families): same operations,
         # separately addressable so chaos runs can stress slab traffic
         # without also failing every block allocation
         "slab_alloc", "slab_swap_out", "slab_swap_in")


class InjectedFault(RuntimeError):
    """An artificial failure raised by a ``FaultInjector`` rule.  Carries the
    site so recovery paths (and tests) can tell injected faults from real
    bugs.  Deliberately NOT a ``PoolExhausted``: an injected alloc fault
    models an allocator/device error, not ordinary pool pressure, so it must
    not be absorbed by the eviction/preemption ladder."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected {site} fault" + (f" ({detail})" if detail
                                                     else ""))
        self.site = site


@dataclasses.dataclass
class _Rule:
    site: str
    mode: str          # "p" | "after" | "exc"
    value: float
    calls: int = 0
    fired: int = 0

    def should_fire(self, rng: random.Random) -> bool:
        self.calls += 1
        if self.mode == "p":
            fire = rng.random() < self.value
        elif self.mode == "after":
            fire = self.calls == int(self.value) + 1
        else:  # "exc"
            fire = self.calls <= int(self.value)
        self.fired += int(fire)
        return fire


class FaultInjector:
    """Deterministic fault source: ``check(site)`` raises ``InjectedFault``
    when any rule for that site fires.  Seeded, so a chaos run replays the
    same fault schedule given the same spec + seed + call sequence."""

    def __init__(self, rules: List[_Rule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self.rng = random.Random(seed)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultInjector":
        rules: List[_Rule] = []
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            try:
                site, mode_str = clause.split(":", 1)
                mode, value = mode_str.split("=", 1)
            except ValueError:
                raise ValueError(
                    f"bad REPRO_FAULT clause {clause!r} (want site:mode=value)")
            site, mode = site.strip(), mode.strip()
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} "
                                 f"(known: {', '.join(SITES)})")
            if mode not in ("p", "after", "exc"):
                raise ValueError(f"unknown fault mode {mode!r} in {clause!r} "
                                 "(want p=<float>, after=<N>, or exc=<N>)")
            rules.append(_Rule(site=site, mode=mode, value=float(value)))
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        """The REPRO_FAULT / REPRO_FAULT_SEED knobs; None when unset — the
        common case must stay a single dict lookup."""
        spec = os.environ.get("REPRO_FAULT", "")
        if not spec:
            return None
        return cls.parse(spec, seed=int(os.environ.get("REPRO_FAULT_SEED",
                                                       "0")))

    def check(self, site: str) -> None:
        for r in self.rules:
            if r.site == site and r.should_fire(self.rng):
                raise InjectedFault(site, f"{r.mode}={r.value:g}")

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per-site {checks, fired} tallies (chaos_smoke reports these)."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.rules:
            d = out.setdefault(r.site, {"checks": 0, "fired": 0})
            d["checks"] += r.calls
            d["fired"] += r.fired
        return out


def check_kv_invariants(engine) -> List[str]:
    """Block-accounting invariants over a ``ServeEngine`` at a step boundary.

    Every device block the pool says is allocated must be reachable from
    exactly one of the engine's holder sets — active slot tables, parked
    (preempted) requests, the prefix registry — with a refcount equal to the
    number of holder references; ditto host-tier blocks vs parked requests;
    and the pool's reservation ledger must equal the sum of per-slot
    ``reserved_left``.  Returns human-readable violations (empty = healthy).
    Recovery paths call this after every quarantine so a leak shows up at
    the fault that caused it, not at end-of-run teardown.  (Unlike the JAX
    package's copy, the free lists are compared as sets, so a check costs
    O(blocks) and can run after every step of a full-size pool.)  For the
    ssm and hybrid families the recurrent-state slab is held to the same
    contract at slot granularity.
    """
    from repro_torch.serve.kv_store import DEVICE, HOST

    errs: List[str] = []
    holders: Dict[object, int] = {}   # Block handle (identity) -> references

    def note(b) -> None:
        holders[b] = holders.get(b, 0) + 1

    for a in engine.slots:
        if a is not None:
            for b in a.table.blocks:
                note(b)
    for parked in engine._parked.values():
        for b in parked.blocks:
            note(b)
    for entry in engine.store._prefixes:
        for b in entry.blocks:
            note(b)

    for b, n in holders.items():
        if b.refcount != n:
            errs.append(f"{b.tier} block {b.idx}: refcount {b.refcount} != "
                        f"{n} holder reference(s)")

    pool = engine.pool
    dev_live = {b.idx for b in holders if b.tier == DEVICE}
    pool_used = set(range(1, pool.num_blocks)) - set(pool._free)
    leaked = sorted(pool_used - dev_live)
    phantom = sorted(dev_live - pool_used)
    if leaked:
        errs.append(f"device blocks leaked (allocated, no holder): {leaked}")
    if phantom:
        errs.append(f"device blocks held but marked free: {phantom}")

    host = engine.store.host
    host_live = {b.idx for b in holders if b.tier == HOST}
    host_used = set(range(host.num_blocks)) - set(host._free)
    h_leaked = sorted(host_used - host_live)
    h_phantom = sorted(host_live - host_used)
    if h_leaked:
        errs.append(f"host blocks leaked (allocated, no holder): {h_leaked}")
    if h_phantom:
        errs.append(f"host blocks held but marked free: {h_phantom}")

    reserved = sum(a.reserved_left for a in engine.slots if a is not None)
    if reserved != pool.num_reserved:
        errs.append(f"reservation ledger {pool.num_reserved} != "
                    f"sum of slot reservations {reserved}")

    # recurrent-state slab (SSM / hybrid families): every allocated slot must
    # be some active request's state handle, every parked state must sit in
    # the slab's host tier, and refcounts must match holder counts: the same
    # contract as blocks, at slot granularity
    state_store = getattr(engine, "state_store", None)
    if state_store is not None:
        sholders: Dict[object, int] = {}
        for a in engine.slots:
            if a is not None and getattr(a, "state", None) is not None:
                sholders[a.state] = sholders.get(a.state, 0) + 1
        for parked in engine._parked.values():
            if getattr(parked, "state", None) is not None:
                sholders[parked.state] = sholders.get(parked.state, 0) + 1
        for b, n in sholders.items():
            if b.refcount != n:
                errs.append(f"state {b.tier} slot {b.idx}: refcount "
                            f"{b.refcount} != {n} holder reference(s)")
        spool = state_store.device.pool
        slab_live = {b.idx for b in sholders if b.tier == DEVICE}
        slab_used = set(range(1, spool.num_blocks)) - set(spool._free)
        leaked = sorted(slab_used - slab_live)
        phantom = sorted(slab_live - slab_used)
        if leaked:
            errs.append(f"state slots leaked (allocated, no holder): {leaked}")
        if phantom:
            errs.append(f"state slots held but marked free: {phantom}")
        shost = state_store.host
        sh_live = {b.idx for b in sholders if b.tier == HOST}
        sh_used = set(range(shost.num_blocks)) - set(shost._free)
        h_leaked = sorted(sh_used - sh_live)
        h_phantom = sorted(sh_live - sh_used)
        if h_leaked:
            errs.append(f"host state slots leaked (allocated, no holder): "
                        f"{h_leaked}")
        if h_phantom:
            errs.append(f"host state slots held but marked free: {h_phantom}")
        if spool.num_reserved:
            errs.append(f"state slab has {spool.num_reserved} reserved slots "
                        "(slots are never reserved)")
    return errs
