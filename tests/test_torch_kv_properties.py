"""The port's tiered stores under random interleavings (the port of
``tests/test_kv_properties.py``): alloc / fork / CoW / swap / free over a
stub-plane ``KVStore`` + ``StateSlab`` pair (the block pool and the
recurrent-state slab an ssm/hybrid engine holds side by side), with the
port's ``check_kv_invariants`` run after EVERY operation through an
engine-shaped view of the stores.  No refcount may leak and no ledger may
drift at any interleaving.  A deterministic seeded driver runs everywhere;
the hypothesis-driven one runs where hypothesis is installed."""
import types

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch.serve.faults import (FaultInjector, InjectedFault,
                                      check_kv_invariants)
from repro_torch.serve.kv_store import (DEVICE, HOST, BlockTable, DeviceTier,
                                        HostTier, KVStore, SlabDeviceView,
                                        StateSlab)
from repro_torch.serve.paged_cache import BlockPool

torch.set_num_threads(1)

BLOCK_SIZE = 4
N_BLOCKS = 9       # usable device blocks + null
N_SLOTS = 6        # state slab slots + null
N_HOST = 5         # deliberately tight: swap guards must actually bite
N_OPS = 8


def _stub_stores():
    """A KVStore over a stub block plane and a StateSlab over a stub slot
    plane of the SAME base tier: the production shape (one shared cache,
    two allocators over different axes), minus the tensors."""
    def _copy(cache, src, dst):
        c = dict(cache)
        c[dst] = c.get(src)
        return c

    def _read(cache, idx):
        return cache.get(idx, f"uninit{idx}")

    def _write(cache, idx, data):
        c = dict(cache)
        c[idx] = data
        return c

    base = DeviceTier({}, BlockPool(N_BLOCKS, BLOCK_SIZE),
                      copy_block=_copy, read_block=_read, write_block=_write)
    store = KVStore(base, HostTier(N_HOST))
    # the slab view indexes slots of the same cache dict: offset the ids so
    # block writes and slot writes can never collide in the stub plane
    off = 1000

    def _scopy(cache, src, dst):
        return _copy(cache, off + src, off + dst)

    def _sread(cache, idx):
        return _read(cache, off + idx)

    def _swrite(cache, idx, data):
        return _write(cache, off + idx, data)

    slab = StateSlab(SlabDeviceView(base, BlockPool(N_SLOTS, 1),
                                    _scopy, _sread, _swrite),
                     HostTier(N_HOST))
    return store, slab


class _Seq:
    """One request's holdings: a block list + at most one state slot."""

    def __init__(self):
        self.blocks = []
        self.state = None
        self.parked = False


def _engine_view(store, slab, seqs):
    """Engine-shaped namespace over the model, so the REAL auditor walks our
    stub world: live seqs are slots, parked seqs are ``_parked`` entries."""
    slots, parked = [], {}
    for rid, s in seqs.items():
        if s.parked:
            parked[rid] = types.SimpleNamespace(blocks=list(s.blocks),
                                                state=s.state)
        else:
            slots.append(types.SimpleNamespace(
                table=BlockTable(BLOCK_SIZE, blocks=list(s.blocks)),
                reserved_left=0, state=s.state))
    return types.SimpleNamespace(slots=slots, _parked=parked, store=store,
                                 pool=store.device.pool, state_store=slab)


def _drive(ops):
    """Interpret (op, a, b) triples against the model; inapplicable ops are
    no-ops (the audit still runs).  Returns the final (store, slab)."""
    store, slab = _stub_stores()
    seqs, next_rid = {}, 0

    def pick(candidates, a):
        return candidates[a % len(candidates)] if candidates else None

    for op, a, b in ops:
        op %= N_OPS
        live = [s for s in seqs.values() if not s.parked]
        if op == 0:                                   # grow a block table
            s = pick(live, a)
            if s is None:
                s = seqs[next_rid] = _Seq()
                next_rid += 1
            if store.device.pool.num_free > 0:
                s.blocks.append(store.alloc())
                store.device.cache = {**store.device.cache,
                                      s.blocks[-1].idx: f"blk{a}.{b}"}
        elif op == 1:                                 # claim a state slot
            s = pick([s for s in live if s.state is None], a)
            if s is not None and slab.device.pool.num_free > 0:
                s.state = slab.alloc()
                slab.device.write(s.state.idx, f"st{a}.{b}")
        elif op == 2:                                 # fork a prefix (+state)
            src = pick([s for s in live if s.blocks], a)
            if src is not None:
                child = _Seq()
                k = 1 + b % len(src.blocks)
                child.blocks = list(store.fork(src.blocks[:k]))
                if src.state is not None and b % 2:
                    child.state = slab.fork([src.state])[0]
                seqs[next_rid] = child
                next_rid += 1
        elif op == 3:                                 # CoW a shared block
            cands = [(s, i) for s in live for i, blk in enumerate(s.blocks)
                     if blk.shared and blk.tier == DEVICE]
            hit = pick(cands, a)
            if hit is not None and store.device.pool.num_free > 0:
                s, i = hit
                s.blocks[i] = store.cow_into(s.blocks[i], store.alloc())
        elif op == 4:                                 # CoW shared state
            cands = [s for s in live
                     if s.state is not None and s.state.shared]
            s = pick(cands, a)
            if s is not None and slab.device.pool.num_free > 0:
                s.state = slab.cow_into(s.state, slab.alloc())
        elif op == 5:                                 # park (preempt-by-swap)
            s = pick([s for s in live if s.blocks or s.state is not None], a)
            ok = s is not None and store.can_swap_out(s.blocks)
            if ok and s.state is not None:
                ok = slab.can_swap_out([s.state])
            if ok:
                if s.state is not None:
                    s.state = slab.swap_out(s.state)
                s.blocks = [store.swap_out(blk) for blk in s.blocks]
                s.parked = True
        elif op == 6:                                 # restore a parked seq
            s = pick([s for s in seqs.values() if s.parked], a)
            if s is not None:
                n_host = sum(1 for blk in s.blocks if blk.tier == HOST)
                ok = store.device.pool.num_free >= n_host
                if ok and s.state is not None and s.state.tier == HOST:
                    ok = slab.device.pool.num_free > 0
                if ok:
                    if s.state is not None and s.state.tier == HOST:
                        s.state = slab.swap_in(s.state, slab.alloc())
                    s.blocks = [store.swap_in(blk, store.alloc())
                                if blk.tier == HOST else blk
                                for blk in s.blocks]
                    s.parked = False
        elif op == 7:                                 # retire / cancel
            rid = pick(sorted(seqs), a)
            if rid is not None:
                s = seqs.pop(rid)
                for blk in s.blocks:
                    store.decref(blk)
                if s.state is not None:
                    slab.decref(s.state)
        errs = check_kv_invariants(_engine_view(store, slab, seqs))
        assert not errs, f"after op {(op, a, b)}: {errs}"

    # drain: every holder gone -> every ledger empty, nothing leaked
    for s in seqs.values():
        for blk in s.blocks:
            store.decref(blk)
        if s.state is not None:
            slab.decref(s.state)
    assert store.device.pool.num_used == 0
    assert store.host.num_used == 0
    assert slab.device.pool.num_used == 0
    assert slab.host.num_used == 0
    return store, slab


@given(st.lists(st.tuples(st.integers(0, N_OPS - 1), st.integers(0, 31),
                          st.integers(0, 31)),
                min_size=1, max_size=80))
@settings(max_examples=80, deadline=None)
def test_random_interleavings_hold_invariants(ops):
    """Any interleaving of alloc/fork/CoW/park/restore/free over both tiers
    keeps every refcount equal to its holder count and every pool ledger
    consistent — checked after every operation, then drained to zero."""
    _drive(ops)


@pytest.mark.parametrize("seed", range(12))
def test_seeded_interleavings_hold_invariants(seed):
    """The same interpreter under a deterministic PRNG schedule: runs in
    every environment, hypothesis installed or not."""
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, N_OPS)), int(rng.integers(0, 32)),
            int(rng.integers(0, 32)))
           for _ in range(120)]
    _drive(ops)


def test_slab_swap_round_trips_state_payload():
    """StateSlab parks carry the actual state bytes: slot payloads survive
    the host round trip and CoW copies diverge without back-propagating."""
    _, slab = _stub_stores()
    a = slab.alloc()
    slab.device.write(a.idx, "h0")
    (a2,) = slab.fork([a])
    assert a2 is a and a.shared
    mine = slab.cow_into(a, slab.alloc())
    assert slab.device.read(mine.idx) == "h0"
    slab.device.write(mine.idx, "h1")
    assert slab.device.read(a.idx) == "h0", "CoW must not leak back"
    h = slab.swap_out(mine)
    assert h.tier == HOST and slab.swapped_out == 1
    back = slab.swap_in(h, slab.alloc())
    assert str(slab.device.read(back.idx)) == "h1"
    for blk in (a, back):
        slab.decref(blk)
    assert slab.device.pool.num_used == 0 and slab.host.num_used == 0


def test_slab_fault_sites_are_their_own():
    """The slab's chaos sites are separate from the block pool's: a
    ``slab_alloc`` / ``slab_swap_out`` rule fires on slab traffic only and
    leaves both tiers consistent."""
    store, slab = _stub_stores()
    inj = FaultInjector.parse("slab_alloc:exc=1,slab_swap_out:exc=1")
    for x in (store, store.device.pool, slab, slab.device.pool):
        x.fault_injector = inj
    blk = store.alloc()                     # the block pool does not fire
    with pytest.raises(InjectedFault, match="slab_alloc"):
        slab.alloc()
    s = slab.alloc()
    with pytest.raises(InjectedFault, match="slab_swap_out"):
        slab.swap_out(s)
    assert s.tier == DEVICE and slab.device.pool.num_used == 1
    h = slab.swap_out(s)
    assert h.tier == HOST and slab.device.pool.num_used == 0
    slab.decref(h)
    store.decref(blk)
    assert slab.host.num_used == 0 and store.device.pool.num_used == 0
