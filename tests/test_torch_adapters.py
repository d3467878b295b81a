"""The port's AdapterStore against the contracts of ``tests/test_adapters.py``
(refcounted LRU slots over a two-tier slab: eviction order, pin and refcount
protection, ``AdapterStoreFull``, host-tier reloads, byte accounting, rank
and shape validation) and against the JAX store itself: after the same
load, evict and reload sequence both stores hold the same slabs, exactly,
in f32."""
import numpy as np
import pytest
import torch

from repro.serve import adapters as jadapters
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.serve.adapters import (AdapterStore, AdapterStoreFull,
                                        adapted_projections, make_lora_params,
                                        seed_for)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    return reduced_config(get_config("qwen3-0.6b"))


def _store(cfg, max_adapters=2, **kw):
    return AdapterStore(cfg, max_adapters=max_adapters, device="cpu", **kw)


def test_load_is_idempotent_and_counts(cfg):
    st = _store(cfg)
    slot = st.load("a")
    assert st.load("a") == slot          # LRU touch, not a second load
    assert st.loads == 1
    assert st.is_loaded("a") and st.known("a")
    assert st.loaded() == ["a"]
    m = st.metrics()
    assert m["adapters_loaded"] == 1 and m["adapter_loads"] == 1


def test_lru_eviction_order(cfg):
    st = _store(cfg, max_adapters=2)
    st.load("a")
    st.load("b")
    st.load("a")                         # touch: b is now least recent
    st.load("c")                         # evicts b, not a
    assert sorted(st.loaded()) == ["a", "c"]
    assert st.evictions == 1
    assert not st.is_loaded("b") and st.known("b")   # host tier keeps it


def test_refcount_blocks_eviction(cfg):
    st = _store(cfg, max_adapters=2)
    st.load("a")
    st.acquire("a")                      # in flight
    st.load("b")
    st.load("c")                         # must evict idle b, never held a
    assert st.is_loaded("a") and st.is_loaded("c")
    st.acquire("c")
    with pytest.raises(AdapterStoreFull):
        st.load("d")                     # every slot in flight
    st.release("a")
    st.load("d")                         # a is idle again -> evictable
    assert sorted(st.loaded()) == ["c", "d"]


def test_pin_blocks_eviction(cfg):
    st = _store(cfg, max_adapters=2)
    st.load("a")
    st.pin("a")
    st.load("b")
    st.load("c")                         # evicts b (a pinned, refcount 0)
    assert st.is_loaded("a")
    st.pin("c")
    with pytest.raises(AdapterStoreFull):
        st.load("d")
    st.unpin("a")
    st.load("d")
    assert sorted(st.loaded()) == ["c", "d"]


def test_host_tier_reload_skips_materialization(cfg):
    st = _store(cfg, max_adapters=1, rank_cap=8)
    st.load("a", rank=4)
    st.load("b")                         # evicts a to the host tier
    assert st.host_reloads == 0
    st.load("a")                         # back from host, same padded bytes
    assert st.host_reloads == 1
    assert st.rank_of("a") == 4          # rank survives the round trip
    assert st.metrics()["adapters_loaded"] == 1
    assert st.known("b") and not st.is_loaded("b")


def test_byte_accounting(cfg):
    st = _store(cfg, max_adapters=3)
    assert st.device_bytes() == 0        # no tenants, no slab
    st.load("a")
    dev = st.device_bytes()
    assert dev == st.per_adapter_bytes() * st.max_adapters
    assert dev == sum(t.numel() * t.element_size()
                      for sl in st.slabs().values() for t in sl.values())
    host1 = st.host_bytes()
    assert host1 > 0
    st.load("b")
    assert st.device_bytes() == dev      # slab preallocated all slots
    assert st.host_bytes() == 2 * host1  # write-through copy per adapter
    st.unload("b")
    assert st.host_bytes() == host1      # unload drops BOTH tiers


def test_rank_cap_validation(cfg):
    st = _store(cfg, rank_cap=8)
    assert st.rank_cap == 8
    with pytest.raises(ValueError, match="rank cap"):
        st.load("big", rank=9)
    assert _store(cfg, rank_cap=9).rank_cap == 16   # padded to 8
    assert _store(cfg).rank_cap == 16               # the reference's rule


def test_weight_shape_validation(cfg):
    st = _store(cfg, rank_cap=8)
    w = make_lora_params(cfg, rank=4, seed=seed_for("x"))
    proj = next(iter(adapted_projections(cfg)))
    a, b = w[proj]
    w[proj] = (a[:, :, :2], b)           # rank mismatch on one projection
    with pytest.raises(ValueError, match=proj):
        st.load("x", weights=w, rank=4)


def test_unload_refuses_in_flight(cfg):
    st = _store(cfg)
    st.load("a")
    st.acquire("a")
    with pytest.raises(RuntimeError, match="in flight"):
        st.unload("a")
    st.release("a")
    st.unload("a")
    assert not st.known("a")             # gone from both tiers
    assert st.refcount("a") == 0         # and refcount of a stranger is 0


def test_rank_zero_adapter_is_all_padding(cfg):
    st = _store(cfg, rank_cap=8)
    slot = st.load("null", rank=0)
    for sl in st.slabs().values():
        assert not sl["a"][:, slot].any() and not sl["b"][:, slot].any()


def test_synthetic_factors_are_name_deterministic(cfg):
    w1 = make_lora_params(cfg, rank=4, seed=seed_for("tenant-a"))
    w2 = make_lora_params(cfg, rank=4, seed=seed_for("tenant-a"))
    w3 = make_lora_params(cfg, rank=4, seed=seed_for("tenant-b"))
    proj = next(iter(w1))
    assert (w1[proj][0] == w2[proj][0]).all()
    assert (w1[proj][0] != w3[proj][0]).any()


def test_slabs_equal_the_jax_store_after_evict_and_reload(cfg):
    """Same config, same sequence of loads (synthesized, ragged ranks,
    explicit weights), evictions and host-tier reloads: the port's slabs
    equal the JAX store's bit for bit, and so do the projections, the
    synthesized factors and the counters."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduced_config as jreduced
    jcfg = jreduced(jget("qwen3-0.6b"))
    assert jadapters.adapted_projections(jcfg) == adapted_projections(cfg)
    assert jadapters.seed_for("tenant-a") == seed_for("tenant-a")
    jw = jadapters.make_lora_params(jcfg, 4, seed_for("x"))
    tw = make_lora_params(cfg, 4, seed_for("x"))
    assert all(np.array_equal(jw[p][i], tw[p][i]) for p in jw for i in (0, 1))

    stores = (jadapters.AdapterStore(jcfg, max_adapters=3),
              _store(cfg, max_adapters=3))
    for st in stores:
        st.load("a")
        st.load("b", rank=16, alpha=8.0)
        st.load("x", weights=make_lora_params(cfg, 4, seed_for("x")),
                rank=4)
        st.load("c", rank=0)             # evicts a (least recent)
        st.acquire("b")
        st.load("a")                     # host reload; evicts x, not b
        st.release("b")
    js, ts = stores
    assert js.loaded() == ts.loaded() == ["c", "b", "a"]
    assert js.metrics() == ts.metrics()
    for proj, sl in js.slabs().items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(ts.slabs()[proj][k].numpy(),
                                          np.asarray(sl[k]))
