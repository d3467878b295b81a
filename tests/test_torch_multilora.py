"""Multi-LoRA serving on the port's engine: N tenants over one shared paged
base, on the CPU.

The engine contracts of ``tests/test_multilora.py``: base requests are
bitwise the adapter-free engine's even with tenants loaded, an all-base
dispatch runs no LoRA op at all (counted at ``kernels.ops``, where the
model calls the fused delta kernel, and the shrink and expand besides), a
rank-0 tenant gives the base
tokens, a real tenant diverges, one prompt under two tenants is never
cross-served from the prefix registry, and every terminal path returns the
request's adapter ref; plus a full store that rejects a new tenant without
touching a live one.  The cross-framework gate: on the reduced f32
qwen3-0.6b with bridged weights and adapters synthesized from the same
names, a mixed-tenant workload gives the JAX engine's greedy tokens.
"""
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params
from repro_torch.kernels import ops
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(1)

PROMPT = [3, 5, 7, 11, 13, 17, 19, 23]


@pytest.fixture(scope="module")
def setup():
    return bridged_params("qwen3-0.6b")


@pytest.fixture
def lora_calls(monkeypatch):
    """Calls of the shrink, expand and fused delta ops, by name."""
    calls = {"shrink": 0, "expand": 0, "delta": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper
    monkeypatch.setattr(ops, "lora_shrink", counted("shrink", ops.lora_shrink))
    monkeypatch.setattr(ops, "lora_expand", counted("expand", ops.lora_expand))
    monkeypatch.setattr(ops, "lora_delta", counted("delta", ops.lora_delta))
    return calls


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("fault_injector", False)
    return ServeEngine(cfg, params, **kw)


def _run(eng, *reqs):
    for r in reqs:
        eng.submit(r)
    for _ in range(800):
        worked = eng.step()
        assert eng.check_invariants() == []
        if not worked:
            break
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


# ---------------------------------------------------------------------------
# identity contracts
# ---------------------------------------------------------------------------

def test_base_request_bitwise_identical_with_adapters_loaded(setup,
                                                             lora_calls):
    """adapter_id=None is the adapter-free engine, token for token, on an
    engine with a tenant resident and pinned, and runs no LoRA op."""
    _, cfg, _, params = setup
    [want] = _run(_engine(cfg, params),
                  Request(rid=0, prompt=list(PROMPT), max_new=6))
    eng = _engine(cfg, params)
    eng.load_adapter("tenant-a")
    eng.adapters.pin("tenant-a")
    [got] = _run(eng, Request(rid=0, prompt=list(PROMPT), max_new=6))
    assert got == want
    assert lora_calls == {"shrink": 0, "expand": 0, "delta": 0}


def test_all_base_batch_runs_no_lora_ops(setup, lora_calls):
    """An all-base dispatch carries no descriptor and calls no LoRA op; a
    mixed one calls the fused delta op once per adapted projection per
    layer (and neither the shrink nor the expand on its own), and its
    base row's logits equal the all-base dispatch's exactly."""
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    slot = eng.load_adapter("tenant-a")
    assert eng._lora_descriptor(np.asarray([-1, -1], np.int32)) is None
    assert eng._lora_descriptor(np.asarray([-1, slot], np.int32)) is not None
    m = eng.max_blocks_per_seq
    tables = torch.zeros((2, m), dtype=torch.int32)
    tables[0, 0], tables[1, 0] = 1, 2
    batch = {"token": torch.tensor([[5], [9]], dtype=torch.int32),
             "block_tables": tables,
             "seq_lens": torch.ones((2,), dtype=torch.int32),
             "lora_block_out": eng.lora_block_out}

    def decode(b):
        cache = {k: v.clone() for k, v in eng.cache.items()}
        return eng.fns.decode_paged(params, cache, b)[1]

    base = decode(batch)
    assert lora_calls == {"shrink": 0, "expand": 0, "delta": 0}
    mixed = decode(dict(batch, lora=eng._lora_descriptor(
        np.asarray([slot, -1], np.int32))))
    per = len(eng.adapters.projs) * cfg.n_layers
    assert lora_calls == {"shrink": 0, "expand": 0, "delta": per}
    assert torch.equal(mixed[1], base[1])
    assert not torch.equal(mixed[0], base[0])


def test_rank0_adapter_is_token_identical_to_base(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    eng.load_adapter("null-tenant", rank=0)
    base, adapted = _run(
        eng, Request(rid=0, prompt=list(PROMPT), max_new=6),
        Request(rid=1, prompt=list(PROMPT), max_new=6,
                adapter_id="null-tenant"))
    assert adapted == base


def test_real_adapter_diverges_from_base(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    eng.load_adapter("tenant-a")
    base, adapted = _run(
        eng, Request(rid=0, prompt=list(PROMPT), max_new=8),
        Request(rid=1, prompt=list(PROMPT), max_new=8,
                adapter_id="tenant-a"))
    assert adapted != base
    per = eng.metrics().per_tenant
    assert per == {"base": {"tokens": 8, "requests_finished": 1},
                   "tenant-a": {"tokens": 8, "requests_finished": 1}}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "nemotron-4-15b"])
def test_paged_lora_logits_match_jax(arch):
    """The paged model functions with a ``lora`` descriptor (a prompt chunk
    under one tenant, then decode steps with a tenant row beside a base
    row) against the JAX functions on the same weights and slabs: the
    SwiGLU (gate/up/down) and the squared-ReLU (wi/down) FFN."""
    import jax.numpy as jnp
    from _torch_parity import LOGITS_TOL, assert_close
    from repro.models import transformer as jtf
    from repro.serve.adapters import AdapterStore as JAdapterStore
    from repro_torch.models import transformer as ttf
    from repro_torch.serve.adapters import AdapterStore
    jcfg, cfg, jparams, params = bridged_params(arch, seed=2)
    jst, tst = JAdapterStore(jcfg), AdapterStore(cfg, device="cpu")
    for st in (jst, tst):
        st.load("tenant-a")
        st.load("tenant-b", rank=16)
    slot_b = tst.load("tenant-b")

    def lora(ids):
        return ({"ids": jnp.asarray(ids, jnp.int32), "slabs": jst.slabs()},
                {"ids": torch.tensor(ids, dtype=torch.int32),
                 "slabs": tst.slabs()})
    bs, c = 4, 4
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    jcache = jtf.make_paged_cache(jcfg, 8, bs, jnp.float32)
    tcache = ttf.make_paged_cache(cfg, 8, bs, torch.float32, "cpu")
    for row, slot in ((0, slot_b), (1, -1)):
        jl, tl = lora([slot])
        jbatch = {"tokens": jnp.asarray([PROMPT[:c]], jnp.int32),
                  "block_table": jnp.asarray(tables[row:row + 1]),
                  "start": jnp.int32(0), "prompt_len": jnp.int32(c)}
        tbatch = {"tokens": torch.tensor([PROMPT[:c]]),
                  "block_table": torch.from_numpy(tables[row:row + 1]),
                  "start": 0, "prompt_len": c, "lora_block_out": 16}
        if slot >= 0:
            jbatch["lora"], tbatch["lora"] = jl, tl
        jcache, jlog = jtf.lm_prefill_chunk(jcfg, jparams, jcache, jbatch,
                                            m_used=1)
        tcache, tlog = ttf.lm_prefill_chunk(cfg, params, tcache, tbatch,
                                            m_used=1)
        assert_close(tlog, np.asarray(jlog), LOGITS_TOL, f"chunk row {row}")
    jl, tl = lora([slot_b, -1])
    for i, tok in enumerate(PROMPT[c:c + 2]):
        batch = {"token": np.asarray([[tok], [tok]], np.int32),
                 "block_tables": tables,
                 "seq_lens": np.asarray([c + i, c + i], np.int32)}
        jcache, jlog = jtf.lm_decode_step_paged(
            jcfg, jparams, jcache,
            dict({k: jnp.asarray(v) for k, v in batch.items()}, lora=jl))
        tcache, tlog = ttf.lm_decode_step_paged(
            cfg, params, tcache,
            dict({k: torch.from_numpy(v) for k, v in batch.items()},
                 lora=tl, lora_block_out=16))
        assert_close(tlog, np.asarray(jlog), LOGITS_TOL, f"decode {i}")


# ---------------------------------------------------------------------------
# prefix isolation
# ---------------------------------------------------------------------------

def test_same_prompt_different_adapters_never_cross_serve(setup):
    """Tenant B asks tenant A's exact prompt: B re-prefills from scratch and
    produces what a fresh single-tenant engine produces; A again reuses its
    own registered prefix."""
    _, cfg, _, params = setup
    eng = _engine(cfg, params, max_batch=1, num_blocks=24,
                  prefix_cache_blocks=6)
    eng.load_adapter("tenant-a")
    eng.load_adapter("tenant-b")
    [out_a] = _run(eng, Request(rid=0, prompt=list(PROMPT), max_new=5,
                                adapter_id="tenant-a"))
    eng.reset_metrics()
    [out_b] = _run(eng, Request(rid=1, prompt=list(PROMPT), max_new=5,
                                adapter_id="tenant-b"))
    m = eng.metrics()
    assert m.re_prefill_avoided == 0 and m.shared_blocks == 0

    ref = _engine(cfg, params, max_batch=1)
    ref.load_adapter("tenant-b")
    [want_b] = _run(ref, Request(rid=0, prompt=list(PROMPT), max_new=5,
                                 adapter_id="tenant-b"))
    assert out_b == want_b and out_b != out_a

    eng.reset_metrics()
    [out_a2] = _run(eng, Request(rid=2, prompt=list(PROMPT), max_new=5,
                                 adapter_id="tenant-a"))
    m = eng.metrics()
    assert m.re_prefill_avoided > 0 and m.shared_blocks > 0
    assert out_a2 == out_a


# ---------------------------------------------------------------------------
# terminal paths return the adapter ref
# ---------------------------------------------------------------------------

def test_expired_request_decrefs_adapter(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    eng.load_adapter("tenant-a")
    req = Request(rid=0, prompt=list(PROMPT), max_new=20,
                  adapter_id="tenant-a", deadline_ms=0.01)
    eng.submit(req)
    assert eng.adapters.refcount("tenant-a") == 1
    eng.run_until_done(max_steps=200)
    assert req.done and req.finish_reason == "expired"
    assert eng.adapters.refcount("tenant-a") == 0
    assert eng.check_invariants() == []


def test_quarantined_request_decrefs_once(setup):
    """A step crash quarantines one of two requests of one tenant: its ref
    goes back, the other's stays until it retires."""
    from repro_torch.serve.faults import FaultInjector
    _, cfg, _, params = setup
    eng = _engine(cfg, params,
                  fault_injector=FaultInjector.parse("step:exc=1"))
    eng.load_adapter("tenant-a")
    reqs = [Request(rid=i, prompt=list(PROMPT[:4 + i]), max_new=3,
                    adapter_id="tenant-a") for i in range(2)]
    for r in reqs:
        eng.submit(r)
    assert eng.adapters.refcount("tenant-a") == 2
    eng.step_guarded()
    assert sorted(r.finish_reason for r in reqs) == ["", "error"]
    assert eng.adapters.refcount("tenant-a") == 1
    while eng.step_guarded():
        assert eng.check_invariants() == []
    assert sorted(r.finish_reason for r in reqs) == ["error", "length"]
    assert eng.adapters.refcount("tenant-a") == 0


def test_preempted_tenant_replays_without_double_counting(setup,
                                                          monkeypatch):
    """Preemption that drops a tenant's KV and restarts it from the prompt
    takes its delivered tokens back off the tenant's tally; the replay
    keeps its adapter ref and returns it once at retire."""
    monkeypatch.setenv("REPRO_KV_SWAP", "0")
    _, cfg, _, params = setup
    eng = _engine(cfg, params, num_blocks=7, admission="optimistic")
    eng.load_adapter("tenant-a")
    reqs = [Request(rid=i, prompt=[3, 5, 7, 11 + i], max_new=16,
                    adapter_id="tenant-a") for i in range(2)]
    _run(eng, *reqs)
    m = eng.metrics()
    assert m.preemptions >= 1
    assert all(len(r.out) == 16 for r in reqs)
    assert m.per_tenant == {"tenant-a": {"tokens": 32,
                                         "requests_finished": 2}}
    assert eng.adapters.refcount("tenant-a") == 0


def test_unknown_adapter_is_rejected_not_crashed(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    req = Request(rid=0, prompt=list(PROMPT), max_new=4, adapter_id="nope")
    eng.submit(req)
    assert req.rejected and "unknown adapter" in req.reject_reason
    assert eng.check_invariants() == []


def test_full_store_rejects_the_new_tenant(setup, monkeypatch):
    """One device slot, held by an in-flight tenant: a request for a tenant
    evicted to the host tier is rejected, the live tenant is untouched and
    finishes, and afterwards the evicted tenant is reloaded from the host
    tier and served."""
    monkeypatch.setenv("REPRO_LORA_MAX_ADAPTERS", "1")
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    eng.load_adapter("tenant-b")
    eng.load_adapter("tenant-a")         # evicts b to the host tier
    live = Request(rid=0, prompt=list(PROMPT), max_new=4,
                   adapter_id="tenant-a")
    eng.submit(live)
    late = Request(rid=1, prompt=list(PROMPT), max_new=4,
                   adapter_id="tenant-b")
    eng.submit(late)
    assert late.rejected and "adapter store full" in late.reject_reason
    assert eng.adapters.loaded() == ["tenant-a"]
    _run(eng)
    assert live.finish_reason == "length"
    again = Request(rid=2, prompt=list(PROMPT), max_new=4,
                    adapter_id="tenant-b")
    [out] = _run(eng, again)
    assert len(out) == 4 and eng.adapters.loaded() == ["tenant-b"]
    m = eng.metrics()
    assert m.adapter_evictions == 2 and m.adapter_host_reloads >= 1


# ---------------------------------------------------------------------------
# cross-framework gate
# ---------------------------------------------------------------------------

def _mixed_workload(request_cls, vocab):
    """Nine greedy requests, base and two tenants in turn, every prompt
    opening with one 8-token prefix: the first wave holds one of each, and
    later requests may adopt only their own tenant's registered prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(1, vocab, size=8).tolist()
    tenants = [None, "tenant-a", "tenant-b"]
    reqs = []
    for i in range(9):
        tail = rng.integers(1, vocab, size=int(rng.integers(2, 9))).tolist()
        reqs.append(request_cls(rid=i, prompt=shared + tail,
                                max_new=int(rng.integers(3, 9)),
                                adapter_id=tenants[i % 3]))
    return reqs


def test_mixed_tenants_match_jax_engine(setup):
    """Base rows and two tenants in shared dispatches, with a shared prompt
    prefix: the port's greedy tokens and per-tenant tallies equal the JAX
    engine's request by request."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    jcfg, cfg, jparams, params = setup
    shape = dict(max_batch=3, max_len=48, block_size=4, num_blocks=64,
                 prefix_cache_blocks=16)
    eng = _engine(cfg, params, **shape)
    jeng = JServeEngine(jcfg, jparams, plan_kernels=False, mesh=False,
                        fault_injector=False, **shape)
    for e in (eng, jeng):
        e.load_adapter("tenant-a")
        e.load_adapter("tenant-b")
    reqs = _mixed_workload(Request, cfg.vocab)
    _run(eng, *reqs)
    jreqs = _mixed_workload(JRequest, cfg.vocab)
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    m, jm = eng.metrics(), jeng.metrics()
    assert m.per_tenant == jm.per_tenant
    assert m.adapter_device_bytes == jm.adapter_device_bytes > 0
    assert m.shared_blocks == jm.shared_blocks
    assert m.re_prefill_avoided == jm.re_prefill_avoided > 0
    assert {r.adapter_id for r in reqs if r.out != _base_out(eng, r)} \
        == {"tenant-a", "tenant-b"}


def _base_out(eng, req):
    """``req``'s prompt served as a base request on ``eng``."""
    r = Request(rid=100 + req.rid, prompt=list(req.prompt),
                max_new=req.max_new)
    _run(eng, r)
    return r.out
