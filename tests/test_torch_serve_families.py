"""The port's paged engine serving the stateful families (the port of
``tests/test_serve_families.py``): the ssm (falcon-mamba-7b) and hybrid
(zamba2-2.7b) reduced configs through the SAME ``ServeEngine``, each run
token-identical to the family's dense ``prefill`` + ``decode_step`` oracle
over greedy and sampled decoding, with chunked prefill on and off (as is
the moe family, olmoe-1b-7b, at a capacity factor where no token drops:
expert capacity is per call, so at its native factor chunking changes
which tokens drop), and
across a forced preemption-by-swap that parks the recurrent state on the
StateSlab's host tier mid-generation; and the cross-framework gate: greedy
tokens equal the JAX engine's on the same bridged weights."""
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine

torch.set_num_threads(1)

FAMILY_ARCHS = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b"}
# the families held to their dense oracle: the stateful ones and moe
ORACLE_ARCHS = dict(FAMILY_ARCHS, moe="olmoe-1b-7b")
# a capacity factor at which no token of these prompts drops (capacity >=
# tokens: factor >= n_experts), as tests/test_models_smoke.py uses
MOE_NO_DROP = 16.0
MAX_LEN = 48
BLOCK_SIZE = 8


@pytest.fixture(scope="module")
def zoo():
    """(JAX cfg, port cfg, JAX params, port params) per family, on the same
    weights; moe's configs at the no-drop factor."""
    import dataclasses
    out = {fam: bridged_params(arch) for fam, arch in ORACLE_ARCHS.items()}
    out["moe"] = tuple(
        dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=MOE_NO_DROP)) if i < 2 else c
        for i, c in enumerate(out["moe"]))
    return out


def _oracle(cfg, params, req):
    """Dense single-request reference: whole-prompt prefill, one contiguous
    cache, per-token decode, the engine's own stateless sampler."""
    from repro_torch.models import build_model
    fns = build_model(cfg, "cpu")
    cache, logits = fns.prefill(params, {"tokens": torch.tensor([req.prompt])})
    if cfg.family in ("hybrid", "moe"):
        big = fns.make_cache(1, MAX_LEN)
        for k in ("k", "v"):
            big[k][:, :, :len(req.prompt)] = cache[k]
        cache = dict(big, ssm=cache["ssm"]) if "ssm" in cache else big
    out = [ServeEngine._sample(logits[0].numpy(), req.sampling, 0)]
    cur = len(req.prompt)
    for _ in range(req.max_new - 1):
        batch = {"token": torch.tensor([[out[-1]]]), "cur_len": cur}
        cache, lg = fns.decode_step(params, cache, batch)
        out.append(ServeEngine._sample(lg[0].numpy(), req.sampling,
                                       len(out)))
        cur += 1
    return out


def _requests(cfg, sampled: bool):
    """Three requests: one short (a single chunk), one crossing a block
    boundary, one long enough for several prefill chunks even at the
    engine's scan-rounded chunk size."""
    rng = np.random.default_rng(7)
    reqs = []
    for i, plen in enumerate([3, 9, 17]):
        sp = SamplingParams(temperature=0.8, top_k=40, seed=100 + i) \
            if sampled else SamplingParams()
        prompt = rng.integers(1, cfg.vocab, size=plen).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new=5, sampling=sp))
    return reqs


def _run_checked(eng):
    while eng.step():
        assert eng.check_invariants() == []
    return list(eng.finished)


@pytest.mark.parametrize("family", sorted(ORACLE_ARCHS))
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["whole-prompt", "chunked-prefill"])
def test_family_matches_dense_oracle(zoo, family, sampled, chunked):
    """(family x sampling x prefill chunking): continuous batching through
    the paged engine is token-identical to the dense oracle in every cell;
    the chunk size is rounded up to the scan granule for stateful
    families.  A drained engine holds no slab slot, and the attention-free
    family never allocates a KV block.  The moe family (no slab, prefix
    sharing on) is held at its no-drop factor."""
    _, cfg, _, params = zoo[family]
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      block_size=BLOCK_SIZE, fault_injector=False,
                      prefill_chunk_tokens=4 if chunked else MAX_LEN)
    if family == "moe":
        assert eng.state_store is None
    else:
        assert eng.prefill_chunk_tokens % cfg.ssm.chunk == 0
        assert eng.store.prefix_cache_blocks == 0
    reqs = _requests(cfg, sampled)
    for r in reqs:
        eng.submit(r)
    assert len(_run_checked(eng)) == len(reqs)
    for r in reqs:
        assert r.out == _oracle(cfg, params, r), \
            f"{family} rid={r.rid} diverged from its dense oracle"
    if family == "moe":
        assert eng.pool.peak_used > 0
        return
    assert eng.state_store.device.pool.num_used == 0
    assert eng.state_store.device.pool.peak_used >= 1
    if family == "ssm":
        assert eng.pool.peak_used == 0 and eng.kernel_plan is None
    else:
        assert eng.pool.peak_used > 0


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_preemption_by_swap_resumes_slab_state(zoo, family):
    """Mid-generation preemption parks the victim's recurrent state on the
    StateSlab's host tier (plus its KV blocks for the hybrid), and the
    resumed request finishes token-identically."""
    _, cfg, _, params = zoo[family]
    eng = ServeEngine(cfg, params, max_batch=3, max_len=MAX_LEN,
                      block_size=BLOCK_SIZE, fault_injector=False)
    assert eng.swap_enabled
    reqs = _requests(cfg, sampled=True)
    for r in reqs:
        eng.submit(r)
    forced_rid = None
    while eng.step():
        assert eng.check_invariants() == []
        if forced_rid is not None:
            continue
        mid = [s for s in eng.slots if s is not None and len(s.req.out) >= 2]
        if mid:
            victim = max(mid, key=lambda s: len(s.req.out))
            eng._requeue(victim)
            forced_rid = victim.req.rid
            parked = eng._parked[forced_rid]
            assert parked.state is not None and parked.state.tier == "host"
            assert eng.check_invariants() == []
    assert forced_rid is not None, "no request was ever mid-generation"
    m = eng.metrics()
    assert m.preemptions >= 1
    assert m.swap_out_blocks >= 1 and m.swap_in_blocks >= 1
    for r in reqs:
        assert r.out == _oracle(cfg, params, r), \
            f"{family} rid={r.rid} changed tokens across preemption-by-swap"
    assert eng.state_store.device.pool.num_used == 0
    assert eng.state_store.host.num_used == 0


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_release_paths_free_the_slab_slot(zoo, family):
    """Quarantine of an active request and expiry of a queued one both give
    its slab slot back; the swap knob off drops and restarts instead of
    parking."""
    _, cfg, _, params = zoo[family]
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      block_size=BLOCK_SIZE, fault_injector=False)
    reqs = _requests(cfg, sampled=False)
    for r in reqs:
        eng.submit(r)
    eng.step()
    live = [s for s in eng.slots if s is not None]
    assert live and all(s.state is not None for s in live)
    eng._quarantine(live[0].req.rid, "test")
    assert eng.check_invariants() == []
    assert eng.state_store.device.pool.num_used == len(live) - 1
    eng.queue[-1]._deadline_at = 1e-9           # long past
    eng._reap_deadlines()
    _run_checked(eng)
    assert eng.state_store.device.pool.num_used == 0
    assert len(eng.errored) == 1 and len(eng.expired) == 1


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_adapter_requests_are_rejected(zoo, family):
    """The stateful families' layers apply no LoRA: a request that names an
    adapter, even a loaded one, is rejected at submit with a reason, takes
    no adapter slot, and base requests beside it are served as usual."""
    _, cfg, _, params = zoo[family]
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                      block_size=BLOCK_SIZE, fault_injector=False)
    eng.load_adapter("tenant-a")
    reqs = _requests(cfg, sampled=False)
    reqs[0].adapter_id = "tenant-a"
    for r in reqs:
        eng.submit(r)
    assert reqs[0].rejected and reqs[0].done
    assert "dense family only" in reqs[0].reject_reason
    assert eng.adapters.refcount("tenant-a") == 0
    done = _run_checked(eng)
    assert sorted(r.rid for r in done) == [1, 2]
    assert eng.state_store.device.pool.num_used == 0


def test_greedy_tokens_equal_the_jax_engine(zoo):
    """Both families: the port's engine and the JAX engine, on the same
    bridged weights and chunk size, emit the same greedy tokens for every
    request, and prefill the same number of prompt tokens."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    for family in sorted(FAMILY_ARCHS):
        jcfg, cfg, jparams, params = zoo[family]
        kw = dict(max_batch=2, max_len=MAX_LEN, block_size=BLOCK_SIZE,
                  prefill_chunk_tokens=4)
        eng = ServeEngine(cfg, params, fault_injector=False, **kw)
        reqs = _requests(cfg, sampled=False)
        for r in reqs:
            eng.submit(r)
        _run_checked(eng)
        jeng = JServeEngine(jcfg, jparams, plan_kernels=False, mesh=False,
                            fault_injector=False, **kw)
        jreqs = [JRequest(rid=r.rid, prompt=list(r.prompt),
                          max_new=r.max_new) for r in reqs]
        for r in jreqs:
            jeng.submit(r)
        jeng.run_until_done()
        assert [r.out for r in reqs] == [r.out for r in jreqs], family
        assert eng.metrics().prefill_tokens == jeng.metrics().prefill_tokens
        assert eng.prefill_chunk_tokens == jeng.prefill_chunk_tokens


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS.values()))
def test_serve_cli_on_cpu(arch, capsys):
    """``launch.serve --arch <ssm|hybrid> --device cpu --smoke`` serves the
    reduced config."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "4",
                      "--temperature", "0.7", "--top-k", "8"])
    m = eng.metrics()
    assert m.requests_finished == 3
    assert eng.state_store.device.pool.num_used == 0
    assert "device cpu" in capsys.readouterr().out
