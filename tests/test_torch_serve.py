"""The port's paged serve engine on the CPU: the contracts of
``tests/test_serve.py`` (oracle identity, admission, sampling, preemption by
swap, prefix sharing, KV invariants) and the cross-framework gate — the JAX
``ServeEngine`` and the port's engine, on the same bridged weights, emit
identical greedy tokens for every request of the 12-request workload."""
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine
from repro_torch.serve.paged_cache import dense_equiv_blocks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, jparams, params = bridged_params("qwen3-0.6b")
    return jcfg, cfg, jparams, params


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    return ServeEngine(cfg, params, fault_injector=False, **kw)


def _run_checked(eng, max_steps=1000):
    """run_until_done, asserting the KV invariants after every step."""
    for _ in range(max_steps):
        worked = eng.step()
        assert eng.check_invariants() == []
        if not worked:
            break
    return list(eng.finished)


def _solo_oracle(cfg, params, prompt, max_new):
    eng = _engine(cfg, params, max_batch=1, prefix_cache_blocks=0)
    r = Request(rid=0, prompt=list(prompt), max_new=max_new)
    eng.submit(r)
    eng.run_until_done()
    return r.out


def _workload(vocab):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(12):
        plen = int(rng.integers(3, 21))
        reqs.append(Request(rid=i, prompt=rng.integers(1, vocab, size=plen).tolist(),
                            max_new=int(rng.integers(4, 15))))
    return reqs


def test_engine_matches_single_request_decode(setup):
    """Chunked prefill + paged decode for one greedy request == the port's
    dense prefill + decode loop."""
    _, cfg, _, params = setup
    from repro_torch.models import build_model
    fns = build_model(cfg, "cpu")
    prompt = [3, 5, 7, 11, 13, 17, 19]
    eng = _engine(cfg, params, prefill_chunk_tokens=3)
    r = Request(rid=0, prompt=prompt, max_new=5)
    eng.submit(r)
    assert [f.rid for f in _run_checked(eng)] == [0]

    cache1, logits = fns.prefill(params, {"tokens": torch.tensor([prompt])})
    cache = fns.make_cache(1, 32)
    for k in cache:
        cache[k][:, :, :len(prompt)] = cache1[k]
    toks = [int(torch.argmax(logits[0]))]
    for i in range(4):
        cache, lg = fns.decode_step(params, cache,
                                    {"token": torch.tensor([[toks[-1]]]),
                                     "cur_len": len(prompt) + i})
        toks.append(int(torch.argmax(lg[0])))
    assert r.out == toks


def test_12_requests_match_jax_engine_and_fit_the_pool(setup):
    """The mixed workload completes under the pool bound, and its greedy
    tokens equal the JAX engine's request by request."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    jcfg, cfg, jparams, params = setup
    eng = _engine(cfg, params, max_batch=4, max_len=64, block_size=8)
    reqs = _workload(cfg.vocab)
    for r in reqs:
        eng.submit(r)
    finished = _run_checked(eng)
    assert {r.rid for r in finished} == set(range(12))
    m = eng.metrics()
    assert m.requests_finished == 12 and m.requests_rejected == 0
    assert m.tokens_per_sec > 0 and m.ttft_mean_s > 0
    assert m.peak_pool_utilization < 1.0
    assert m.dense_equiv_blocks == dense_equiv_blocks(4, 64, 8)
    assert m.peak_blocks_used < m.dense_equiv_blocks
    eng.release_prefix_cache()
    assert eng.pool.num_used == 0

    jeng = JServeEngine(jcfg, jparams, max_batch=4, max_len=64, block_size=8,
                        plan_kernels=False, mesh=False, fault_injector=False)
    jreqs = [JRequest(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
             for r in _workload(cfg.vocab)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert eng.metrics().prefill_tokens == jeng.metrics().prefill_tokens


def test_kernel_planning_matches_jax_engine_and_keeps_tokens(setup):
    """Planning is on by default: under the reference-constant record the
    port's engine compiles the same terms into the same reports, plan and
    ``pages_per_fetch`` as the JAX engine; a second engine hits the cache;
    and the greedy tokens equal an engine's with planning off (the paged
    kernel takes the plan's ``pages_per_fetch`` and does not use it)."""
    import dataclasses
    from _torch_parity import reference_hardware
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.pipeline import Compiler
    jcfg, cfg, jparams, params = setup
    ref_hw = reference_hardware()
    shape = dict(max_batch=4, max_len=64, block_size=8)
    jeng = JServeEngine(jcfg, jparams, plan_kernels=True, mesh=False,
                        fault_injector=False, **shape)
    compiler = Compiler(cache_dir=None)
    eng = _engine(cfg, params, compiler=compiler, hardware=ref_hw, **shape)
    assert set(eng.compile_reports) == set(jeng.compile_reports)
    for key, rep in jeng.compile_reports.items():
        mine = eng.compile_reports[key]
        assert (mine.baseline_cost, mine.optimized_cost, mine.buffer) == \
            (rep.baseline_cost, rep.optimized_cost, rep.buffer)
        assert not mine.cache_hit
    assert dataclasses.asdict(eng.kernel_plan) == \
        dataclasses.asdict(jeng.kernel_plan)
    assert eng.pages_per_fetch == jeng.pages_per_fetch
    again = _engine(cfg, params, compiler=compiler, hardware=ref_hw, **shape)
    assert all(r.cache_hit for r in again.compile_reports.values())
    assert compiler.stats == {"hits": 2, "misses": 2}

    planned = _engine(cfg, params, **shape)          # the H100 record
    assert planned.kernel_plan is not None and planned.pages_per_fetch >= 1
    plain = _engine(cfg, params, plan_kernels=False, **shape)
    assert plain.kernel_plan is None and plain.compile_reports == {}
    outs = []
    for e in (planned, plain):
        reqs = _workload(cfg.vocab)[:6]
        for r in reqs:
            e.submit(r)
        _run_checked(e)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_admission_rejects_oversized(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params, max_len=64, num_blocks=5)
    big = Request(rid=0, prompt=[1] * 12, max_new=12)
    toolong = Request(rid=1, prompt=[1] * 60, max_new=8)
    empty = Request(rid=3, prompt=[], max_new=4)
    nonew = Request(rid=4, prompt=[1, 2], max_new=0)
    ok = Request(rid=2, prompt=[2, 3, 4], max_new=4)
    for r in (big, toolong, empty, nonew, ok):
        eng.submit(r)
    assert [r.rid for r in _run_checked(eng)] == [2]
    assert big.rejected and "pool capacity" in big.reject_reason
    assert toolong.rejected and "max_len" in toolong.reject_reason
    assert empty.rejected and "empty" in empty.reject_reason
    assert nonew.rejected and "max_new" in nonew.reject_reason
    assert eng.metrics().requests_rejected == 4


def test_sampling_seeded_reproducible(setup):
    _, cfg, _, params = setup

    def run():
        eng = _engine(cfg, params)
        reqs = [Request(rid=i, prompt=[5, 7, 11 + i], max_new=6,
                        sampling=SamplingParams(temperature=1.0, top_k=20,
                                                seed=i))
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return [tuple(r.out) for r in reqs]
    first = run()
    assert first == run()
    assert len({t for out in first for t in out}) > 3


def _overcommitted(cfg, params):
    eng = _engine(cfg, params, num_blocks=7, admission="optimistic")
    reqs = [Request(rid=i, prompt=[3, 5, 7, 11 + i], max_new=16)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    _run_checked(eng)
    return eng, reqs


def test_optimistic_preemption_restores_from_host_and_matches_oracle(setup):
    """The pool fits each request alone but not both: the youngest is
    parked on the host tier, restored, and both still equal their solo
    oracle outputs."""
    _, cfg, _, params = setup
    eng, reqs = _overcommitted(cfg, params)
    m = eng.metrics()
    assert {r.rid for r in eng.finished} == {0, 1}
    assert m.preemptions >= 1
    assert m.swap_out_blocks > 0 and m.swap_in_blocks == m.swap_out_blocks
    assert m.re_prefill_avoided > 0
    for r in reqs:
        assert r.out == _solo_oracle(cfg, params, r.prompt, r.max_new)
    eng.release_prefix_cache()
    assert eng.pool.num_used == 0


def test_kv_swap_knob_off_restarts_from_prompt(setup, monkeypatch):
    monkeypatch.setenv("REPRO_KV_SWAP", "0")
    _, cfg, _, params = setup
    eng, reqs = _overcommitted(cfg, params)
    m = eng.metrics()
    assert all(len(r.out) == 16 for r in reqs)
    assert m.preemptions >= 1
    assert m.swap_out_blocks == 0 and m.swap_in_blocks == 0
    monkeypatch.delenv("REPRO_KV_SWAP")
    for r in reqs:
        assert r.out == _solo_oracle(cfg, params, r.prompt, r.max_new)


def test_prefix_sharing_prefills_shared_prefix_once(setup):
    _, cfg, _, params = setup
    prefix = [3, 5, 7, 11, 13, 17]
    eng = _engine(cfg, params, max_batch=4)
    reqs = [Request(rid=i, prompt=prefix + [19 + i], max_new=4)
            for i in range(4)]
    for r in reqs:
        eng.submit(r)
    assert len(_run_checked(eng)) == 4
    m = eng.metrics()
    assert m.prefill_tokens == 7 + 3 * 1
    assert m.re_prefill_avoided == 3 * 6
    assert m.shared_blocks == 3 * 2
    assert m.cow_copies >= 3
    for r in reqs:
        assert r.out == _solo_oracle(cfg, params, r.prompt, r.max_new)


def test_step_guarded_quarantines_and_adapters_are_refused(setup):
    """An injected step fault fails one request and leaves the pool
    consistent; a request for a loaded adapter is accepted and served, one
    for an unknown adapter is refused at submit; kernel planning is on by
    default and sets the LoRA expand tile."""
    from repro_torch.serve.faults import FaultInjector
    _, cfg, _, params = setup
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=4,
                      fault_injector=FaultInjector.parse("step:exc=1"))
    reqs = [Request(rid=i, prompt=[3, 5, 7 + i], max_new=3) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    while eng.step_guarded():
        assert eng.check_invariants() == []
    assert sorted(r.finish_reason for r in reqs) == ["error", "length"]
    assert eng.invariant_violations == []
    eng.load_adapter("tenant-a")
    tenant = Request(rid=9, prompt=[1, 2], max_new=3, adapter_id="tenant-a")
    unknown = Request(rid=10, prompt=[1, 2], adapter_id="tenant-b")
    eng.submit(tenant)
    eng.submit(unknown)
    assert not tenant.rejected and eng.adapters.refcount("tenant-a") == 1
    assert unknown.rejected and "unknown adapter" in unknown.reject_reason
    while eng.step_guarded():
        assert eng.check_invariants() == []
    assert tenant.finish_reason == "length" and len(tenant.out) == 3
    assert eng.adapters.refcount("tenant-a") == 0
    assert set(eng.compile_reports) == {"decode", "prefill"}
    assert eng.kernel_plan is not None and eng.pages_per_fetch >= 1
    assert eng.lora_block_out == min(eng.kernel_plan.lora_block_out,
                                     cfg.d_model)


def test_serve_cli_on_cpu_and_refusals(monkeypatch, capsys):
    """The CLI serves the reduced config on the CPU; unported knobs, a
    mesh, and (on a host without a card) the cuda device are refused."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    eng = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--block-size", "4",
                      "--temperature", "0.7", "--top-k", "8"])
    assert eng.metrics().requests_finished == 3
    assert "device cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "2"])
    monkeypatch.setenv("REPRO_NORM_F32", "0")
    with pytest.raises(NotImplementedError, match="REPRO_NORM_F32"):
        serve.main(["--smoke", "--device", "cpu", "--requests", "1"])
    monkeypatch.delenv("REPRO_NORM_F32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--smoke"])
