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
    """The CLI serves the reduced config on the CPU, also in bf16 under
    REPRO_NORM_F32=0 (rms_norm in the activation dtype); a mesh of a family
    the sharded engine does not serve, and (on a host without a card) the
    cuda device are refused."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    eng = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--block-size", "4",
                      "--temperature", "0.7", "--top-k", "8"])
    assert eng.metrics().requests_finished == 3
    assert "device cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--arch",
                    "falcon-mamba-7b", "--mesh", "2"])
    monkeypatch.setenv("REPRO_NORM_F32", "0")
    eng = serve.main(["--smoke", "--device", "cpu", "--requests", "1",
                      "--dtype", "bfloat16", "--max-new", "3"])
    assert eng.metrics().requests_finished == 1
    monkeypatch.delenv("REPRO_NORM_F32")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--smoke"])


# REPRO_NORM_F32=0: rms_norm in the activation dtype, against the reference
# under the same knob.  The forward follows what XLA compiles the
# reference's bf16 rms_norm to (``ref._narrow_rstd``) and is bitwise equal
# to it at these shapes; the gradients are held row by row within 2e-2 of
# the largest value (``ref.GRAD_ROW_TOL``'s bf16 limit): jax.vjp of the
# reference sums its bf16 cotangents in bf16, rounding every add, where the
# port sums in f32 (at these shapes the gap measured 4.6e-3 to 1.5e-2).
NARROW_SHAPES = ((8, 64), (64, 256), (8, 1024), (256, 128))


def _narrow_inputs(rows, d, dtype, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * rng.uniform(0.1, 4)).astype(
        np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jw, jg = (jnp.asarray(a, jdt) for a in (x, w, g))
    tx, tw, tg = (torch.from_numpy(a).to(dtype) for a in (x, w, g))
    return (jx, jw, jg), (tx, tw, tg)


def _rows_within(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1,
                                                             want.shape[-1])
    scale = np.maximum(np.abs(want).max(-1), 1e-30)
    return float((np.abs(got - want).max(-1) / scale).max()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", NARROW_SHAPES)
def test_norm_f32_off_matches_reference(monkeypatch, rows, d, dtype):
    """Under REPRO_NORM_F32=0: ``layers.rms_norm`` and ``rms_norm_pair``
    equal the reference's ``rms_norm`` bitwise at bf16 (within 1e-5 a row at
    f32, where the knob changes nothing and the two packages' f32 sums
    differ by reassociation), and ``RMSNormFn``'s gradients (through
    ``ops.rmsnorm``) are within 2e-2 a row of jax.vjp's at bf16, 1e-5 at
    f32."""
    import jax
    monkeypatch.setenv("REPRO_NORM_F32", "0")
    from repro.models.layers import rms_norm as jrms
    from repro_torch.models.layers import rms_norm, rms_norm_pair
    (jx, jw, jg), (tx, tw, tg) = _narrow_inputs(rows, d, dtype, rows + d)
    bf16 = dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 1e-5

    def same(got, want):
        want = np.asarray(want.astype(np.float32))
        if bf16:
            return np.array_equal(got.float().numpy(), want)
        return _rows_within(got.numpy(), want, tol)
    got = rms_norm(tx, tw)
    assert same(got, jax.jit(jrms)(jx, jw))
    y1, y2 = rms_norm_pair(tx, tw, tx[:1].clone(), tw.flip(0))
    assert torch.equal(y1, got)
    assert same(y2, jax.jit(jrms)(jx[:1], jw[::-1]))
    jdx, jdw = jax.vjp(jrms, jx, jw)[1](jg)
    xg, wg = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    out = rms_norm(xg, wg)
    assert out.grad_fn is not None and torch.equal(out.detach(), got)
    dx, dw = torch.autograd.grad(out, (xg, wg), tg)
    assert _rows_within(dx.float().numpy(), jdx.astype(np.float32), tol)
    assert _rows_within(dw.float().numpy()[None],
                        np.asarray(jdw.astype(np.float32))[None], tol)


def test_norm_f32_off_changes_bf16_and_keeps_the_default(monkeypatch):
    """The knob is read at every call: off, a bf16 rms_norm differs from
    the f32 mode's (its mean, rstd and products round to bf16) and its
    plain backward rounds likewise; back on, the default's bits return."""
    from repro_torch.kernels import ref
    from repro_torch.models.layers import rms_norm
    _, (tx, tw, tg) = _narrow_inputs(64, 256, torch.bfloat16, 3)
    default = rms_norm(tx, tw)
    assert torch.equal(default, ref.rmsnorm_ref(tx, tw))
    monkeypatch.setenv("REPRO_NORM_F32", "0")
    narrow = rms_norm(tx, tw)
    assert not torch.equal(narrow, default)
    assert torch.equal(narrow, ref.rmsnorm_ref(tx, tw, f32=False))
    assert not torch.equal(ref.rmsnorm_bwd_ref(tx, tw, tg, f32=False)[0],
                           ref.rmsnorm_bwd_ref(tx, tw, tg)[0])
    from repro_torch.perf import perf
    assert perf().norm_f32 is False
    monkeypatch.setenv("REPRO_NORM_F32", "1")
    assert torch.equal(rms_norm(tx, tw), default) and perf().norm_f32


def test_norm_f32_off_bf16_serve_matches_jax_engine(monkeypatch):
    """Reduced qwen3-0.6b in bf16 under REPRO_NORM_F32=0: the port's engine
    and the JAX engine, on the same bridged bf16 weights, emit the same
    greedy tokens for the 12-request workload."""
    import dataclasses

    import jax
    from repro.models import build_model as jax_build_model
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    from _torch_parity import reduced
    from repro_torch import bridge
    monkeypatch.setenv("REPRO_NORM_F32", "0")
    jcfg, cfg = reduced("qwen3-0.6b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    eng = _engine(cfg, params, max_batch=4, max_len=64, block_size=8)
    reqs = _workload(cfg.vocab)
    for r in reqs:
        eng.submit(r)
    _run_checked(eng)
    jeng = JServeEngine(jcfg, jparams, max_batch=4, max_len=64, block_size=8,
                        plan_kernels=False, mesh=False, fault_injector=False)
    jreqs = [JRequest(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
             for r in _workload(cfg.vocab)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
