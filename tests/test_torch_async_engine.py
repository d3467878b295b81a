"""The port's async engine over its serve engine, on the CPU at the reduced
qwen3-0.6b: streams identical to the batch oracle, mid-stream and queued
cancellation, interleaving, submit after stop, the stepper's own grad mode;
``ServeEngine.cancel`` held against the JAX engine's block accounting
(queued, active and parked requests); ``note_gateway_shed`` in the stats;
the launch counters under many threads; the chaos lane in-process."""
import asyncio
import json
import sys
import threading

import pytest
import torch

from _torch_parity import bridged_params
from repro_torch.kernels import count
from repro_torch.serve.async_engine import AsyncServeEngine
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine

torch.set_num_threads(1)

# every asyncio scenario runs under its own deadline: a hung stepper fails
# one test instead of stalling the suite
SCENARIO_S = 60.0


@pytest.fixture(scope="module")
def setup():
    return bridged_params("qwen3-0.6b")


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("plan_kernels", False)
    kw.setdefault("fault_injector", False)
    return ServeEngine(cfg, params, **kw)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, SCENARIO_S))


def _oracle(cfg, params, specs):
    """run_until_done on a fresh engine: the batch reference output."""
    eng = _engine(cfg, params)
    reqs = [Request(rid=i, prompt=list(p), max_new=n, sampling=sp)
            for i, (p, n, sp) in enumerate(specs)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


def test_stream_identical_to_batch_oracle(setup):
    """Greedy and seeded-sampled streams are bitwise what
    ``run_until_done`` gives for the same requests."""
    _, cfg, _, params = setup
    specs = [
        ([3, 5, 7, 11], 6, SamplingParams()),
        ([4, 6, 8], 5, SamplingParams(temperature=0.8, top_k=40, seed=7)),
        ([9, 2, 12, 13, 14], 4, SamplingParams(temperature=1.1, seed=3)),
    ]
    want = _oracle(cfg, params, specs)

    async def go():
        aeng = AsyncServeEngine(_engine(cfg, params))
        await aeng.start()
        try:
            streams = [aeng.submit(p, max_new=n, sampling=sp)
                       for p, n, sp in specs]
            outs = await asyncio.gather(*[s.drain() for s in streams])
            reasons = [s.finish_reason for s in streams]
        finally:
            await aeng.stop()
        return outs, reasons

    outs, reasons = _run(go())
    assert outs == want
    assert reasons == ["length"] * len(specs)


def test_cancel_mid_stream_frees_kv_blocks(setup):
    _, cfg, _, params = setup

    async def go():
        eng = _engine(cfg, params, prefix_cache_blocks=0)
        aeng = AsyncServeEngine(eng)
        await aeng.start()
        try:
            stream = aeng.submit([3, 5, 7, 11], max_new=24)
            got = [await stream.__anext__()]
            aeng.cancel(stream.rid)
            got += await stream.drain()
            for _ in range(200):
                if eng.pool.num_used == 0 and \
                        all(s is None for s in eng.slots):
                    break
                await asyncio.sleep(0.005)
            return (stream.finish_reason, len(got), eng.pool.num_used,
                    len(eng.queue), eng.check_invariants())
        finally:
            await aeng.stop()

    reason, n_got, used, queued, violations = _run(go())
    assert reason == "cancelled"
    assert 1 <= n_got < 24
    assert used == 0 and queued == 0 and violations == []


def test_cancel_queued_request(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params, max_batch=1, prefix_cache_blocks=0)
    a = Request(rid=0, prompt=[3, 5, 7], max_new=8)
    b = Request(rid=1, prompt=[4, 6, 8], max_new=4)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    assert eng.cancel(1)
    assert b.cancelled and b.done and b.finish_reason == "cancelled"
    assert not eng.cancel(99)
    eng.run_until_done(max_steps=200)
    assert a.done and len(a.out) == 8
    assert eng.pool.num_used == 0


def test_concurrent_streams_interleave(setup):
    _, cfg, _, params = setup
    n_reqs, max_new = 5, 6

    async def go():
        aeng = AsyncServeEngine(_engine(cfg, params))
        await aeng.start()
        order = []

        async def consume(i, stream):
            async for _tok in stream:
                order.append(i)

        try:
            streams = [aeng.submit([3 + i, 5, 7], max_new=max_new)
                       for i in range(n_reqs)]
            await asyncio.gather(*[consume(i, s)
                                   for i, s in enumerate(streams)])
        finally:
            await aeng.stop()
        return order

    order = _run(go())
    assert len(order) == n_reqs * max_new
    switches = sum(1 for a, b in zip(order, order[1:]) if a != b)
    assert switches > n_reqs, f"no interleaving: {order}"


def test_submit_after_stop_terminates_stream_immediately(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params)

    async def scenario():
        aeng = AsyncServeEngine(eng, model_id="m")
        await aeng.start()
        out = await aeng.generate([3, 5, 7], max_new=4)
        assert len(out) == 4
        await aeng.stop()
        stream = aeng.submit([3, 5, 7], max_new=4)
        toks = await asyncio.wait_for(stream.drain(), timeout=5.0)
        assert toks == [] and stream.finish_reason == "shutdown"
        assert aeng.fault is None

    _run(scenario())


def test_stepper_sets_its_own_grad_mode(setup):
    """The stepper runs every engine step with grad mode off, whatever the
    caller's thread has, and an adapter request over weights that require
    grad (whose LoRA wrapper refuses grad-recording inputs) streams the
    oracle's tokens instead of crashing the step."""
    _, cfg, _, params = setup

    def needing_grad(tree):
        if isinstance(tree, dict):
            return {k: needing_grad(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [needing_grad(v) for v in tree]
        return tree.clone().requires_grad_(True)
    eng = _engine(cfg, needing_grad(params))
    eng.load_adapter("tenant-a")
    modes = []
    step = eng.step

    def recording_step():
        modes.append(torch.is_grad_enabled())
        return step()
    eng.step = recording_step

    ref = _engine(cfg, params)
    ref.load_adapter("tenant-a")
    want = Request(rid=0, prompt=[3, 5, 7, 11], max_new=5,
                   adapter_id="tenant-a")
    with torch.no_grad():
        ref.submit(want)
        ref.run_until_done()

    async def go():
        assert torch.is_grad_enabled()
        aeng = AsyncServeEngine(eng)
        await aeng.start()
        try:
            stream = aeng.submit([3, 5, 7, 11], max_new=5,
                                 adapter_id="tenant-a")
            return await stream.drain(), stream.finish_reason
        finally:
            await aeng.stop()

    toks, reason = _run(go())
    assert reason == "length" and toks == want.out
    assert modes and not any(modes)
    assert eng.metrics().step_crashes == 0


def test_note_gateway_shed_counts_in_stats(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params)
    aeng = AsyncServeEngine(eng, model_id="m")
    eng.note_gateway_shed()
    eng.note_gateway_shed()
    assert aeng.stats()["requests_shed"] == 2
    assert eng.metrics().requests_shed == 2
    eng.reset_metrics()
    assert aeng.stats()["requests_shed"] == 0


# ---------------------------------------------------------------------------
# cancel against the JAX engine
# ---------------------------------------------------------------------------

def _cancel_trace(eng, make_request, case):
    """Drive one cancel scenario; return the accounting after every op."""
    calls = []
    reqs = [make_request(rid=i, prompt=[3 + i, 5, 7, 11, 13], max_new=8,
                         on_finish=lambda r: calls.append(r.rid))
            for i in range(2)]

    def snap(tag, ret=None):
        return (tag, ret, eng.pool.num_used, eng.pool.num_reserved,
                eng.store.host.num_used, len(eng.queue),
                [len(r.out) for r in reqs], [r.finish_reason for r in reqs],
                list(calls))

    trace = []
    if case == "queued":
        for r in reqs:
            eng.submit(r)
        eng.step()                       # max_batch 1: request 1 waits
        victim = 1
    elif case == "active":
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        victim = 0
    else:                                # parked on the host tier
        eng.submit(reqs[0])
        while len(reqs[0].out) < 2:
            eng.step()
        eng._requeue(next(a for a in eng.slots if a is not None))
        assert reqs[0].rid in eng._parked
        eng.submit(reqs[1])
        victim = 0
    trace.append(snap("before"))
    trace.append(snap("cancel", eng.cancel(victim)))
    trace.append(snap("again", eng.cancel(victim)))
    trace.append(snap("unknown", eng.cancel(99)))
    eng.run_until_done(max_steps=500)
    eng.release_prefix_cache()
    trace.append(snap("drained"))
    return trace, eng.check_invariants()


@pytest.mark.parametrize("case", ["queued", "active", "parked"])
def test_cancel_matches_jax_engine_block_accounting(setup, case):
    """The same submits, steps and cancels on the JAX engine and the port's
    give the same pool, reservation and host-tier counts after every op,
    keep ``out``, fire ``on_finish`` once and end as ``cancelled``."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    jcfg, cfg, jparams, params = setup
    kw = dict(max_batch=1 if case == "queued" else 2, max_len=32,
              block_size=4, plan_kernels=False)
    jtrace, jbad = _cancel_trace(JServeEngine(jcfg, jparams, **kw), JRequest,
                                 case)
    ttrace, tbad = _cancel_trace(_engine(cfg, params, **kw), Request, case)
    assert ttrace == jtrace
    assert tbad == [] and jbad == []
    before, cancel, again, unknown, drained = ttrace
    victim = 1 if case == "queued" else 0
    assert cancel[1] is True and cancel[7][victim] == "cancelled"
    assert again[1] is False and unknown[1] is False
    assert cancel[6] == before[6]                # sampled tokens kept
    assert sorted(drained[-1]) == [0, 1]         # on_finish once each
    # the blocks it held come back the call it is cancelled
    if case == "active":
        assert cancel[2] < before[2]
    elif case == "parked":
        assert before[4] > 0 and cancel[4] == 0
    assert drained[2:5] == (0, 0, 0)


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

def test_launch_count_holds_under_many_threads():
    """``kernels.count``, which every kernel wrapper calls once a launch,
    loses no increment when more threads than cores bump one counter with
    a switch interval short enough to split a read-modify-write."""
    counters = {"launches": 0}
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count(counters, "launches")
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counters["launches"] == n_threads * per_thread


# ---------------------------------------------------------------------------
# chaos lane
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_chaos_lane_holds_fault_tolerance_contract():
    """tools.chaos_smoke_torch in-process: under a deterministic alloc and
    step fault mix every stream ends, no block leaks on either tier, and
    the survivors equal the fault-free oracle."""
    from tools.chaos_smoke_torch import chaos_setup, run_chaos
    from tools.gateway_smoke_torch import Deadline

    report, failures = run_chaos("alloc:p=0.1,step:exc=2", seed=1,
                                 n_requests=6, qps=30.0,
                                 deadline=Deadline(120.0),
                                 **chaos_setup(smoke=True, device="cpu"))
    assert failures == [], failures
    assert sum(report["outcomes"].values()) == 6
    assert report["step_crashes"] >= 1
    assert sum(c["fired"] for c in report["fault_counts"].values()) >= 1
    assert report["survivors"] >= 1


@pytest.mark.chaos
def test_chaos_cli_runs_where_it_is_asked(tmp_path, capsys):
    """``python -m tools.chaos_smoke_torch --smoke --device cpu`` passes its
    checks and writes its report; without ``--device`` it asks for the card,
    which raises on a host without one instead of falling back."""
    from tools import chaos_smoke_torch

    out = tmp_path / "chaos_report.json"
    assert chaos_smoke_torch.main([
        "--smoke", "--device", "cpu", "--fault", "alloc:p=0.1,step:exc=2",
        "--seed", "1", "--requests", "4", "--qps", "30",
        "--deadline-s", "120", "--out", str(out)]) == 0
    assert "all checks passed" in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["arch"] == "qwen3-0.6b-smoke"
    assert sum(report["outcomes"].values()) == 4


def test_chaos_cli_defaults_to_the_card(monkeypatch):
    from tools import chaos_smoke_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        chaos_smoke_torch.main(["--smoke", "--fault", "step:exc=2"])
