"""Rank bodies of the sharded-serving tests, run by
``repro_torch.launch.mesh.spawn_ranks`` in processes of their own: this
module imports the port only (no JAX), so a rank starts fast.  Each body
returns plain Python and numpy values for the test to check against the
plain engine and the JAX engine."""
import dataclasses
import os
import time

import numpy as np
import torch


def _cfg(fields):
    from repro_torch.configs.base import get_config, reduced_config
    return dataclasses.replace(reduced_config(get_config("qwen3-0.6b")),
                               **fields)


def _requests(records):
    from repro_torch.serve.engine import Request, SamplingParams
    return [Request(rid=rid, prompt=list(prompt), max_new=max_new,
                    sampling=SamplingParams(temperature=t, top_k=k, seed=s))
            for rid, prompt, max_new, t, k, s in records]


def _engine(cfg, params, mesh, **kw):
    from repro_torch.serve.engine import ServeEngine
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("fault_injector", False)
    return ServeEngine(cfg, params, plan_kernels=False, mesh=mesh, **kw)


def serve(eng, records, between=None):
    """Rank 0 submits ``records`` and steps (``between(eng, step)`` after
    each step, if given), then releases the others; the others follow.
    The KV invariants are checked after every step on every rank.  Returns
    (tokens by rid, finish reasons by rid, invariant violations)."""
    bad = []

    def check():
        bad.extend(eng.check_invariants())

    if eng.mesh is None or eng.is_leader:
        for r in _requests(records):
            eng.submit(r)
        try:
            k = 0
            while eng.step():
                check()
                k += 1
                if between is not None:
                    between(eng, k)
        finally:
            eng.close()
    else:
        eng.follow(check)
    done = eng.finished + eng.expired + eng.cancelled
    return ({r.rid: list(r.out) for r in eng.finished},
            {r.rid: r.finish_reason for r in done}, bad)


class _SkippingClock:
    """The ``time`` module as rank 0's engine sees it, with a monotonic
    clock the test moves forward instead of sleeping."""

    def __init__(self):
        self.skip = 0.0

    def __getattr__(self, name):
        return getattr(time, name)

    def monotonic(self):
        return time.monotonic() + self.skip


def _refusal(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — reported to the test
        return f"{type(e).__name__}: {e}"
    return "built"


def sharded_world(mesh, device, np_params, fields, records, toks):
    """Every sharded-serving check at this world size (see
    ``tests/test_torch_serve_sharded.py``)."""
    from repro_torch import bridge
    from repro_torch.distributed.param_sharding import (ServeShard, TPWeight,
                                                        shard_params,
                                                        tp_param_specs)
    from repro_torch.models import build_model
    from repro_torch.serve.engine import MeshDivergence, Request
    cfg = _cfg(fields)
    params = bridge.params_from_numpy(np_params, "cpu")
    n, rank = mesh.n_model, mesh.rank
    out = {"rank": rank}
    with torch.no_grad():
        if rank == 0:
            out["plain"] = serve(_engine(cfg, params, False), records)[0]

        # the KV pool sharded on kv-heads, weights replicated; then TP
        # identity; then reduce-scatter
        for name, tp, rs in (("kv", False, False), ("tp", True, False),
                             ("rs", True, True)):
            os.environ["REPRO_TP_REDUCE_SCATTER"] = "1" if rs else "0"
            eng = _engine(cfg, params, mesh, tp=tp)
            tokens, _, bad = serve(eng, records)
            m = eng.metrics()
            released = eng.release_prefix_cache()
            out[name] = dict(
                tokens=tokens, invariants=bad, slab=tuple(eng.cache["k"].shape),
                contiguous=eng.cache["k"].is_contiguous(),
                re_prefill_avoided=m.re_prefill_avoided,
                mesh_devices=m.mesh_devices, tp_devices=m.tp_devices,
                bytes=(m.param_bytes_per_device, m.param_bytes_replicated),
                reduce_scatter=eng.shard.reduce_scatter,
                released=released, pool_used=eng.pool.num_used,
                layout={k: w.dim if isinstance(w, TPWeight) else None
                        for k, w in eng.params["layers"][0]["attn"].items()})
        os.environ["REPRO_TP_REDUCE_SCATTER"] = "0"

        # prefill logits: the stored layout against the replicated forward
        # (two chunks, the second attending the first's pages)
        fns = build_model(cfg, "cpu")
        specs, _ = tp_param_specs(cfg, params, n)
        local = shard_params(params, specs, mesh)
        caches = {k: fns.make_paged_cache(8, 8, n_model=m) for k, m in
                  (("ref", 1), ("rs", n), ("id", n))}
        logits = {k: [] for k in caches}
        table = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
        for start in (0, 8):
            batch = {"tokens": torch.tensor([toks[start:start + 8]]),
                     "block_table": table, "start": start,
                     "prompt_len": start + 8}
            for k, p, shard in (("ref", params, None),
                                ("rs", local, ServeShard(mesh, True)),
                                ("id", local, ServeShard(mesh, False))):
                kw = {} if shard is None else {"shard": shard}
                logits[k].append(fns.prefill_chunk(p, caches[k], batch,
                                                   **kw)[1].numpy())
        out["logits"] = {k: np.stack(v) for k, v in logits.items()}

        # preemption by swap under the sharded tier: each rank parks its
        # head slice on its own host tier
        swap_records = [(i, [3, 5, 7, 11 + i], 16, 0.0, 0, 0)
                        for i in range(2)]
        for name, tp in (("swap_kv", False), ("swap_tp", True)):
            eng = _engine(cfg, params, mesh, tp=tp, max_batch=2, max_len=32,
                          block_size=4, num_blocks=7, admission="optimistic")
            tokens, _, bad = serve(eng, swap_records)
            m = eng.metrics()
            out[name] = dict(tokens=tokens, invariants=bad,
                             preemptions=m.preemptions,
                             swap=(m.swap_out_blocks, m.swap_in_blocks))
        if rank == 0:
            out["solo"] = {}
            for rid, prompt, max_new, *_ in swap_records:
                solo = _engine(cfg, params, False, max_batch=1, max_len=32,
                               block_size=4, prefix_cache_blocks=0)
                out["solo"][rid] = serve(solo, [(0, prompt, max_new, 0.0, 0,
                                                 0)])[0][0]

        # deadlines from rank 0's knob (the other ranks' environments lack
        # it), submissions and a cancel between steps on rank 0 only; at
        # step 14 rank 0's clock jumps past every live deadline and the
        # others' clocks do not, so a rank that read its own would part
        from repro_torch.serve import engine as engine_mod
        clock = _SkippingClock()
        if rank == 0:
            os.environ["REPRO_SERVE_DEADLINE_MS"] = "3000"
            engine_mod.time = clock
        try:
            eng = _engine(cfg, params, mesh, tp=True, max_batch=2)
            os.environ.pop("REPRO_SERVE_DEADLINE_MS", None)

            def between(e, k):
                if k == 3:
                    e.submit(Request(rid=100, prompt=[9, 8, 7], max_new=4))
                    e.submit(Request(rid=101, prompt=[4, 4, 4, 4],
                                     max_new=30))
                if k == 5:
                    e.cancel(101)
                if k == 14:
                    live = [r._deadline_at for r in e.queue] + [
                        a.req._deadline_at for a in e.slots if a is not None]
                    clock.skip += max(0.0, max(live) - clock.monotonic()
                                      + 0.01)
            _, reasons, bad = serve(eng, records[:6], between)
        finally:
            engine_mod.time = time
        out["deadline"] = dict(reasons=reasons, invariants=bad)

        # refusals and knobs (construction only)
        from repro_torch.configs.base import get_config, reduced_config
        ref = {}
        eng = _engine(cfg, params, mesh)
        ref["load_adapter"] = _refusal(lambda: eng.load_adapter("t0"))
        if rank == 0:
            ref["submit_adapter"] = _refusal(lambda: eng.submit(
                Request(rid=0, prompt=[1, 2], adapter_id="t0")))
        else:
            ref["submit_follower"] = _refusal(lambda: eng.submit(
                Request(rid=0, prompt=[1, 2])))
        for arch in ("falcon-mamba-7b", "zamba2-2.7b", "olmoe-1b-7b"):
            c = reduced_config(get_config(arch))
            ref[arch] = _refusal(lambda c=c: _engine(
                c, build_model(c, "cpu").init(0), mesh))
        ref["kv3"] = _refusal(lambda: _engine(
            dataclasses.replace(cfg, n_kv_heads=3, n_heads=3), params, mesh))
        ref["kv2"] = _refusal(lambda: _engine(
            dataclasses.replace(cfg, n_kv_heads=2), params, mesh))
        out["refusals"] = ref

        knobs = {}
        for env in ({"REPRO_SERVE_MESH": "auto"},
                    {"REPRO_SERVE_MESH": str(n)},
                    {"REPRO_SERVE_MESH": str(n + 1)},
                    {"REPRO_SERVE_MESH": "0"},
                    {"REPRO_SERVE_MESH": "auto", "REPRO_SERVE_TP": "1"},
                    {"REPRO_SERVE_MESH": "auto", "REPRO_SERVE_TP": "1",
                     "REPRO_TP_REDUCE_SCATTER": "1"}):
            os.environ.update(env)
            try:
                from repro_torch.serve.engine import ServeEngine
                e = ServeEngine(cfg, params, max_batch=2, max_len=32,
                                block_size=4, plan_kernels=False,
                                fault_injector=False)
                got = (e.mesh.n_model if e.mesh is not None else 0, e.tp,
                       e.shard.reduce_scatter if e.shard else None)
            except Exception as exc:  # noqa: BLE001
                got = f"{type(exc).__name__}: {exc}"
            finally:
                for k in env:
                    os.environ.pop(k)
            knobs[" ".join(f"{k}={v}" for k, v in env.items())] = got
        out["knobs"] = knobs

        # a planted divergence: rank 1 samples another token
        if n > 1:
            eng = _engine(cfg, params, mesh, tp=True)
            if rank == 1:
                sample = eng._sample
                eng._sample = lambda row, sp, k: (sample(row, sp, k) + 1) \
                    % cfg.vocab
            try:
                serve(eng, records[:2])
                out["diverged"] = None
            except MeshDivergence as e:
                out["diverged"] = str(e)
    return out


def pod_tp(mesh, device, np_params, fields, records, toks):
    """The reference's pod tests of tensor-parallel weights at this world:
    identity-mode tokens and the plain engine's (rank 0), the rank's
    bytes, the stored layout, the indivisible config's refusal, and
    reduce-scatter / identity prefill logits against the replicated
    forward (``tests/test_torch_param_sharding.py``)."""
    from repro_torch import bridge
    from repro_torch.distributed.param_sharding import (ServeShard, TPWeight,
                                                        shard_params,
                                                        tp_param_specs)
    from repro_torch.models import build_model
    cfg = _cfg(fields)
    params = bridge.params_from_numpy(np_params, "cpu")
    out = {}
    with torch.no_grad():
        if mesh.rank == 0:
            out["plain"] = serve(_engine(cfg, params, False), records)[0]
        eng = _engine(cfg, params, mesh, tp=True)
        out["tp"], _, out["invariants"] = serve(eng, records)
        m = eng.metrics()
        out["metrics"] = (m.tp_devices, m.mesh_devices,
                          m.param_bytes_per_device, m.param_bytes_replicated)
        attn = eng.params["layers"][0]["attn"]
        out["layout"] = {k: (w.dim, tuple(w.local.shape))
                         for k, w in attn.items() if isinstance(w, TPWeight)}
        out["indivisible"] = _refusal(lambda: _engine(
            dataclasses.replace(cfg, n_kv_heads=2), params, mesh, tp=True))
        fns = build_model(cfg, "cpu")
        specs, _ = tp_param_specs(cfg, params, mesh.n_model)
        local = shard_params(params, specs, mesh)
        batch = {"tokens": torch.tensor([toks]), "block_table":
                 torch.tensor([[1, 2, 0, 0]], dtype=torch.int32),
                 "start": 0, "prompt_len": len(toks)}
        out["ref"] = fns.prefill_chunk(params, fns.make_paged_cache(4, 8),
                                       batch)[1].numpy()
        for k, rs in (("rs", True), ("id", False)):
            cache = fns.make_paged_cache(4, 8, n_model=mesh.n_model)
            out[k] = fns.prefill_chunk(local, cache, batch,
                                       shard=ServeShard(mesh, rs))[1].numpy()
    return out


def dies(mesh, device):
    """Rank 1 ends without a result; rank 0 returns its rank."""
    if mesh.rank == 1:
        os._exit(3)
    return mesh.rank


# ---------------------------------------------------------------------------
# MoE on a serve mesh (tests/test_torch_serve_sharded_moe.py)
# ---------------------------------------------------------------------------

def serve_guarded(eng, records):
    """``serve`` with rank 0 stepping through ``step_guarded`` (crash
    isolation); the other ranks follow.  Returns (tokens by rid of the
    finished requests, errored rids, invariant violations)."""
    bad = []

    def check():
        bad.extend(eng.check_invariants())

    if eng.mesh is None or eng.is_leader:
        for r in _requests(records):
            eng.submit(r)
        try:
            while eng.step_guarded():
                check()
        finally:
            eng.close()
    else:
        eng.follow(check)
    return ({r.rid: list(r.out) for r in eng.finished},
            sorted(r.rid for r in eng.errored), bad + eng.invariant_violations)


def _route_log():
    """Record every ``moe._select`` pick (the routing) while installed:
    (install, uninstall, picks)."""
    from repro_torch.models import moe as moe_lib
    picks, orig = [], moe_lib._select

    def rec(probs, k):
        idx = orig(probs, k)
        picks.append(idx.clone())
        return idx

    def install():
        picks.clear()
        moe_lib._select = rec

    def uninstall():
        moe_lib._select = orig
    return install, uninstall, picks


def _flips(a, b):
    """(token positions whose expert set differs in any layer, count of
    differing (layer, token) sets) between two logs of one forward."""
    pos, n = set(), 0
    for x, y in zip(a, b):
        x, y = x.sort(-1).values, y.sort(-1).values
        diff = (x != y).any(-1).reshape(-1)
        n += int(diff.sum())
        pos.update(int(i) for i in diff.nonzero().reshape(-1))
    return sorted(pos), n


def sharded_moe_world(mesh, device, arch, np_params, records, toks,
                      fault_spec):
    """Every MoE-on-a-mesh check of one reduced arch at this world size
    (see ``tests/test_torch_serve_sharded_moe.py``)."""
    from repro_torch import bridge
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.distributed.param_sharding import (ServeShard, TPWeight,
                                                        shard_params,
                                                        tp_param_specs)
    from repro_torch.models import build_model
    from repro_torch.serve.engine import MeshDivergence
    from repro_torch.serve.faults import FaultInjector
    cfg = reduced_config(get_config(arch))
    params = bridge.params_from_numpy(np_params, "cpu")
    n, rank = mesh.n_model, mesh.rank
    out = {"rank": rank}
    with torch.no_grad():
        # KV-only and TP identity, under both decode paths
        for decode in ("gather", "dispatch"):
            os.environ["REPRO_MOE_DECODE"] = decode
            if rank == 0:
                out[f"plain_{decode}"] = serve(_engine(cfg, params, False),
                                               records)[0]
            for name, tp in (("kv", False), ("tp", True)):
                eng = _engine(cfg, params, mesh, tp=tp)
                tokens, _, bad = serve(eng, records)
                m = eng.metrics()
                moe = next(lp["moe"] for lp in eng.params["layers"]
                           if "moe" in lp)
                out[f"{name}_{decode}"] = dict(
                    tokens=tokens, invariants=bad,
                    slab=tuple(eng.cache["k"].shape),
                    bytes=(m.param_bytes_per_device,
                           m.param_bytes_replicated),
                    experts={k: (w.dim, tuple(w.local.shape))
                             if isinstance(w, TPWeight) else None
                             for k, w in moe.items() if k != "shared"})
        os.environ["REPRO_MOE_DECODE"] = "gather"

        # reduce-scatter prefill logits against the replicated forward, two
        # chunks, with each forward's routing logged
        fns = build_model(cfg, "cpu")
        specs, _ = tp_param_specs(cfg, params, n)
        local = shard_params(params, specs, mesh)
        install, uninstall, picks = _route_log()
        logs, logits = {}, {}
        for k, p, shard in (("ref", params, None),
                            ("rs", local, ServeShard(mesh, True)),
                            ("id", local, ServeShard(mesh, False))):
            cache = fns.make_paged_cache(8, 8, n_model=1 if shard is None
                                         else n)
            table = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
            install()
            try:
                got = []
                for start in (0, 8):
                    batch = {"tokens": torch.tensor([toks[start:start + 8]]),
                             "block_table": table, "start": start,
                             "prompt_len": start + 8}
                    kw = {} if shard is None else {"shard": shard}
                    got.append(fns.prefill_chunk(p, cache, batch,
                                                 **kw)[1].numpy())
            finally:
                uninstall()
            logs[k], logits[k] = list(picks), np.stack(got)
        out["logits"] = logits
        out["flips_rs"] = _flips(logs["ref"], logs["rs"])
        out["flips_id"] = _flips(logs["ref"], logs["id"])

        # a step fault seeded alike on every rank, on a KV-only and a TP
        # engine, against one device under the same fault
        for name, tp in (("fault_kv", False), ("fault_tp", True)):
            eng = _engine(cfg, params, mesh, tp=tp,
                          fault_injector=FaultInjector.parse(fault_spec))
            tokens, errored, bad = serve_guarded(eng, records)
            m = eng.metrics()
            out[name] = dict(tokens=tokens, errored=errored, invariants=bad,
                             crashes=m.step_crashes, degraded=m.degraded)
        if rank == 0:
            solo = _engine(cfg, params, False,
                           fault_injector=FaultInjector.parse(fault_spec))
            tokens, errored, bad = serve_guarded(solo, records)
            out["fault_plain"] = dict(tokens=tokens, errored=errored,
                                      invariants=bad)

    return out


def one_rank_fault(mesh, device, arch, np_params, records, fault_spec):
    """A ``step`` fault on the last rank only, on a KV-only engine: that
    rank crashes before the model call and waits in the step's closing
    gather while the others wait in the model's first collective; each
    side's collective times out, and no rank may quarantine.  Returns what
    this rank raised and what it quarantined."""
    from repro_torch import bridge
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.serve.faults import FaultInjector
    cfg = reduced_config(get_config(arch))
    params = bridge.params_from_numpy(np_params, "cpu")
    inj = FaultInjector.parse(fault_spec) if mesh.rank == mesh.n_model - 1 \
        else False
    t0 = time.monotonic()
    with torch.no_grad():
        eng = _engine(cfg, params, mesh, fault_injector=inj)
        try:
            serve_guarded(eng, records)
            raised = None
        except Exception as e:  # noqa: BLE001 — reported to the test
            raised = f"{type(e).__name__}: {e}"
    return {"rank": mesh.rank, "raised": raised,
            "errored": sorted(r.rid for r in eng.errored),
            "seconds": time.monotonic() - t0}


# ---------------------------------------------------------------------------
# The gateway over a serve mesh (tests/test_torch_gateway_mesh.py)
# ---------------------------------------------------------------------------

GATEWAY_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b")


def _gateway_engines(mesh, fault_spec):
    """Reduced qwen3-0.6b and olmoe-1b-7b (weights ``init(0)``) over
    ``mesh`` (False: one device); the olmoe engine under ``fault_spec``."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.serve.faults import FaultInjector
    engines = []
    for arch in GATEWAY_ARCHS:
        cfg = reduced_config(get_config(arch))
        inj = FaultInjector.parse(fault_spec) \
            if arch == "olmoe-1b-7b" and fault_spec else False
        engines.append(_engine(cfg, build_model(cfg, "cpu").init(0), mesh,
                               max_batch=2, fault_injector=inj))
    return engines


def gateway_mesh(mesh, device, specs, cancel, fault_spec):
    """Rank 0: one in-process ``Gateway`` over a router of both engines on
    this mesh, ``specs`` (model index, prompt, max_new, temperature, top_k,
    seed) streamed over HTTP at once, stream ``cancel[0]`` closed by its
    client after ``cancel[1]`` tokens; then the gateway stops, which closes
    both engines.  The other ranks follow both engines until then.  Every
    rank returns its engines' finished tokens, cancelled and errored rids;
    rank 0 also the streams and a plain engine's tokens a spec."""
    import asyncio

    from repro_torch.serve.engine import (Request, SamplingParams,
                                          follow_all)
    from repro_torch.serve.gateway import Gateway, Router, wrap_engine
    from tools.gateway_smoke_torch import completion_payload, sse_request
    with torch.no_grad():
        engines = _gateway_engines(mesh, fault_spec)
    out = {"rank": mesh.rank}
    if mesh.rank == 0:
        models = [wrap_engine(e) for e in engines]

        async def drive():
            async with Gateway(Router(models), port=0) as gw:
                asks = [sse_request(gw.host, gw.port, completion_payload(
                    models[m].model_id, prompt, max_new,
                    SamplingParams(temperature=t, top_k=k, seed=s)),
                    close_after=cancel[1] if i == cancel[0] else None)
                    for i, (m, prompt, max_new, t, k, s) in enumerate(specs)]
                got = await asyncio.wait_for(asyncio.gather(*asks), 120)
                # the closed stream's cancel lands on the stepper's next turn
                for _ in range(500):
                    if engines[specs[cancel[0]][0]].cancelled:
                        break
                    await asyncio.sleep(0.01)
                return got
        got = asyncio.run(drive())
        out["streams"] = [{k: g[k] for k in ("status", "raw",
                                             "closed_early")} for g in got]
        out["faults"] = [m.async_engine.fault for m in models]
        with torch.no_grad():
            plain = _gateway_engines(False, "")
            reqs = []
            for i, (m, prompt, max_new, t, k, s) in enumerate(specs):
                reqs.append(Request(rid=i, prompt=list(prompt),
                                    max_new=max_new,
                                    sampling=SamplingParams(t, k, s)))
                plain[m].submit(reqs[-1])
            for e in plain:
                e.run_until_done()
        out["plain"] = [list(r.out) for r in reqs]
    else:
        with torch.no_grad():
            out["steps"] = follow_all(engines)
    out["engines"] = [{
        "finished": {r.rid: list(r.out) for r in e.finished},
        "cancelled": sorted(r.rid for r in e.cancelled),
        "errored": sorted(r.rid for r in e.errored),
        "closed": e._closed, "invariants": e.check_invariants()
        + e.invariant_violations} for e in engines]
    return out
