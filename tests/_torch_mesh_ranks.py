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
    return ServeEngine(cfg, params, plan_kernels=False, mesh=mesh,
                       fault_injector=False, **kw)


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
