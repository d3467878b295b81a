"""Chaos lane of the PyTorch port: the open-loop gateway workload under
injected faults.

    PYTHONPATH=src python -m tools.chaos_smoke_torch --arch qwen3-0.6b \
        --fault "alloc:p=0.05,step:exc=2" --requests 12 --out chaos_report.json
    # on the CPU, at the reduced size
    PYTHONPATH=src python -m tools.chaos_smoke_torch --smoke --device cpu

Boots an in-process gateway over the port's engine with a seeded
``FaultInjector`` (``repro_torch.serve.faults``) wired into the live
engine's allocator, swap paths and step dispatch, fires the workload at it
as Poisson arrivals and holds the wreckage to the fault-tolerance contract:

  * **no hung streams** — every client either finishes its SSE stream or a
    per-client deadline trips (``tools.gateway_smoke_torch.Deadline`` for
    the whole-run budget);
  * **every request reaches a terminal outcome** — a finished stream
    (``length``), a load-shed 429, or an engine-side terminal
    (``error`` / ``expired``), never silence;
  * **no leaked KV blocks** — after the run drains, both tiers are empty,
    the reservation ledger is zero, and ``ServeEngine.check_invariants()``
    (plus every violation recorded during crash recovery) is clean;
  * **fault-free survivors are oracle-identical** — requests that ran to
    ``length`` stream exactly the tokens a fresh fault-free
    ``run_until_done()`` engine produces for the same request on the same
    weights and device, so quarantine and recovery never corrupt an
    innocent neighbour's KV.

It runs on the card unless ``--device cpu`` is given (``cuda`` without a
card raises; it never falls back to the CPU), at full width with the serve
engine's settings, or with ``--smoke`` the reduced config at the sizes of
the reference's chaos lane.  ``run_chaos`` runs any config on the device
its weights live on (``chaos_setup`` makes them; ``chip_smoke.py`` runs
full-width qwen3-0.6b on the card).  Writes a report with outcome tallies,
per-site fault counts and any failures; exit status is the number of failed
checks.  The spec is consumed from ``REPRO_FAULT`` (and cleared, so the
oracle engine stays fault-free) when ``--fault`` is not given.  Nothing
here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from tools.gateway_smoke_torch import (Deadline, check_sse,
                                       completion_payload, poisson_arrivals,
                                       sse_request)

DEFAULT_FAULT = "alloc:p=0.05,step:exc=2,swap_out:p=0.2"
# the reduced engine of the reference's chaos lane (--smoke)
SMOKE_ENGINE = dict(max_batch=4, max_len=64, block_size=8)
# the serve engine's settings at full width (PERF.md section 4)
FULL_ENGINE = dict(max_batch=8, max_len=2048, block_size=16,
                   prefill_chunk_tokens=256)

def workload(vocab: int, n: int, seed: int = 0) -> List:
    """Mixed prompt lengths (3..20) and output lengths (4..14); every third
    request opens with a common 9-token prefix and is sampled (T 0.8, top-k
    40), the rest greedy: the reference's serve-bench workload."""
    import numpy as np

    from repro_torch.serve.engine import Request, SamplingParams

    rng = np.random.default_rng(seed)
    shared_prefix = rng.integers(1, vocab, size=9).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.integers(3, 21))
        max_new = int(rng.integers(4, 15))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        if i % 3 == 0:
            prompt = (shared_prefix + prompt)[:20]
        sp = SamplingParams() if i % 3 else \
            SamplingParams(temperature=0.8, top_k=40, seed=i)
        reqs.append(Request(rid=i, prompt=prompt, max_new=max_new,
                            sampling=sp))
    return reqs


async def _served_model_id(host: str, port: int) -> str:
    """The gateway's own base-model id from ``/v1/models`` (a multi-LoRA
    gateway also lists ``base:adapter`` cards; the base card is the one
    without a ``parent``)."""
    got = await sse_request(host, port, None, path="/v1/models")
    assert got["status"] == 200, f"/v1/models -> {got['status']}"
    models = json.loads(got["raw"])
    bases = [m["id"] for m in models["data"] if not m.get("parent")]
    assert bases, f"no base model card in {models}"
    return bases[0]


def chaos_setup(arch: str = "qwen3-0.6b", smoke: bool = False,
                device: Optional[str] = None) -> Dict:
    """``run_chaos``'s ``cfg``, ``params`` (random, seed 0) and
    ``engine_kwargs``: ``arch`` at full width with the serve engine's
    settings, or its reduced config with the reference chaos lane's.  The
    weights go to ``device`` (``cuda`` unless ``cpu`` is asked for; no
    card raises)."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if smoke:
        cfg = reduced_config(cfg)
    return {"cfg": cfg,
            "params": build_model(cfg, resolve_device(device)).init(0),
            "engine_kwargs": dict(SMOKE_ENGINE if smoke else FULL_ENGINE)}


def build_engines(fault_spec: str, seed: int, cfg, params,
                  engine_kwargs: Dict):
    """(live engine with faults, fault-free oracle engine) sharing one set
    of weights, on the device they live on."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector

    live = ServeEngine(cfg, params, fault_injector=FaultInjector.parse(
        fault_spec, seed=seed), **engine_kwargs)
    oracle = ServeEngine(cfg, params, fault_injector=False, **engine_kwargs)
    return live, oracle


def run_chaos(fault_spec: str, seed: int, n_requests: int, qps: float,
              deadline: Deadline, cfg, params, engine_kwargs: Dict
              ) -> Tuple[Dict, List[str]]:
    import asyncio

    from repro_torch.serve.async_engine import AsyncServeEngine
    from repro_torch.serve.gateway import (ByteTokenizer, Gateway,
                                           GatewayModel, Router)

    live, oracle_eng = build_engines(fault_spec, seed, cfg, params,
                                     engine_kwargs)

    # oracle pass first: the exact expected tokens of every request
    oracle_reqs = workload(cfg.vocab, n_requests, seed=seed)
    for r in oracle_reqs:
        oracle_eng.submit(r)
    oracle_eng.run_until_done()
    oracle_out = [list(r.out) for r in oracle_reqs]
    del oracle_eng

    reqs = workload(cfg.vocab, n_requests, seed=seed)
    arrivals = poisson_arrivals(n_requests, max(qps, 1e-9), seed + 1)
    model = GatewayModel(model_id=cfg.name,
                         async_engine=AsyncServeEngine(live,
                                                       model_id=cfg.name),
                         tokenizer=ByteTokenizer(cfg.vocab))

    async def collect(host, port, payload) -> Tuple[List[int], str, List]:
        got = await sse_request(host, port, payload)
        if got["status"] != 200:
            return [], ("shed" if got["status"] in (429, 503)
                        else f"http_{got['status']}"), []
        sse = check_sse(got["raw"], prompt_tokens=len(payload["prompt"]))
        return (sse["token_ids"], sse["finish_reason"] or "NO_TERMINAL",
                sse["errors"])

    async def drive():
        async with Gateway(Router([model]), port=0) as gw:
            served_id = await _served_model_id(gw.host, gw.port)

            async def one(i: int):
                await asyncio.sleep(float(arrivals[i]))
                r = reqs[i]
                try:
                    return await asyncio.wait_for(
                        collect(gw.host, gw.port, completion_payload(
                            served_id, r.prompt, r.max_new, r.sampling)),
                        timeout=max(deadline.remaining, 1.0))
                except asyncio.TimeoutError:
                    return [], "HUNG", []
            return await asyncio.gather(*[one(i) for i in range(n_requests)])

    results = asyncio.run(drive())

    failures: List[str] = []
    outcomes: Dict[str, int] = {}
    for i, (ids, finish, errs) in enumerate(results):
        key = finish.split(":", 1)[0]
        outcomes[key] = outcomes.get(key, 0) + 1
        failures.extend(f"request {i}: {e}" for e in errs
                        if not e.startswith("no terminal chunk"))
        if finish == "HUNG":
            failures.append(f"request {i}: stream hung past the deadline")
        elif finish == "NO_TERMINAL":
            failures.append(f"request {i}: SSE stream ended without a "
                            "terminal event")
        elif finish in ("length", "stop") and ids != oracle_out[i]:
            failures.append(
                f"request {i}: survived but diverged from the fault-free "
                f"oracle: {ids} != {oracle_out[i]}")

    # drain check: with every stream terminal, both tiers must be empty
    live.release_prefix_cache()
    leaks = live.check_invariants()
    host_used = live.store.host.num_used
    if live.pool.num_used != 0:
        failures.append(f"{live.pool.num_used} device blocks leaked "
                        "after drain")
    if host_used != 0:
        failures.append(f"{host_used} host blocks leaked after drain")
    if live.pool.num_reserved != 0:
        failures.append(f"reservation ledger nonzero after drain: "
                        f"{live.pool.num_reserved}")
    failures.extend(f"invariant violation at drain: {e}" for e in leaks)
    failures.extend(f"invariant violation during recovery: {e}"
                    for e in live.invariant_violations)
    if model.async_engine.fault is not None:
        failures.append(f"stepper thread died: {model.async_engine.fault}")

    m = live.metrics()
    report = {
        "fault_spec": fault_spec,
        "fault_seed": seed,
        "requests": n_requests,
        "qps": qps,
        "arch": cfg.name,
        "unix_time": time.time(),
        "outcomes": outcomes,
        "fault_counts": live.faults.counts(),
        "step_crashes": m.step_crashes,
        "swap_failures": m.swap_failures,
        "requests_errored": m.requests_errored,
        "requests_expired": m.requests_expired,
        "requests_shed": m.requests_shed,
        "degraded": m.degraded,
        "survivors": sum(1 for ids, f, _ in results
                         if f in ("length", "stop")),
        "failures": failures,
    }
    return report, failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config at the reference chaos lane's "
                         "engine sizes")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (cuda without a card "
                         "raises)")
    ap.add_argument("--fault", default="",
                    help="fault spec (site:mode=value,...); default: the "
                         "REPRO_FAULT env var, else a stock chaos mix")
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("REPRO_FAULT_SEED", "0")))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--qps", type=float, default=8.0)
    ap.add_argument("--deadline-s", type=float, default=300.0,
                    help="whole-run wall-clock budget (0 = unlimited)")
    ap.add_argument("--out", default="chaos_report.json")
    args = ap.parse_args(argv)

    # consume (don't inherit) the env spec: the oracle engine and any other
    # ServeEngine built in this process must stay fault-free
    spec = args.fault or os.environ.pop("REPRO_FAULT", "") or DEFAULT_FAULT
    deadline = Deadline(args.deadline_s or None)

    report, failures = run_chaos(
        spec, args.seed, args.requests, args.qps, deadline,
        **chaos_setup(args.arch, args.smoke, args.device))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"chaos over {args.requests} requests under {spec!r} "
          f"(seed {args.seed}): outcomes {report['outcomes']}, "
          f"{report['step_crashes']} step crashes, "
          f"{report['swap_failures']} swap failures, fault counts "
          f"{report['fault_counts']}")
    print(f"chaos report written to {args.out}")
    for e in failures:
        print(f"chaos_smoke_torch: FAIL: {e}", file=sys.stderr)
    if not failures:
        print("chaos_smoke_torch: all checks passed (no hangs, no leaks, "
              "survivors oracle-identical)")
    return len(failures)


if __name__ == "__main__":
    sys.exit(main())
