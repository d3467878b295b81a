"""Boot the OpenAI-compatible HTTP gateway over one or more serve engines,
on a CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.gateway --arch qwen3-0.6b \
        --device cuda --port 8011

    # two models multiplexed by one router (ids default to the cfg names):
    PYTHONPATH=src python -m repro_torch.launch.gateway --smoke --device cpu \
        --arch qwen3-0.6b --arch stablelm-3b --port 8011

    # the same router over a 2-rank serve mesh (KV pools on kv-heads):
    PYTHONPATH=src python -m repro_torch.launch.gateway --mesh 2 \
        --device cuda --arch qwen3-0.6b --arch olmoe-1b-7b --port 8011

Prints ``gateway listening on http://HOST:PORT`` once ready (clients poll
``/health``), serves until SIGINT/SIGTERM, then prints ``gateway shut down
cleanly`` and exits 0.  Same CLI as ``repro.launch.gateway`` with two
differences: ``--device`` (default cuda; asking for cuda without a card is
an error, never a move to the CPU), and the weights are random from seed 0
(``build_model(cfg, device).init(0)``).

``--mesh N`` builds every engine over one N-rank serve mesh, as
``repro.launch.gateway`` does: the KV pools sharded on kv-heads, the
weights tensor-parallel only under REPRO_SERVE_TP=1.  The launcher spawns N
processes, one a rank (``launch.mesh.spawn_ranks``: gloo on ``--device
cpu``; on cuda, NCCL with one rank a card when N cards are visible, else
gloo with every rank on ``cuda:0``).  Rank 0 runs the HTTP gateway and one
stepper thread an engine; the other ranks run no HTTP and replay rank 0's
steps (``serve.engine.follow_all``).  SIGINT/SIGTERM to the launcher reach
rank 0, which stops the gateway and closes the engines, releasing the
other ranks; the launcher then collects the ranks, stops the fork server
(``launch.mesh.stop_rank_server``) and prints the shutdown line, leaving
no process running.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import signal
import threading


def build_engines(archs, smoke: bool, device, max_batch: int, max_len: int,
                  block_size: int, plan_kernels: bool, mesh=None):
    """One ``ServeEngine`` an arch, in ``archs`` order (every rank of a
    mesh builds the same list; rank 0 wraps it in the router).  ``mesh``
    None defers to REPRO_SERVE_MESH."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model as build_model_fns
    from repro_torch.serve.engine import ServeEngine

    dev = resolve_device(device)
    engines = []
    for arch in archs:
        cfg = get_config(arch)
        if smoke:
            cfg = reduced_config(cfg)
        params = build_model_fns(cfg, dev).init(0)
        engines.append(ServeEngine(
            cfg, params, max_batch=max_batch, max_len=max_len,
            block_size=block_size, plan_kernels=plan_kernels, mesh=mesh))
    return engines


def build_router(archs, smoke: bool, device, max_batch: int, max_len: int,
                 block_size: int, plan_kernels: bool, mesh=None):
    from repro_torch.serve.gateway import Router, wrap_engine
    return Router([wrap_engine(eng) for eng in build_engines(
        archs, smoke, device, max_batch, max_len, block_size, plan_kernels,
        mesh)])


def _engine_args(args) -> dict:
    return dict(smoke=args.smoke, max_batch=args.max_batch,
                max_len=args.max_len, block_size=args.block_size,
                plan_kernels=not args.no_plan_kernels)


def _stop_on_signals() -> threading.Event:
    """An event SIGINT and SIGTERM set from now on: installed before the
    engines build, so a signal that comes meanwhile still ends the run
    cleanly."""
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    return stop


async def serve(args, stop: threading.Event, device=None,
                mesh=None) -> None:
    """Serve until ``stop`` is set (``_stop_on_signals``)."""
    from repro_torch.serve.gateway import Gateway

    router = build_router(args.arch or ["qwen3-0.6b"],
                          device=device or args.device, mesh=mesh,
                          **_engine_args(args))
    gw = Gateway(router, host=args.host, port=args.port)
    await gw.start()
    ids = ", ".join(m.model_id for m in router.models())
    where = "" if mesh is None else f" over a {mesh.n_model}-rank mesh"
    print(f"gateway listening on {gw.url} (models: {ids}){where}",
          flush=True)

    await asyncio.to_thread(stop.wait)
    # stops every stepper, and each closes its engine: on a mesh that
    # releases the other ranks from following it
    await gw.stop()


def _gateway_rank(mesh, device, args) -> dict:
    """One rank of ``--mesh``: rank 0 serves HTTP until a signal, the
    others follow its engines until rank 0 closes them."""
    import torch
    from repro_torch.serve.engine import follow_all
    if mesh.rank == 0:
        asyncio.run(serve(args, _stop_on_signals(), device=device,
                          mesh=mesh))
        return {"rank": 0, "peak_bytes": _peak(device)}
    # the launcher's signals go to rank 0 only
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, signal.SIG_IGN)
    with torch.no_grad():
        engines = build_engines(args.arch or ["qwen3-0.6b"], device=device,
                                mesh=mesh, **_engine_args(args))
        steps = follow_all(engines)
    return {"rank": mesh.rank, "steps": steps, "peak_bytes": _peak(device)}


def _peak(device) -> int:
    """The rank's peak device memory (0 on the CPU)."""
    import torch
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _serve_mesh(args) -> list:
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (serve_backend, spawn_ranks,
                                         stop_rank_server)

    resolve_device(args.device)      # cuda without a card raises here
    n = args.mesh
    backend = serve_backend(n, args.device)
    if args.device == "cuda" and backend == "gloo" and n > 1:
        print(f"{n} ranks share cuda:0 over gloo (fewer than {n} cards "
              "visible; NCCL refuses two ranks on one card)", flush=True)
    ranks, pending = [], []

    def forward(sig, _frame):
        # to rank 0, which stops the gateway; held until the ranks run
        if ranks and ranks[0].is_alive():
            os.kill(ranks[0].pid, sig)
        elif not ranks:
            pending.append(sig)

    def started(procs):
        ranks.extend(procs)
        for sig in pending:
            forward(sig, None)

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, forward)
    try:
        outs = spawn_ranks(_gateway_rank, n, backend, args.device,
                           args=(args,), timeout_s=float("inf"),
                           started=started)
    finally:
        stop_rank_server()
    print(f"{n} ranks over {backend} on {args.device}: followers ran "
          f"{[o.get('steps') for o in outs[1:]]} steps; peak device bytes "
          f"by rank {[o['peak_bytes'] for o in outs]}", flush=True)
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="model arch to serve; repeatable — each becomes "
                         "one routed model id (default: qwen3-0.6b)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced per-arch configs (CPU test size)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks an ephemeral port (printed when ready)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--mesh", type=int, default=0,
                    help="N >= 1: every engine over one N-rank serve mesh "
                         "(KV pools on kv-heads; TP weights under "
                         "REPRO_SERVE_TP=1), one process a rank; 0 defers "
                         "to REPRO_SERVE_MESH")
    ap.add_argument("--no-plan-kernels", action="store_true",
                    help="skip the pipeline compile of the paged attention "
                         "shapes (faster boot; smoke/test use)")
    args = ap.parse_args(argv)
    if args.mesh >= 1:
        _serve_mesh(args)
    else:
        asyncio.run(serve(args, _stop_on_signals()))
    print("gateway shut down cleanly", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
