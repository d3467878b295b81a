"""Boot the OpenAI-compatible HTTP gateway over one or more serve engines,
on a CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.gateway --arch qwen3-0.6b \
        --device cuda --port 8011

    # two models multiplexed by one router (ids default to the cfg names):
    PYTHONPATH=src python -m repro_torch.launch.gateway --smoke --device cpu \
        --arch qwen3-0.6b --arch stablelm-3b --port 8011

Prints ``gateway listening on http://HOST:PORT`` once ready (clients poll
``/health``), serves until SIGINT/SIGTERM, then prints ``gateway shut down
cleanly`` and exits 0.  Same CLI as ``repro.launch.gateway`` with three
differences: ``--device`` (default cuda; asking for cuda without a card is
an error, never a move to the CPU), the weights are random from seed 0
(``build_model(cfg, device).init(0)``), and ``--mesh N`` with N > 0 is
refused (multi-device serving is ROADMAP A10).
"""
from __future__ import annotations

import argparse
import asyncio
import signal


def build_router(archs, smoke: bool, device: str, max_batch: int,
                 max_len: int, block_size: int, plan_kernels: bool):
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model as build_model_fns
    from repro_torch.serve.gateway import build_model, Router

    dev = resolve_device(device)
    models = []
    for arch in archs:
        cfg = get_config(arch)
        if smoke:
            cfg = reduced_config(cfg)
        params = build_model_fns(cfg, dev).init(0)
        models.append(build_model(
            cfg, params, max_batch=max_batch, max_len=max_len,
            block_size=block_size, plan_kernels=plan_kernels))
    return Router(models)


async def serve(args) -> None:
    from repro_torch.serve.gateway import Gateway

    router = build_router(
        args.arch or ["qwen3-0.6b"], smoke=args.smoke, device=args.device,
        max_batch=args.max_batch, max_len=args.max_len,
        block_size=args.block_size, plan_kernels=not args.no_plan_kernels)
    gw = Gateway(router, host=args.host, port=args.port)
    await gw.start()
    ids = ", ".join(m.model_id for m in router.models())
    print(f"gateway listening on {gw.url} (models: {ids})", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await gw.stop()
    print("gateway shut down cleanly", flush=True)


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
                    help="not ported: N > 0 raises (ROADMAP A10)")
    ap.add_argument("--no-plan-kernels", action="store_true",
                    help="skip the pipeline compile of the paged attention "
                         "shapes (faster boot; smoke/test use)")
    args = ap.parse_args(argv)
    if args.mesh > 0:
        ap.error(f"--mesh {args.mesh}: multi-device serving is not ported "
                 "to repro_torch yet (ROADMAP A10)")
    asyncio.run(serve(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
