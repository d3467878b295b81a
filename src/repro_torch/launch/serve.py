"""Serving entry point of the port: paged-KV continuous batching over synthetic
prompts, on a CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --device cuda --requests 8 --max-new 16

Same CLI as ``repro.launch.serve`` with two additions: ``--device``
(default cuda; asking for cuda without a card is an error) and ``--dtype``
(default: the config's, bf16 for the registered archs).  Without
``--smoke`` it serves the arch at its full width with random weights from
``--seed``.

``--mesh N`` shards the KV block pool over N ranks on the kv-heads axis,
and ``--tp N`` also stores the weights tensor-parallel over them
(REPRO_TP_REDUCE_SCATTER picks how they compute): N processes, one a rank
(``launch.mesh.spawn_ranks``), gloo on ``--device cpu``; on cuda, NCCL with
one rank a card when N cards are visible, else gloo with every rank on
``cuda:0`` (printed).  Rank 0 submits the workload and prints; the ranks'
tokens must be equal.  A dense arch only (the engine refuses the others
on a mesh).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh 2 --tp 2
The dense archs, ``olmoe-1b-7b`` and ``llama4-maverick-400b-a17b`` (moe;
llama4 at full width does not fit one 80 GB card), ``falcon-mamba-7b``
(ssm) and ``zamba2-2.7b`` (hybrid) are served; a stateful arch's prefill
chunk is rounded up to its scan granule.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import serve_backend, spawn_ranks
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine


def _config(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    return cfg


def _engine(args, cfg, device, **kw):
    params = build_model(cfg, device).init(args.seed)
    return ServeEngine(cfg, params, max_batch=args.max_batch,
                       max_len=args.max_len, block_size=args.block_size,
                       num_blocks=args.num_blocks or None,
                       prefill_chunk_tokens=args.prefill_chunk or None,
                       admission=args.admission,
                       host_blocks=None if args.host_blocks < 0
                       else args.host_blocks,
                       prefix_cache_blocks=None if args.prefix_cache_blocks < 0
                       else args.prefix_cache_blocks, **kw)


def _submit_workload(args, cfg, eng) -> list:
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=int(rng.integers(4, 12))).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new=args.max_new,
                            sampling=SamplingParams(
                                temperature=args.temperature,
                                top_k=args.top_k, seed=args.seed + i)))
        eng.submit(reqs[-1])
    return reqs


def _serve_rank(mesh, device, args) -> dict:
    """One rank of ``--mesh``/``--tp``: rank 0 serves the workload, the
    others follow it.  Returns the rank's tokens by request and metrics."""
    import torch
    cfg = _config(args)
    with torch.no_grad():
        eng = _engine(args, cfg, device, mesh=mesh,
                      tp=True if args.tp >= 1 else None)
        if eng.is_leader:
            _submit_workload(args, cfg, eng)
            try:
                eng.run_until_done()
            finally:
                eng.close()
        else:
            eng.follow()
    return {"tokens": {r.rid: list(r.out) for r in eng.finished},
            "metrics": eng.metrics().to_dict(),
            "summary": eng.metrics().summary(),
            "invariants": eng.check_invariants()}


def _serve_mesh(args, n: int) -> list:
    resolve_device(args.device)
    cfg = _config(args)
    if cfg.family != "dense":
        raise SystemExit(f"--mesh/--tp: the {cfg.family} family is served "
                         "on one device (see ROADMAP A10c)")
    backend = serve_backend(n, args.device)
    if args.device == "cuda" and backend == "gloo" and n > 1:
        print(f"{n} ranks share cuda:0 over gloo (fewer than {n} cards "
              "visible; NCCL refuses two ranks on one card)")
    outs = spawn_ranks(_serve_rank, n, backend, args.device, args=(args,))
    for r, out in enumerate(outs):
        if out["tokens"] != outs[0]["tokens"]:
            raise RuntimeError(f"rank {r}'s tokens differ from rank 0's")
        if out["invariants"]:
            raise RuntimeError(f"rank {r}: {out['invariants']}")
    m = outs[0]["metrics"]
    print(f"{n} ranks over {backend} on {args.device}: {outs[0]['summary']}")
    if m["tp_devices"] > 1:
        print(f"tensor parallel x{m['tp_devices']}: "
              f"{m['param_bytes_per_device'] / 1e6:.2f} MB/rank of "
              f"{m['param_bytes_replicated'] / 1e6:.2f} MB params")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(m, f, indent=2)
        print(f"metrics written to {args.metrics_out}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                    help="activation/weight dtype (default: the config's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool size in blocks (0 = dense-capacity parity)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens prefilled per engine step "
                         "(0 = one block)")
    ap.add_argument("--admission", choices=["conservative", "optimistic"],
                    default="conservative")
    ap.add_argument("--host-blocks", type=int, default=-1,
                    help="host swap-tier size in blocks (-1 = pool-sized, "
                         "0 = no swap tier; see REPRO_KV_SWAP)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=-1,
                    help="blocks retained for prompt-prefix sharing "
                         "(-1 = pool/4, 0 = sharing off)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the KV pool over this many ranks on the "
                         "kv-heads axis (0 = one device)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel: shard the weights AND the KV pool "
                         "over this many ranks (implies --mesh N)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)
    n = max(args.mesh, args.tp)
    if n >= 1:
        return _serve_mesh(args, n)

    device = resolve_device(args.device)
    cfg = _config(args)
    eng = _engine(args, cfg, device)
    _submit_workload(args, cfg, eng)
    eng.run_until_done()
    m = eng.metrics()
    print(f"device {device}: {m.summary()}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(m.to_dict(), f, indent=2)
        print(f"metrics written to {args.metrics_out}")
    return eng


if __name__ == "__main__":
    main()
