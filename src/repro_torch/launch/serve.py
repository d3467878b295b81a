"""Serving entry point of the port: paged-KV continuous batching over synthetic
prompts, on a CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --device cuda --requests 8 --max-new 16

Same CLI as ``repro.launch.serve`` with three differences: ``--device``
(default cuda; asking for cuda without a card is an error), ``--dtype``
(default: the config's, bf16 for the registered archs), and no ``--mesh`` /
``--tp`` (multi-device serving is a later slice).  Without ``--smoke`` it
serves the arch at its full width with random weights from ``--seed``.
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
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine


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
    ap.add_argument("--mesh", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tp", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)
    if args.mesh or args.tp:
        ap.error("--mesh/--tp: multi-device serving is not ported to "
                 "repro_torch yet (ROADMAP A10)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = build_model(cfg, device).init(args.seed)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len, block_size=args.block_size,
                      num_blocks=args.num_blocks or None,
                      prefill_chunk_tokens=args.prefill_chunk or None,
                      admission=args.admission,
                      host_blocks=None if args.host_blocks < 0 else args.host_blocks,
                      prefix_cache_blocks=None if args.prefix_cache_blocks < 0
                      else args.prefix_cache_blocks)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=int(rng.integers(4, 12))).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new,
                           sampling=SamplingParams(temperature=args.temperature,
                                                   top_k=args.top_k,
                                                   seed=args.seed + i)))
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
