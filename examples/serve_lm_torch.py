"""Paged-KV serving on the PyTorch port: continuous batching with
per-request sampling, on a CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_lm_torch.py                   # card, full width
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --smoke

The port of ``examples/serve_lm.py``: the same engine settings and eight
requests through ``repro_torch.serve.engine.ServeEngine``.  ``--smoke``
serves the reduced qwen3-0.6b (the reference example's size); without it
the full-width model in its own dtype, with the paged-attention and
rmsnorm kernels on the card.  ``serve`` returns what it prints, with the
engine's KV invariants after the run.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.engine import (Request, SamplingParams,  # noqa: E402
                                      ServeEngine)
from repro_torch.serve.faults import check_kv_invariants  # noqa: E402

N_REQUESTS = 8
MAX_NEW = 12


def requests(vocab: int):
    """Eight requests, prompts of 4-10 tokens from ``default_rng(0)``, 12
    new tokens; the odd ones sampled at T 0.8 / top-40 with seed i."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        prompt = rng.integers(1, vocab, size=int(rng.integers(4, 10))).tolist()
        # half greedy, half temperature sampling — per-request strategies
        sp = SamplingParams() if i % 2 == 0 else \
            SamplingParams(temperature=0.8, top_k=40, seed=i)
        reqs.append(Request(rid=i, prompt=prompt, max_new=MAX_NEW,
                            sampling=sp))
    return reqs


def serve(cfg, params, on_engine=None) -> dict:
    """Serve ``requests`` on ``params`` (the device they live on) at
    ``max_batch=4, max_len=64, block_size=8``; ``on_engine(engine)`` runs
    before the first request is submitted (a caller's hooks, such as one
    counting the model calls)."""
    eng = ServeEngine(cfg, params, max_batch=4, max_len=64, block_size=8)
    if on_engine is not None:
        on_engine(eng)
    for r in requests(cfg.vocab):
        eng.submit(r)
    finished = eng.run_until_done()
    m = eng.metrics()
    print(m.summary())
    print(f"dense slot cache would pin {m.dense_equiv_blocks} blocks; "
          f"paged peak was {m.peak_blocks_used}")
    for r in finished[:3]:
        mode = "greedy" if r.sampling.temperature <= 0 else \
            f"T={r.sampling.temperature}/top{r.sampling.top_k}"
        print(f"  req {r.rid} ({mode}): prompt {r.prompt} -> {r.out}")
    return {"outputs": {r.rid: list(r.out) for r in finished},
            "prompts": {r.rid: list(r.prompt) for r in finished},
            "greedy": sorted(r.rid for r in finished
                             if r.sampling.temperature <= 0),
            "summary": m.summary(), "tokens_per_sec": m.tokens_per_sec,
            "dense_equiv_blocks": m.dense_equiv_blocks,
            "peak_blocks_used": m.peak_blocks_used,
            "kv_violations": check_kv_invariants(eng)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (CPU-runnable)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen3-0.6b")
    if args.smoke:
        cfg = reduced_config(cfg)
    return serve(cfg, build_model(cfg, device).init(0))


if __name__ == "__main__":
    main()
