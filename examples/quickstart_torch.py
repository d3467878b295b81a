"""Quickstart on the PyTorch port: the full nncase pipeline in one call, Auto
Distribution and Auto Schedule, and one loss of a model, on a CUDA card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py                 # card, full width
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --smoke

The port of ``examples/quickstart.py``: the same demos, on
``repro_torch.pipeline`` and the H100 hardware record.  The packed program
is held to the logical term run by ``core.codegen.compile_term``, whose
matmuls launch the hand-written matmul kernel on a CUDA card (its plain
version on the CPU).  ``--smoke`` computes the loss of the reduced
qwen3-0.6b (the reference example's size); without it the full-width
model in its own dtype.  Every demo returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.core.codegen import compile_term  # noqa: E402
from repro_torch.core.distribution import ndsbp_to_pspec  # noqa: E402
from repro_torch.core.tensor_ir import inp, matmul, unary  # noqa: E402
from repro_torch.core.vectorize import count_ops  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import matmul as matmul_kernel  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.pipeline import CompileTarget, Compiler  # noqa: E402


def fig3_term():
    """O = MatMul(Exp(MatMul(Q, K)), V) — the paper's running example."""
    Q, K, V = inp("Q", (1024, 128)), inp("K", (128, 1024)), inp("V", (1024, 128))
    return matmul(unary(matmul(Q, K), kind="exp"), V)


def demo_pipeline(compiler: Compiler, device: torch.device) -> dict:
    print("=== One-call pipeline (Fig. 3): O = MatMul(Exp(MatMul(Q,K)), V) ===")
    term = fig3_term()
    res = compiler.compile(term)
    r = res.report
    print(f"  baseline {r.baseline_cost:.3e}s -> packed {r.optimized_cost:.3e}s "
          f"({r.modeled_speedup:.1f}x modeled)")
    pack, unpack = count_ops(res.term, "pack"), count_ops(res.term, "unpack")
    print(f"  pack ops: {pack} (inputs only), unpack: {unpack} (output only) "
          "— blocked layout passes through Exp")
    print("  pass times: " + " ".join(
        f"{k}={v * 1e3:.1f}ms" for k, v in r.pass_times.items()))
    # semantics preserved vs. the unoptimized logical term, whose matmuls
    # run the matmul kernel on a card
    rng = np.random.default_rng(0)
    env = {n: torch.from_numpy(rng.normal(size=s) * 0.1).float().to(device)
           for n, s in [("Q", (1024, 128)), ("K", (128, 1024)),
                        ("V", (1024, 128))]}
    launches = matmul_kernel.launches
    logical = compile_term(term, use_kernels=True)(**env)
    launches = matmul_kernel.launches - launches
    err = float((res(**env) - logical).abs().max())
    rel = err / float(logical.abs().max())
    print(f"  max abs err packed-vs-logical: {err:.2e} ({rel:.2e} of the "
          f"largest; {launches} matmul kernel launches on {device.type})")
    res2 = compiler.compile(term)
    print(f"  recompile: cache_hit={res2.report.cache_hit} "
          f"({res2.report.total_seconds * 1e3:.1f}ms vs "
          f"{res.report.total_seconds * 1e3:.1f}ms cold)")
    return {"modeled_speedup": r.modeled_speedup, "pack_ops": pack,
            "unpack_ops": unpack, "max_abs_err": err, "rel_err": rel,
            "matmul_launches": launches, "cache_hit": res2.report.cache_hit,
            "cold_s": r.total_seconds, "hit_s": res2.report.total_seconds}


def demo_auto_distribute(compiler: Compiler) -> dict:
    print("=== Auto Distribution (SBP search on a 4x4 mesh) ===")
    x = inp("x", (4096, 1024))
    w1, w2 = inp("w1", (1024, 4096)), inp("w2", (4096, 1024))
    y = matmul(unary(matmul(x, w1), kind="exp"), w2)
    mesh = dict(mesh_axes=("data", "model"), mesh_sizes=(4, 4))
    free = compiler.compile(y, target=CompileTarget(**mesh)).report.distribution
    print(f"  unconstrained: cost {free['cost']:.3e}s, "
          f"peak {free['peak_memory'] / 1e6:.1f} MB/dev")
    capped_res = compiler.compile(
        y, target=CompileTarget(**mesh, memory_capacity=25_000_000))
    capped = capped_res.report.distribution
    print(f"  25MB cap:      cost {capped['cost']:.3e}s, "
          f"peak {capped['peak_memory'] / 1e6:.1f} MB/dev")
    pl = CompileTarget(**mesh).placement
    pspecs = {}
    for tid, nd in sorted(capped["assignments"].items()):
        pspecs[tid] = ndsbp_to_pspec(nd, pl, 2)
        print(f"    term {tid:2d} -> {nd} (pspec {pspecs[tid]})")
    return {"free_cost": free["cost"], "free_peak": free["peak_memory"],
            "capped_cost": capped["cost"],
            "capped_peak": capped["peak_memory"], "pspecs": pspecs}


def demo_auto_schedule(compiler: Compiler) -> dict:
    print("=== Auto Schedule (MCTS structure + MINLP tiles) ===")
    res = compiler.compile(fig3_term())
    s = res.report.schedule
    print(f"  baseline {s['baseline_latency']:.3e}s -> scheduled {s['latency']:.3e}s")
    print(f"  fused groups: {s['groups']}")
    print(f"  kernel plan: {res.report.kernel_plan} "
          f"(smem peak {s['smem_peak'] / 2**10:.1f} KB)")
    return {"baseline_latency": s["baseline_latency"],
            "latency": s["latency"], "groups": s["groups"],
            "smem_peak": s["smem_peak"]}


def demo_train_step(device: torch.device, smoke: bool, params=None,
                    tokens=None) -> dict:
    """One loss of qwen3-0.6b (reduced with ``smoke``) on seeded weights
    (or ``params``) and tokens from an explicit ``torch.Generator`` (or
    ``tokens``, (2, 32))."""
    cfg = get_config("qwen3-0.6b")
    if smoke:
        cfg = reduced_config(cfg)
    print(f"=== One train step ({'reduced' if smoke else 'full-width'} "
          f"qwen3, {cfg.dtype}, on {device.type}) ===")
    fns = build_model(cfg, device)
    if params is None:
        params = fns.init(0)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (2, 32),
                               generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(device)
    with torch.no_grad():
        loss = float(fns.loss(params, {"tokens": tokens, "labels": tokens},
                              remat=False))
    print(f"  loss: {loss:.4f}")
    return {"loss": loss, "dtype": cfg.dtype, "n_layers": cfg.n_layers}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config for the loss (CPU-runnable)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compiler = Compiler(cache_dir=None)
    return {"pipeline": demo_pipeline(compiler, device),
            "distribute": demo_auto_distribute(compiler),
            "schedule": demo_auto_schedule(compiler),
            "train_step": demo_train_step(device, args.smoke)}


if __name__ == "__main__":
    main()
