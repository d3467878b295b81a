"""Compile inspection on the PyTorch port: the pipeline report for one arch's
attention block, its program run once on a CUDA card (``--device cpu``:
on the CPU), then, unless ``--pipeline-only``, the dry run of the
(arch x shape) cell on the production mesh.

    PYTHONPATH=src python examples/compile_inspect_torch.py --arch qwen3-0.6b --shape decode_32k
    PYTHONPATH=src python examples/compile_inspect_torch.py --device cpu --smoke --pipeline-only

The port of ``examples/compile_inspect.py``.  The dry run counts the
port's own mesh step on meta tensors in this process
(``repro_torch.launch.dryrun.run_cell``): it needs no fake devices and no
second process.  Its result file goes to ``--out`` (default: a temporary
directory).  ``--smoke`` compiles the reduced config's head width at a
sequence capped at 512 (the full config's, capped at 4,096, without it);
the dry-run cell is always the full arch's.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import (SHAPES, get_config,  # noqa: E402
                                      reduced_config)
from repro_torch.core.codegen import compile_term  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.pipeline import CompileOptions, compile  # noqa: E402
from repro_torch.serve.engine import attention_block_term  # noqa: E402


def pipeline_report(arch: str, shape: str, device: torch.device,
                    smoke: bool = False) -> dict:
    """Term-level compile of the arch's attention block through
    ``repro_torch.pipeline``, with per-pass telemetry; the compiled program
    run once on ``device`` against the logical term's."""
    cfg = get_config(arch)
    if smoke:
        cfg = reduced_config(cfg)
    spec = SHAPES[shape]
    # cap the modeled sequence so the e-graph stays inspection-sized
    seq = min(spec.seq_len, 512 if smoke else 4096)
    hd = cfg.resolved_head_dim
    term = attention_block_term(seq, hd)
    res = compile(term, options=CompileOptions(extraction="greedy"))
    print(f"=== pipeline report: {arch} attention block "
          f"(seq {seq} x head_dim {hd}) ===")
    print(res.report.summary())
    gen = torch.Generator().manual_seed(0)
    env = {n: (torch.randn(s, generator=gen) * 0.1).to(device)
           for n, s in (("Q", (seq, hd)), ("K", (hd, seq)), ("V", (seq, hd)))}
    want = compile_term(term)(**env)
    err = float((res(**env) - want).abs().max() / want.abs().max())
    print(f"  program on {device.type}: max abs err vs the logical term "
          f"{err:.2e} of its largest value")
    return {"seq": seq, "head_dim": hd, "summary": res.report.summary(),
            "modeled_speedup": res.report.modeled_speedup, "rel_err": err}


def dryrun_cell(arch: str, shape: str, mesh: str, out_dir: str) -> dict:
    """The dry run of one cell on meta tensors (``dryrun.run_cell``): its
    result, written to ``out_dir``."""
    out = Path(out_dir) / f"{arch}__{shape}__{mesh}.json"
    return dryrun.run_cell(arch, shape, mesh, out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="pod1")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="skip the dry run of the cell")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="compile the reduced config's block (CPU-runnable)")
    ap.add_argument("--out", default=None,
                    help="directory of the dry run's result file")
    args = ap.parse_args(argv)

    out = {"pipeline": pipeline_report(args.arch, args.shape,
                                       resolve_device(args.device),
                                       args.smoke)}
    if args.pipeline_only:
        return out
    out["dryrun"] = dryrun_cell(args.arch, args.shape, args.mesh,
                                args.out or tempfile.mkdtemp(
                                    prefix="dryrun_cell_"))
    if out["dryrun"]["status"] != "ok":
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
