"""Multi-pod dry run (the port of ``src/repro/launch/dryrun.py``): count
every (arch x shape) cell's step on the production meshes on ``meta``
tensors and record its per-device FLOPs, bytes, collectives, memory and
roofline terms on the H100 record.

A cell builds the arch's abstract weights (``model_zoo.abstract_params``),
their training layout on a virtual mesh (``launch.mesh.dry_train_mesh`` of
``production_mesh_shape``: 16 x 16, or 2 x 16 x 16 with "pod" folded into
"data"), rank 0's shards, moments and batch slice, and runs the port's own
mesh train step (``launch.steps.make_train_step(mesh=)``) once under
``hlo_analysis.analyze_step``, with the knobs as they are
(``perf.knob_snapshot`` is recorded; the defaults are remat "dots", f32
moments, fsdp_tp).  Nothing is stored or computed: the counts come from the
ops the step dispatches and from the kernel wrappers' reports.  Only the
``train`` shapes are ported (ROADMAP A13a); prefill and decode cells need
steps that take a mesh (A13b).

One cell:  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh pod1
All cells: python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json, with the
reference's fields where they mean the same (``hlo_flops_per_device`` and
``hlo_bytes_per_device`` are the dispatched ops' counts) and the port's
memory fields (``argument_bytes_per_device``, ``peak_bytes_per_device``,
``fits``); existing files are skipped, so ``--all`` resumes where it
stopped.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _not_ported(spec) -> NotImplementedError:
    return NotImplementedError(
        f"dry run of a {spec.kind} shape ({spec.name}): only train shapes "
        "are ported; prefill and decode wait for ROADMAP A13b")


def cell_mesh(mesh_kind: str):
    """The virtual training mesh of a production mesh ("pod1", "pod2")."""
    from repro_torch.launch.mesh import dry_train_mesh, production_mesh_shape
    if mesh_kind not in ("pod1", "pod2"):
        raise ValueError(f"mesh {mesh_kind!r} is not pod1 or pod2")
    return dry_train_mesh(
        production_mesh_shape(multi_pod=mesh_kind == "pod2").shape)


def count_train_step(cfg, spec, mesh, hw=None, opt_cfg=None) -> dict:
    """``analyze_step`` of one train step of ``cfg`` at ``spec``'s global
    batch and sequence on rank 0 of ``mesh`` (a ``DryTrainMesh``), every
    tensor on ``meta``; AdamW as ``opt_cfg`` says (default: as
    REPRO_OPT_STATE)."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model_zoo import abstract_params, input_specs
    from repro_torch.train.trainer import check_mesh_trains
    check_mesh_trains(cfg, mesh)
    step, opt = make_train_step(cfg, opt_cfg, device=torch.device("meta"),
                                mesh=mesh)
    params = abstract_params(cfg)
    layout = sharding.train_layout(cfg, params, mesh, opt.cfg.state_dtype,
                                   opt.cfg.quant_block)
    local = sharding.shard_tree(params, layout.params, mesh)
    del params
    state = opt.init(local, layout)
    batch = input_specs(cfg, spec)
    bspecs = sharding.batch_specs(cfg, batch, mesh)
    batch = sharding.shard_tree(batch, bspecs, mesh)
    split = any(e is not None for e in bspecs["labels"])
    return analyze_step(step, local, state, batch, layout, split, mesh=mesh,
                        hw=hw)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_path: Path,
             hw=None) -> dict:
    from repro_torch.configs.base import SHAPES, cell_is_runnable, get_config
    from repro_torch.launch.hlo_analysis import roofline_terms
    from repro_torch.perf import knob_snapshot
    if hw is None:
        from repro_torch.core.hardware import H100 as hw

    t0 = time.time()
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "kind": spec.kind, "seq_len": spec.seq_len,
              "global_batch": spec.global_batch,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "perf_knobs": knob_snapshot(), "hardware": hw.name}

    ok, why = cell_is_runnable(cfg, spec)
    if not ok:
        result["status"] = "skipped"
        result["skip_reason"] = why
        out_path.write_text(json.dumps(result, indent=1))
        return result
    if spec.kind != "train":
        raise _not_ported(spec)

    mesh = cell_mesh(mesh_kind)
    n_dev = mesh.world
    result["devices"] = n_dev
    result["mesh_shape"] = dict(mesh.shape)
    analysis = count_train_step(cfg, spec, mesh, hw)

    result["status"] = "ok"
    result["analyze_s"] = round(time.time() - t0, 2)
    result["hlo_flops_per_device"] = analysis["flops"]
    result["hlo_bytes_per_device"] = analysis["bytes_traffic"]
    result["collectives"] = analysis["collectives"]
    result["roofline"] = roofline_terms(analysis, hw)
    result["argument_bytes_per_device"] = analysis["argument_bytes"]
    result["peak_bytes_per_device"] = analysis["peak_bytes"]
    result["fits"] = analysis["peak_bytes"] <= hw.hbm_bytes
    result["launches"] = analysis["launches"]
    # model flops: 6 N_active D for a training step (forward and backward)
    tokens = spec.global_batch * spec.seq_len
    model_flops = 6 * cfg.active_param_count() * tokens
    result["model_flops_global"] = float(model_flops)
    hlo_flops_global = analysis["flops"] * n_dev
    result["model_vs_hlo_flops"] = (
        float(model_flops / hlo_flops_global) if hlo_flops_global else None)
    out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "collectives"},
                     indent=1))
    print("collectives:", json.dumps(analysis["collectives"]))
    return result


# ---------------------------------------------------------------------------
# Every cell
# ---------------------------------------------------------------------------

def all_cells(meshes):
    """(arch, shape, mesh) of every ported cell: the ``train`` shapes."""
    from repro_torch.configs.base import SHAPES, list_archs
    for arch in list_archs():
        for shape, spec in SHAPES.items():
            if spec.kind != "train":
                continue
            for mesh in meshes:
                yield arch, shape, mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the result files")
    args = ap.parse_args(argv)
    results = Path(args.out)
    results.mkdir(parents=True, exist_ok=True)

    if args.all:
        meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
        todo = list(all_cells(meshes))
        for i, (arch, shape, mesh) in enumerate(todo):
            out = results / f"{arch}__{shape}__{mesh}.json"
            if out.exists():
                continue
            print(f"[{i+1}/{len(todo)}] {arch} x {shape} x {mesh}", flush=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(results)]
            try:
                r = subprocess.run(cmd, timeout=args.timeout,
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    err = (r.stderr or "")[-3000:]
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mesh,
                         "status": "error", "error": err}, indent=1))
                    print(f"  ERROR (see {out})", flush=True)
                else:
                    print("  ok", flush=True)
            except subprocess.TimeoutExpired:
                out.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "mesh": mesh,
                     "status": "timeout"}, indent=1))
                print("  TIMEOUT", flush=True)
        return

    if args.mesh == "both":
        ap.error("one cell runs on one mesh: pod1 or pod2")
    from repro_torch.configs.base import SHAPES
    spec = SHAPES[args.shape]
    if spec.kind != "train":
        raise _not_ported(spec)
    out = results / f"{args.arch}__{args.shape}__{args.mesh}.json"
    try:
        run_cell(args.arch, args.shape, args.mesh, out)
    except Exception:
        out.write_text(json.dumps(
            {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
             "status": "error", "error": traceback.format_exc()[-4000:]},
            indent=1))
        raise


if __name__ == "__main__":
    main()
