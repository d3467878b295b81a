"""Multi-pod dry run (the port of ``src/repro/launch/dryrun.py``): count
every (arch x shape) cell's step on the production meshes on ``meta``
tensors and record its per-device FLOPs, bytes, collectives, memory and
roofline terms on the H100 record.

A cell builds the arch's abstract weights (``model_zoo.abstract_params``),
their training layout on a virtual mesh (``launch.mesh.dry_train_mesh`` of
``production_mesh_shape``: 16 x 16, or 2 x 16 x 16 with "pod" folded into
"data"), rank 0's shards and batch slice, and runs the port's own mesh
step once under ``hlo_analysis.analyze_step``, with the knobs as they are
(``perf.knob_snapshot`` is recorded; the defaults are remat "dots", f32
moments, fsdp_tp):

  * ``train``: ``launch.steps.make_train_step(mesh=)`` on the rank's
    shards, AdamW moments and batch slice;
  * ``prefill``: ``make_prefill_step(mesh=)`` on the rank's shards and
    batch slice, the cache coming back as its block of ``cache_specs``;
  * ``decode``: ``make_decode_step(mesh=)`` over the rank's block of a
    dense cache of the shape's capacity (``model_zoo.abstract_cache``
    laid out by ``cache_specs``), at ``cur_len = seq_len - 1`` passed as a
    host int.  The reference's ``cur_len`` is an abstract scalar; its
    decode attention, as the port's (``attention.decode_attention`` and
    ``mesh_decode_attention``), covers the cache's whole capacity under a
    mask, so the count does not depend on ``cur_len``.

The 16 ``long_500k`` cells of the full-attention archs are written
``skipped`` with the reference's reason (``cell_is_runnable``).  Nothing
is stored or computed: the counts come from the ops the step dispatches
and from the kernel wrappers' reports.

One cell:  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh pod1
All cells: python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json, with the
reference's fields where they mean the same (``hlo_flops_per_device`` and
``hlo_bytes_per_device`` are the dispatched ops' counts) and the port's
memory fields (``argument_bytes_per_device``, ``peak_bytes_per_device``,
``fits``; a decode cell's ``cache_bytes_per_device``, the K/V blocks,
and ``state_bytes_per_device``, the recurrent states' blocks); existing
files are skipped, so ``--all`` resumes where it stopped.
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


def _serve_args(cfg, spec, mesh):
    """The rank's weights, layout and batch slice of a prefill or decode
    step at ``spec`` on ``mesh`` (meta), with whether the batch is
    split."""
    from repro_torch.distributed import sharding
    from repro_torch.models.model_zoo import abstract_params, input_specs
    sharding.check_mesh_serves(cfg, mesh, spec)
    params = abstract_params(cfg)
    layout = sharding.train_layout(cfg, params, mesh)
    local = sharding.shard_tree(params, layout.params, mesh)
    del params
    batch = input_specs(cfg, spec)
    bspecs = sharding.batch_specs(cfg, batch, mesh)
    split = any(e is not None for sp in bspecs.values() for e in sp)
    return local, layout, sharding.shard_tree(batch, bspecs, mesh), split


def count_prefill_step(cfg, spec, mesh, hw=None) -> dict:
    """``analyze_step`` of one prefill step of ``cfg`` at ``spec``'s global
    batch and sequence on rank ``mesh.rank`` of ``mesh`` (a
    ``DryTrainMesh``), every tensor on ``meta``."""
    import torch

    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.steps import make_prefill_step
    local, layout, batch, split = _serve_args(cfg, spec, mesh)
    step = make_prefill_step(cfg, device=torch.device("meta"), mesh=mesh)
    return analyze_step(step, local, batch, layout, split, mesh=mesh, hw=hw)


def count_decode_step(cfg, spec, mesh, hw=None) -> dict:
    """``analyze_step`` of one decode step of ``cfg`` at ``spec``'s global
    batch over a cache of capacity ``spec.seq_len``, at ``cur_len =
    seq_len - 1`` (a host int; see the module's docstring), on rank
    ``mesh.rank`` of ``mesh``, every tensor on ``meta``.  Adds
    ``cache_bytes`` (the rank's K/V blocks) and ``state_bytes`` (its
    recurrent states' blocks)."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.model_zoo import abstract_cache
    from repro_torch.train.tree import leaves_with_path
    local, layout, batch, split = _serve_args(cfg, spec, mesh)
    if "cur_len" in batch:
        batch["cur_len"] = spec.seq_len - 1
    cache = abstract_cache(cfg, spec.global_batch, spec.seq_len)
    cspecs = sharding.cache_specs(cfg, cache, mesh)
    cache = sharding.shard_tree(cache, cspecs, mesh)
    step = make_decode_step(cfg, device=torch.device("meta"), mesh=mesh)
    out = analyze_step(step, local, cache, batch, layout, cspecs, split,
                       mesh=mesh, hw=hw)
    kv = state = 0
    for path, t in leaves_with_path(cache):
        n = t.numel() * t.element_size()
        if path[-1] in ("k", "v", "xk", "xv"):
            kv += n
        elif path[-1] in ("h", "conv"):
            state += n
    out["cache_bytes"], out["state_bytes"] = kv, state
    return out


COUNTERS = {"train": count_train_step, "prefill": count_prefill_step,
            "decode": count_decode_step}


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

    mesh = cell_mesh(mesh_kind)
    n_dev = mesh.world
    result["devices"] = n_dev
    result["mesh_shape"] = dict(mesh.shape)
    analysis = COUNTERS[spec.kind](cfg, spec, mesh, hw)

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
    if spec.kind == "decode":
        result["cache_bytes_per_device"] = analysis["cache_bytes"]
        result["state_bytes_per_device"] = analysis["state_bytes"]
    # model flops: 6 N_active D for a training step (forward and backward),
    # 2 N_active D for inference (D one token a row at decode)
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                  else 1)
    model_flops = (6 if spec.kind == "train" else 2) \
        * cfg.active_param_count() * tokens
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
    """(arch, shape, mesh) of every cell: every arch x every shape x
    ``meshes``, as the reference's."""
    from repro_torch.configs.base import SHAPES, list_archs
    for arch in list_archs():
        for shape in SHAPES:
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
