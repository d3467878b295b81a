"""Training entry point of the port, on a CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --device cuda --steps 10 --seq-len 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch falcon-mamba-7b --opt-state int8 --steps 5 --seq-len 512 \
        --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --steps 5 --seq-len 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --opt-state int8 --steps 5 --seq-len 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \
        --steps 5 --seq-len 448 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --device cuda --mesh 2x1 --steps 5 --seq-len 512 --batch 8

Same CLI as ``repro.launch.train`` with ``--device`` added (default cuda;
asking for cuda without a card is an error).  ``--mesh DxM`` trains on a
``data x model`` mesh of D*M ranks (``launch.mesh.spawn_ranks``: NCCL,
one rank a card, when that many cards are visible; otherwise gloo on
``cuda:0``, or on the CPU under ``--device cpu``), each rank a ``Trainer``
over its ``TrainMesh`` in the layout REPRO_TRAIN_SHARDING names; ``local``
is 1x1 through the mesh code; ``pod1`` / ``pod2`` need the reference's
256 / 512 devices and raise.  The dense, moe and vlm families train on a
mesh, with f32 moments.  ``--smoke`` swaps in the
reduced same-family config (``--device cpu --smoke`` trains it here in
seconds); without it the arch trains at full width from random weights.
The dense, moe (olmoe-1b-7b: the loss adds 0.01 times the routers'
load-balance loss), ssm (falcon-mamba-7b: K7 forward and backward) and
hybrid (zamba2-2.7b: K3 at head_dim 80) archs train, and so do the
encoder-decoder (whisper-small: K3 causal, bidirectional and across, 36
launches a forward) and the VLM stub frontend (qwen2-vl-72b: M-RoPE;
its 80 layers reckon 872 GB of f32-moment state and are refused, as is
any arch whose state outruns the card).  On a card, a run whose
weights, gradients and AdamW moments alone would not fit in its memory
raises before allocating and names ``--opt-state int8`` (falcon-mamba-7b
with f32 moments needs 87.3 GB of them; olmoe-1b-7b's 83.0 GB pass the
check but leave about 2 GB of an 80 GB card for activations, so train it
with int8 moments, 41.7 GB).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.base import (ModelConfig, get_config, reduced_config,
                                      torch_dtype)
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--opt-state", default="f32", choices=["f32", "int8"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (recovery demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model ranks), local (1x1), pod1, pod2")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    device = resolve_device(args.device)
    if args.mesh is not None:
        return _train_on_mesh(cfg, args, *mesh_shape(args.mesh))
    if device.type == "cuda":
        check_state_fits(cfg, args.opt_state,
                         torch.cuda.get_device_properties(device).total_memory)
    result = _trainer(cfg, args, device).train(fail_at=args.fail_at)
    _report(result)
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device)}"
              " bytes", flush=True)
    return result


def _trainer(cfg, args, device, mesh=None) -> Trainer:
    tcfg = TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                         steps=args.steps, workdir=args.workdir,
                         log_every=args.log_every)
    return Trainer(cfg, tcfg, opt_config(args.lr, args.steps, args.opt_state),
                   mesh=mesh, device=device)


def _report(result) -> None:
    print(f"done at step {result['final_step']}; "
          f"first loss {result['log'][0]['loss']:.4f} -> "
          f"last {result['log'][-1]['loss']:.4f}")


# the reference's production meshes, by the devices they need
POD_DEVICES = {"pod1": 256, "pod2": 512}


def mesh_shape(spec: str):
    """``--mesh``: (data, model) ranks."""
    if spec in POD_DEVICES:
        raise ValueError(f"--mesh {spec} needs {POD_DEVICES[spec]} devices "
                         "(the reference's production mesh); train on DxM "
                         "ranks instead")
    if spec == "local":
        return 1, 1
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r} is not DxM, local, pod1 or "
                         "pod2") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec!r}: axis sizes must be >= 1")
    return data, model


def _train_on_mesh(cfg, args, data: int, model: int):
    """Spawn ``data * model`` ranks, each a ``Trainer`` on its
    ``TrainMesh``; rank 0 prints.  Stops the ranks' fork server before it
    returns."""
    from repro_torch.launch.mesh import (MeshShape, serve_backend,
                                         spawn_ranks, stop_rank_server)
    from repro_torch.train.trainer import check_mesh_trains
    world = data * model
    backend = serve_backend(world, args.device)
    if args.device == "cuda":
        props = torch.cuda.get_device_properties(0)
        on_card = 1 if backend == "nccl" else world
        check_state_fits(cfg, args.opt_state, props.total_memory // on_card,
                         data, model)
    check_mesh_trains(cfg, MeshShape({"data": data, "model": model}),
                      opt_config(args.lr, args.steps, args.opt_state))
    print(f"training {cfg.name} on a {data}x{model} mesh ({backend}, "
          f"{world} rank(s))", flush=True)
    try:
        outs = spawn_ranks(_train_rank, world, backend, args.device,
                           args=(cfg, args, data, model))
    finally:
        stop_rank_server()
    result = outs[0]
    _report(result)
    # each rank's peak memory, step seconds and collectives (calls, bytes
    # sent, host seconds in the calls), one JSON line
    print("ranks " + json.dumps([
        {k: o[k] for k in ("rank", "peak_device_bytes", "issued")}
        | {"step_s": [e["sec"] for e in o["log"]],
           "losses": [e["loss"] for e in o["log"]]} for o in outs]),
        flush=True)
    return result


def _train_rank(serve_mesh, device, cfg, args, data, model):
    """One rank of ``--mesh``: its ``Trainer`` over a ``TrainMesh`` of the
    spawned group.  Returns the log, the final step, the peak device bytes
    and the collectives entered (no weights)."""
    from repro_torch.launch.mesh import make_train_mesh
    mesh = make_train_mesh(data, model)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = _trainer(cfg, args, device, mesh).train(fail_at=args.fail_at)
    return {"final_step": result["final_step"], "log": result["log"],
            "rank": mesh.rank, "issued": mesh.issued,
            "peak_device_bytes": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None}


def state_bytes(cfg: ModelConfig, opt_state: str, data: int = 1,
                model: int = 1) -> int:
    """Bytes of the weights, their gradients (both in the config's dtype)
    and AdamW's two moments (f32: 4 B a value; int8: 1 B and a 4 B scale
    per block of 256), from the config's parameter count; on a ``data x
    model`` mesh a rank's share: all of it split over the ranks under
    fsdp_tp (the few leaves that do not divide aside), the moments alone
    under dp (ZeRO-1)."""
    from repro_torch.perf import perf
    n = cfg.param_count()
    esize = torch.finfo(torch_dtype(cfg)).bits // 8
    moment = 4 if opt_state == "f32" else 1 + 4 / 256
    world = data * model
    if perf().train_sharding == "dp":
        return int(n * 2 * esize + n * 2 * moment / world)
    return int(n * (2 * esize + 2 * moment) / world)


def check_state_fits(cfg: ModelConfig, opt_state: str, capacity: int,
                     data: int = 1, model: int = 1) -> None:
    """Raise before anything is allocated when the train state alone
    (a rank's share on a ``data x model`` mesh) exceeds ``capacity``
    bytes (activations come on top)."""
    need = state_bytes(cfg, opt_state, data, model)
    if need > capacity:
        hint = (" Train with --opt-state int8 (block-quantized moments, "
                f"{state_bytes(cfg, 'int8') / 1e9:.1f} GB)."
                if opt_state == "f32" else "")
        raise ValueError(
            f"{cfg.name}: weights, gradients and {opt_state} AdamW moments "
            f"need {need / 1e9:.1f} GB ({cfg.param_count():,} parameters), "
            f"more than the device's {capacity / 1e9:.1f} GB.{hint}")


def opt_config(lr: float, steps: int, opt_state: str = "f32") -> AdamWConfig:
    """The optimizer config the CLI builds: a 5% warm-up into a cosine over
    the run's steps."""
    return AdamWConfig(lr=lr, total_steps=steps,
                       warmup_steps=max(1, steps // 20),
                       state_dtype=opt_state)


if __name__ == "__main__":
    main()
