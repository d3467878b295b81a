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

Same CLI as ``repro.launch.train`` with ``--device`` added (default cuda;
asking for cuda without a card is an error) and no ``--mesh`` (training on
several devices is a later slice, ROADMAP A10b).  ``--smoke`` swaps in the
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        check_state_fits(cfg, args.opt_state,
                         torch.cuda.get_device_properties(device).total_memory)
    tcfg = TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                         steps=args.steps, workdir=args.workdir)
    trainer = Trainer(cfg, tcfg, opt_config(args.lr, args.steps, args.opt_state),
                      device=device)
    result = trainer.train(fail_at=args.fail_at)
    print(f"done at step {result['final_step']}; "
          f"first loss {result['log'][0]['loss']:.4f} -> "
          f"last {result['log'][-1]['loss']:.4f}")
    return result


def state_bytes(cfg: ModelConfig, opt_state: str) -> int:
    """Bytes of the weights, their gradients (both in the config's dtype)
    and AdamW's two moments (f32: 4 B a value; int8: 1 B and a 4 B scale
    per block of 256), from the config's parameter count."""
    n = cfg.param_count()
    esize = torch.finfo(torch_dtype(cfg)).bits // 8
    moment = 4 if opt_state == "f32" else 1 + 4 / 256
    return int(n * (2 * esize + 2 * moment))


def check_state_fits(cfg: ModelConfig, opt_state: str, capacity: int) -> None:
    """Raise before anything is allocated when the train state alone
    exceeds the device's ``capacity`` bytes (activations come on top)."""
    need = state_bytes(cfg, opt_state)
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
