"""Training entry point of the port, on a CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --device cuda --steps 10 --seq-len 512 --batch 8

Same CLI as ``repro.launch.train`` with ``--device`` added (default cuda;
asking for cuda without a card is an error) and no ``--mesh`` (training on
several devices is a later slice, ROADMAP A10).  ``--smoke`` swaps in the
reduced same-family config; without it the arch trains at full width from
random weights.  The dense archs train; ssm and hybrid raise (their loss
needs a selective-scan backward).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config, reduced_config
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
    tcfg = TrainerConfig(seq_len=args.seq_len, global_batch=args.batch,
                         steps=args.steps, workdir=args.workdir)
    trainer = Trainer(cfg, tcfg, opt_config(args.lr, args.steps, args.opt_state),
                      device=args.device)
    result = trainer.train(fail_at=args.fail_at)
    print(f"done at step {result['final_step']}; "
          f"first loss {result['log'][0]['loss']:.4f} -> "
          f"last {result['log'][-1]['loss']:.4f}")
    return result


def opt_config(lr: float, steps: int, opt_state: str = "f32") -> AdamWConfig:
    """The optimizer config the CLI builds: a 5% warm-up into a cosine over
    the run's steps."""
    return AdamWConfig(lr=lr, total_steps=steps,
                       warmup_steps=max(1, steps // 20),
                       state_dtype=opt_state)


if __name__ == "__main__":
    main()
