"""End-to-end training with checkpoint/restart on the PyTorch port: trains
an LM on the synthetic corpus, injects a failure mid-run and recovers from
the latest checkpoint, on a CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py --layers 2       # card, full width
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --smoke [--steps 120]

The port of ``examples/train_lm.py``: ``repro_torch.train.trainer.Trainer``
at seq 128, batch 4, a checkpoint every 20 steps, one failure at 2/3 of
the run.  ``--smoke`` trains the reduced config (the reference example's
size); without it the arch at full width in its own dtype, ``--layers N``
cutting it to its first N layers (widths kept).  ``train`` returns the
losses, the step the failure struck and the step the run restored.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.launch.train import at_depth  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def train(cfg, steps: int, device, workdir: str, fail: bool = True,
          checkpoint_every: int = 20) -> dict:
    """``steps`` steps of ``cfg`` on ``device``, checkpointed into
    ``workdir`` every ``checkpoint_every``; with ``fail`` one failure
    injected at 2/3 of the run, after which the loop restores the latest
    checkpoint and replays."""
    tcfg = TrainerConfig(seq_len=128, global_batch=4, steps=steps,
                         checkpoint_every=checkpoint_every, log_every=5,
                         workdir=workdir)
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    trainer = Trainer(cfg, tcfg, opt, device=device)
    restored = []
    restore = trainer.try_restore

    def try_restore(state):
        state, step = restore(state)
        restored.append(step)
        return state, step
    trainer.try_restore = try_restore
    # inject one failure at 2/3 of the run: the loop restores from the last
    # checkpoint and replays (batches are (seed, step)-keyed, so training is
    # bit-identical to an uninterrupted run)
    fail_at = int(steps * 2 / 3) if fail else None
    result = trainer.train(fail_at=fail_at)
    first, last = result["log"][0]["loss"], result["log"][-1]["loss"]
    if fail:
        print(f"failure injected at step {fail_at}: restored step "
              f"{restored[-1]} and replayed")
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'no improvement'}); "
          f"checkpoints in {workdir}")
    return {"first": first, "last": last,
            "losses": [e["loss"] for e in result["log"]],
            "fail_at": fail_at,
            "restored_step": restored[-1] if fail else None,
            "final_step": result["final_step"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to its first N layers "
                         "(launch.train's --layers)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.layers is not None:
        cfg = at_depth(cfg, args.layers)
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_train_")
    return train(cfg, args.steps, args.device, workdir)


if __name__ == "__main__":
    main()
