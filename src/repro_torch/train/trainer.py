"""Training loop: steps, checkpoint/restart, straggler detection (mirrors
``src/repro/train/trainer.py``, single device).

Parameters come from the arch's ``init`` on the trainer's device (cuda
unless ``device="cpu"``), batches from the seeded token pipeline moved
there; the loss is the family's (``lm_loss`` dense and moe, the latter with
its load-balance term, ``ssm_lm_loss`` ssm, ``hybrid_loss`` hybrid), each
on the same ``tokens``/``labels`` batch; the vlm family's ``lm_loss`` takes
the pipeline's stub ``embeds`` and M-RoPE ``positions``, and the audio
family's ``encdec_loss`` its stub ``frames`` beside the tokens (both cast
to the weights' dtype at the model's entry).  A failure injected at
``fail_at`` rebuilds the state, restores the
latest checkpoint and replays from its step; every kernel on the path is
deterministic, so the replay reproduces the clean run's losses.  Training
on a mesh waits for ROADMAP A10b.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.train.checkpoint import restore_latest, save_checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamWConfig


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 512
    global_batch: int = 8
    steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    workdir: Optional[str] = None
    seed: int = 0
    remat: bool = True


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "training on a mesh is not ported to repro_torch yet "
                "(ROADMAP A10b)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.fns = build_model(cfg, self.device)
        self._step, self.opt = make_train_step(cfg, opt_cfg, remat=tcfg.remat,
                                               device=self.device)
        self.pipeline = TokenPipeline(
            cfg.vocab, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed,
            family=cfg.family, d_model=cfg.d_model)
        self.metrics_log = []
        self.detector = StragglerDetector()

    # -- state ---------------------------------------------------------------
    def init_state(self):
        params = self.fns.init(self.tcfg.seed)
        return {"params": params, "opt": self.opt.init(params)}

    def try_restore(self, state):
        if not self.tcfg.workdir:
            return state, 0
        r = restore_latest(self.tcfg.workdir, state)
        if r is None:
            return state, 0
        tree, manifest = r
        return tree, manifest["step"]

    def save(self, state, step):
        if self.tcfg.workdir:
            save_checkpoint(self.tcfg.workdir, step, state)

    # -- loop ----------------------------------------------------------------
    def train(self, fail_at: Optional[int] = None) -> Dict:
        """Runs the loop; ``fail_at`` injects one failure (tests, callers)."""
        state = self.init_state()
        state, step = self.try_restore(state)
        failed = False
        while step < self.tcfg.steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            if fail_at is not None and step == fail_at and not failed:
                failed = True
                # simulated node failure -> restore path; the lost state is
                # dropped before a fresh one is built
                state = None
                state, step = self.try_restore(self.init_state())
                continue
            t0 = time.monotonic()
            # the step updates the weights and moments in place
            # (AdamW.update) and returns the same tensors: one state is alive
            params, opt, metrics = self._step(state["params"], state["opt"],
                                              batch)
            state = {"params": params, "opt": opt}
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            self.detector.record(step, dt)
            if step % self.tcfg.log_every == 0 \
                    or step == self.tcfg.steps - 1:
                toks = self.tcfg.global_batch * self.tcfg.seq_len
                self.metrics_log.append(
                    {"step": step, "loss": loss, "sec": dt,
                     "tokens_per_s": toks / max(dt, 1e-9),
                     "grad_norm": float(metrics["grad_norm"])})
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({toks / max(dt, 1e-9):,.0f} tok/s)", flush=True)
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self.save(state, step)
        self.save(state, step)
        return {"state": state, "final_step": step, "log": self.metrics_log,
                "stragglers": len(self.detector.events)}
