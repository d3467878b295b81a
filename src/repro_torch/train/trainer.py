"""Training loop: steps, checkpoint/restart, straggler detection (mirrors
``src/repro/train/trainer.py``).

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
deterministic, so the replay reproduces the clean run's losses.

On a mesh (``mesh=``, this rank's ``launch.mesh.TrainMesh``; every rank
builds its own ``Trainer`` and runs the same loop) the rank keeps only its
shards of the weights and moments after ``init`` (``sharding.train_layout``
under REPRO_TRAIN_SHARDING) and takes its slice of each
``pipeline.batch_at(step)`` (``batch_specs``).  Rank 0 logs and saves; a
checkpoint holds the single device's layout (whole leaves, gathered to
rank 0, the same atomic rename), and on restore each rank reads whole
leaves and keeps its slice, so a checkpoint of any mesh restores on any
other mesh or on one device.  The dense, moe and vlm families train on a
mesh with f32 moments; ssm, hybrid, the encoder-decoder and int8 moments
raise, naming ROADMAP A10d.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
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
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.layout = None          # set by the first init on a mesh
        self.device = resolve_device(device)
        self.fns = build_model(cfg, self.device)
        self._step, self.opt = make_train_step(cfg, opt_cfg, remat=tcfg.remat,
                                               device=self.device, mesh=mesh)
        if mesh is not None:
            check_mesh_trains(cfg, mesh, self.opt.cfg)
        self.pipeline = TokenPipeline(
            cfg.vocab, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed,
            family=cfg.family, d_model=cfg.d_model)
        self.metrics_log = []
        self.detector = StragglerDetector()

    # -- state ---------------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def init_state(self):
        params = self.fns.init(self.tcfg.seed)
        if self.mesh is None:
            return {"params": params, "opt": self.opt.init(params)}
        if self.layout is None:
            self.layout = sharding.train_layout(self.cfg, params, self.mesh)
        local = sharding.shard_tree(params, self.layout.params, self.mesh)
        del params
        return {"params": local, "opt": self.opt.init(local, self.layout)}

    def try_restore(self, state):
        if not self.tcfg.workdir:
            return state, 0
        like = state if self.mesh is None else self._whole_like(state)
        r = restore_latest(self.tcfg.workdir, like)
        if r is None:
            return state, 0
        tree, manifest = r
        if self.mesh is not None:
            tree = self._shard_state(tree)
        return tree, manifest["step"]

    def save(self, state, step):
        if not self.tcfg.workdir:
            return
        if self.mesh is None:
            save_checkpoint(self.tcfg.workdir, step, state)
            return
        whole = self._whole_state(state)
        if self.is_leader:
            save_checkpoint(self.tcfg.workdir, step, whole)
        # no rank reads the directory before rank 0 has renamed it
        self.mesh.barrier()

    # -- a mesh's shards -----------------------------------------------------
    def _moment_specs(self):
        return {"step": (), "m": self.layout.moments,
                "v": self.layout.moments}

    def _whole_state(self, state):
        """Whole leaves on the host, on every rank (gathered leaf by
        leaf)."""
        mesh = self.mesh
        return {"params": sharding.unshard_tree(
                    state["params"], self.layout.params, mesh, to_host=True),
                "opt": sharding.unshard_tree(
                    state["opt"], self._moment_specs(), mesh, to_host=True)}

    def _whole_like(self, state):
        """Host stand-ins of the whole leaves (shape, dtype, device) for
        ``restore_checkpoint``."""
        mesh = self.mesh

        def like(spec, x):
            return _Like(tuple(sharding.full_shape(x.shape, spec, mesh)),
                         x.dtype, torch.device("cpu"))
        return {"params": sharding._tree_map2(like, self.layout.params,
                                              state["params"]),
                "opt": sharding._tree_map2(like, self._moment_specs(),
                                           state["opt"])}

    def _shard_state(self, tree):
        mesh, dev = self.mesh, self.device
        return {"params": sharding.shard_tree(tree["params"],
                                              self.layout.params, mesh, dev),
                "opt": sharding.shard_tree(tree["opt"], self._moment_specs(),
                                           mesh, dev)}

    def batch_at(self, step):
        """(this rank's slice of ``pipeline.batch_at(step)`` on the device,
        whether the ranks' slices differ: a global batch that does not
        divide over the batch axes is replicated)."""
        batch = self.pipeline.batch_at(step)
        if self.mesh is None:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}, True
        specs = sharding.batch_specs(self.cfg, batch, self.mesh)
        local = sharding.shard_tree({k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                                    specs, self.mesh, self.device)
        return local, any(e is not None for e in specs["labels"])

    # -- loop ----------------------------------------------------------------
    def train(self, fail_at: Optional[int] = None) -> Dict:
        """Runs the loop; ``fail_at`` injects one failure (tests, callers)."""
        state = self.init_state()
        state, step = self.try_restore(state)
        failed = False
        while step < self.tcfg.steps:
            batch, split = self.batch_at(step)
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
            if self.mesh is None:
                params, opt, metrics = self._step(state["params"],
                                                  state["opt"], batch)
            else:
                params, opt, metrics = self._step(
                    state["params"], state["opt"], batch, self.layout, split)
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
                if self.is_leader:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"({toks / max(dt, 1e-9):,.0f} tok/s)", flush=True)
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self.save(state, step)
        self.save(state, step)
        return {"state": state, "final_step": step, "log": self.metrics_log,
                "stragglers": len(self.detector.events)}


@dataclasses.dataclass(frozen=True)
class _Like:
    """What ``restore_checkpoint`` reads of a leaf it restores into."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


# the families whose training on a mesh waits for ROADMAP A10d
MESH_PENDING_FAMILIES = ("ssm", "hybrid", "audio")


def check_mesh_trains(cfg: ModelConfig, mesh, opt_cfg=None) -> None:
    """Raise before anything is allocated when ``cfg`` cannot train on
    ``mesh``: the stateful and encoder-decoder families and int8 moments
    wait for ROADMAP A10d; under fsdp_tp the query and kv heads must divide
    over "model" (a rank's heads and their kv groups)."""
    if cfg.family in MESH_PENDING_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family does not train on a mesh "
            "yet (ROADMAP A10d: its d_inner / SSD sharding rules and "
            "constraints are not ported)")
    if opt_cfg is not None and opt_cfg.state_dtype == "int8":
        raise NotImplementedError(
            "int8 AdamW moments on a training mesh are not ported yet "
            "(ROADMAP A10d): the reference splits a leaf's quantization "
            "blocks over every axis, which does not line up with the "
            "weight's shards; train with f32 moments")
    from repro_torch.perf import perf
    n = mesh.shape["model"]
    if perf().train_sharding == "fsdp_tp" and n > 1 and (
            cfg.n_heads % n or cfg.n_kv_heads % n):
        raise ValueError(
            f"{cfg.name}: {cfg.n_heads} query / {cfg.n_kv_heads} kv heads "
            f"do not split over a model axis of {n}")
