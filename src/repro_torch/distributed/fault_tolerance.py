"""Fault tolerance of the training runtime (a copy of
``src/repro/distributed/fault_tolerance.py`` without JAX).

* ``FaultTolerantLoop`` — catches step failures, restores the latest atomic
  checkpoint, and replays from there (checkpoint/restart).
* ``StragglerDetector`` — flags steps slower than ``threshold x`` the
  running median of the last ``window`` steps.

* ``elastic_remesh`` — the smaller training mesh after losing hosts: the
  data axis shrinks and the model axis stays (the weights' tensor-parallel
  shards must survive).  The caller re-spawns that many ranks and restores
  the latest checkpoint (whole leaves, so any mesh restores it): the
  reference's drain-and-resume path.  Batches are keyed by (seed, step), so
  a restored run replays exactly.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class StragglerDetector:
    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []

    def record(self, step: int, duration: float) -> bool:
        self.durations.append(duration)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        if len(self.durations) >= 5:
            med = statistics.median(self.durations)
            if duration > self.threshold * med:
                self.events.append(StragglerEvent(step, duration, med))
                return True
        return False


def elastic_remesh(mesh, lost_hosts: int = 1,
                   available: Optional[int] = None):
    """The largest mesh left after losing ``lost_hosts`` along the data
    axis, as a ``launch.mesh.MeshShape`` (the model axis kept).  As the
    reference goes down one data size at a time while too few devices
    remain, this shrinks the data axis until its device count fits in
    ``available`` (the ranks still alive; by default the old count less
    ``lost_hosts`` data rows), and raises at 0."""
    from repro_torch.launch.mesh import MeshShape
    shape = dict(mesh.shape)
    axes = tuple(shape)
    data_ax = "data" if "data" in shape else axes[0]
    row = 1
    for a in axes:
        if a != data_ax:
            row *= shape[a]
    if available is None:
        available = (shape[data_ax] - lost_hosts) * row
    new_data = shape[data_ax] - lost_hosts
    while new_data > 0:
        if new_data * row <= available:
            return MeshShape({a: new_data if a == data_ax else shape[a]
                              for a in axes})
        new_data -= 1
    raise RuntimeError("no viable mesh after failures")


class FaultTolerantLoop:
    """Wraps (step_fn, save_fn, restore_fn) with retry-from-checkpoint."""

    def __init__(self, step_fn: Callable, save_fn: Callable,
                 restore_fn: Callable, max_retries: int = 3,
                 straggler_threshold: float = 3.0,
                 on_straggler: Optional[Callable] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.max_retries = max_retries
        self.detector = StragglerDetector(straggler_threshold)
        self.on_straggler = on_straggler
        self.failures = 0
        self.restores = 0

    def run(self, state, start_step: int, n_steps: int,
            checkpoint_every: int = 50, batch_fn: Callable = None):
        step = start_step
        retries = 0
        while step < start_step + n_steps:
            batch = batch_fn(step) if batch_fn else None
            t0 = time.monotonic()
            try:
                state = self.step_fn(state, step, batch)
                retries = 0
            except Exception:
                self.failures += 1
                retries += 1
                if retries > self.max_retries:
                    raise
                restored = self.restore_fn(state)
                if restored is not None:
                    state, step = restored
                    self.restores += 1
                continue
            dt = time.monotonic() - t0
            if self.detector.record(step, dt) and self.on_straggler:
                self.on_straggler(step, dt)
            step += 1
            if step % checkpoint_every == 0:
                self.save_fn(state, step)
        return state, step
