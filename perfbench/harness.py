"""The benchmark's data-driven core: a cell of ``BENCHMARK.json`` names a
configuration and a traffic mix, and everything else is found by name.

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the sizes
  as run; its ``program`` and ``reference`` keys name
  ``programs/<program>.py`` (the system under test) and
  ``reference/<reference>.py`` (the plain reference).
- ``traffic/<traffic>.json``: the mix; its ``runner`` key names
  ``runners/<runner>.py``, which sets up, measures the window and checks
  the outputs.
- ``limits/<cell>.json``: the limit of each number ``correct`` compares.
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning the
  value or None where it finds nothing to read.

A later configuration, mix or metric is new files and entries; no file
here changes."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent
# modules that must not be loaded in the process that prints a result:
# JAX, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a share of a peak or a roofline above this is a fault of the count
MAX_SHARE_PCT = 105.0


@dataclasses.dataclass
class Cell:
    name: str
    conf: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    program: Any
    reference: Any
    runner: Any
    control: bool = False


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(kind: str, name: str):
    """``perfbench.<kind>.<name>`` (a file ``<kind>/<name>.py``)."""
    return importlib.import_module(f"perfbench.{kind}.{name}")


def _reader(name: str):
    """The metric's reader, ``metrics/<name>.py`` (metric names hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(spec: dict, root: Path, workload: str, seed: int,
            seconds: float, trace: bool, device: str, t_start: float,
            control: bool = False) -> Cell:
    """The cell named ``workload``, with its files read and its modules
    found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    confs = {c["name"]: c for c in spec["configs"]}
    conf = json.loads((root / confs[w["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(name=workload, conf=conf, mix=mix, limits=limits,
                seed=seed, seconds=seconds, trace=trace, device=device,
                t_start=t_start,
                program=_module("programs", conf["program"]),
                reference=_module("reference", conf["reference"]),
                runner=_module("runners", mix["runner"]), control=control)


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: end-to-end without trace, per-layer with it;
    an entry with ``workloads`` only in those cells."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(spec: dict, cell: Cell, run) -> Dict[str, dict]:
    """Each metric's reader on the run; a reader that finds nothing leaves
    its metric out, except an end-to-end metric, which every run has."""
    got = {}
    for m in metrics_of(spec, cell.name, cell.trace):
        value = _reader(m["name"])(run)
        if value is None:
            if not cell.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        got[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return got


def share_check(metrics: Dict[str, dict]) -> tuple:
    """(the largest share of a peak or roofline read, its limit)."""
    shares = [m["value"] for n, m in metrics.items()
              if m["unit"] == "%" and ("roofline" in n or "mfu" in n)]
    return (max(shares) if shares else 0.0, MAX_SHARE_PCT)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 \
        and p.stdout.strip() else None


def knobs() -> Dict[str, str]:
    """The program's ``REPRO_*`` settings found in the environment (the
    benchmark sets none)."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("REPRO_")}


def result(spec: dict, cell: Cell, run, device: dict) -> dict:
    """The run's result line (``checks`` last), and whether it is correct."""
    metrics = read_metrics(spec, cell, run)
    checks = dict(run.checks)
    checks["max_share_pct"] = share_check(metrics)
    ok = all(v <= lim for v, lim in checks.values())
    recs = run.submitted_in_window()
    failed = checks["failed_requests"][0]
    line = {"correct": ok, "attempted": len(recs), "failed": failed,
            "metrics": metrics, "device": device}
    if cell.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line
