"""Readings that a cell's limits are set from, in one process on the card:
for each seed a run of the cell at its own size and load (set-up, a
window, the sample) and the numbers ``correct`` compares.  A control
seed's run puts the control (the reference in fp8) in the program's place
on the same sample: its checks are the control's, and the program's own
``logit_err_worst`` stands in its ``info``.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 --control-seeds 1,2,3

Prints one JSON line a seed; the benchmark's own runs never run this."""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for seed in seeds:
        t0 = time.monotonic()
        cell = harness.resolve(spec, ROOT, args.workload, seed, args.seconds,
                               False, "cuda", t0, control=seed in controls)
        run = cell.runner.run(cell)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "checks": {k: v for k, (v, _) in run.checks.items()},
            "info": run.info,
            "metrics": {k: v["value"] for k, v in
                        harness.read_metrics(spec, cell, run).items()},
            "run_s": time.monotonic() - t0}), flush=True)
        del run, cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
