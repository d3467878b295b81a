"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a slice of the window under ``torch.profiler``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers close standard error.  Without as many CUDA
devices as the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.  The
port's kernels build once a checkout, into its ``build/repro_torch/``.
"""
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    spec = harness.load_spec(ROOT)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"knobs: {harness.knobs() or 'none set'}", file=sys.stderr)
    card = harness.power_limit()
    cell = harness.resolve(spec, ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    run = cell.runner.run(cell)
    found = harness.forbidden_modules()
    if found:
        print(f"refused: modules {found} are loaded", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips[args.workload],
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "nvidia_smi": card}
    line = harness.result(spec, cell, run, device)
    print(f"card: {card}", file=sys.stderr)
    print(f"info: {json.dumps(run.info)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
