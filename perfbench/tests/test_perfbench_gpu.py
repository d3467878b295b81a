"""On the card: each cell of ``BENCHMARK.json`` runs once through the
benchmark's command, briefly, and prints a well-formed, correct
line.  Skipped without a CUDA device."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, cuda):
    # 20 s: requests finish inside the window, so the sample that decides
    # `correct` is not empty
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "20",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
