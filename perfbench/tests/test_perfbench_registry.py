"""A later PR adds a configuration, a traffic mix and a per-layer metric
as new files and entries of ``BENCHMARK.json``; the harness finds and
runs them by name with no existing file edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"

READER = '''"""Requests finished in the window (a new per-layer metric)."""


def read(run):
    return sum(1 for r in run.recs
               if r.status == "length" and run.in_window(r.t_done))
'''

DRIVE = '''
import json, sys, time
from pathlib import Path
from perfbench import harness
root = Path.cwd()
spec = harness.load_spec(root)
cell = harness.resolve(spec, root, "tiny-dense.tiny_chat", 5, 2.0, True,
                       "cpu", time.monotonic())
run = cell.runner.run(cell)
print(json.dumps(harness.result(spec, cell, run, {"platform": "cpu"})))
'''


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = digest(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"
    shutil.copy(DATA / "tiny-dense.json", pb / "configs" / "tiny-dense.json")
    shutil.copy(DATA / "tiny_chat.json", pb / "traffic" / "tiny_chat.json")
    shutil.copy(DATA / "tiny.limits.json",
                pb / "limits" / "tiny-dense.tiny_chat.json")
    (pb / "metrics" / "requests_finished.serve.py").write_text(READER)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dense", "source": "test",
                            "file": "perfbench/configs/tiny-dense.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-dense.tiny_chat",
                              "config": "tiny-dense",
                              "traffic": "tiny_chat", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "requests_finished.serve",
                              "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "Engine",
                              "moves": "decode_tokens_per_s",
                              "workloads": ["tiny-dense.tiny_chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    p = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    # the existing per-layer metrics name their cells; the new one names
    # the new cell
    assert set(line["metrics"]) == {"requests_finished.serve"}
    assert line["metrics"]["requests_finished.serve"]["value"] > 0
    after = digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before
