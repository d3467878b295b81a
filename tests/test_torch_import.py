"""The port imports nothing of JAX: importing every ``repro_torch`` module
leaves ``jax``, ``ml_dtypes``, ``triton`` and every ``repro.`` module out of
``sys.modules``, and no port source (nor ``chip_smoke.py``) names them in an
import statement.  The one exception to the import walk is the Triton kernel
body, which imports ``triton`` and is loaded only by its wrapper at the
first launch on a card.  No port source states the reference's TPU
constants or names: the port's device numbers live in
``core/hardware.py`` and describe the H100."""
import ast
import os
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert "repro_torch.kernels._rmsnorm_triton" in names, names
for n in names:
    if n != "repro_torch.kernels._rmsnorm_triton":
        importlib.import_module(n)
assert "repro_torch.launch.serve" in names, names
assert "repro_torch.launch.train" in names, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "triton")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 72
    assert bad == "[]", f"forbidden modules imported: {bad}"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"


# the reference's TPU peak rates, on-chip capacity, chip and unit names
TPU_TOKENS = ("197e12", "819e9", "16 * 2**20", "v5e", "VMEM", "MXU")


def test_no_port_source_states_a_tpu_constant():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) \
        + [ROOT / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        for token in TPU_TOKENS:
            assert token not in text, f"{f.relative_to(ROOT)} states {token!r}"
