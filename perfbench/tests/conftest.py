"""The benchmark's CPU tests: the repository root (for ``perfbench``) and
``src`` (for the port) on the path; one CPU thread a process, so that
several test workers do not starve each other's timed windows; tests that
need a card skip without one."""
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
# inherited by the runs the tests start in subprocesses
os.environ["OMP_NUM_THREADS"] = "1"


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
