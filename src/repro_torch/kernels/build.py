"""Build and load the port's CUDA C++ kernels.

``csrc/<name>.cu`` exposes a plain C interface; it is compiled with ``nvcc``
for ``sm_90a`` into a shared library under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``) and loaded with ``ctypes``.  The
library's file name carries a hash of its source, the headers it includes
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  Nothing is built at
import time: the first launch builds what it needs, and ``build`` compiles
several sources at once, one ``nvcc`` process each, all started together.

A failed build or load raises; there is no fallback to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (source name, symbol) -> loaded C function: one source may export several
_FNS: Dict[Tuple[str, str], object] = {}
# name -> nvcc's output (ptxas register and spill counts) of this process's
# build; absent when an earlier build was reused
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built from source at first use")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file it includes by a quoted
    ``#include`` (relative to the including file), transitively, in the
    order first reached."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [(path.parent / m.decode()).resolve()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """The library's path, keyed by the bytes of its source, of every
    header the source includes, and of the flags: editing a shared header
    rebuilds every library that includes it."""
    data = b"".join(p.read_bytes() for p in sources(name))
    key = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(*names: str) -> None:
    """Compile the named ``csrc/<name>.cu`` sources that have no library
    yet, one ``nvcc`` process each, all started together; raise if any
    fails.  nvcc's output of each build lands in ``BUILD_LOG``."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {n} (exit "
                              f"{proc.returncode}):\n{log}")
                continue
            os.replace(tmp, library_path(n))
            BUILD_LOG[n] = log
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``, built first if
    needed, returning ``restype`` (``int`` by default).  Pass every pointer
    and the stream as ``c_void_p`` in ``argtypes``, so ctypes never
    truncates an address."""
    fn = _FNS.get((name, symbol))
    if fn is not None:
        return fn
    build(name)
    fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    _FNS[(name, symbol)] = fn
    return fn
