"""Checkpointing: atomic, numpy-backed, resumable (mirrors
``src/repro/train/checkpoint.py``, same on-disk layout).

Layout:  <dir>/step_<N>/
            manifest.json       {step, n_leaves, treedef, extra, complete}
            arrays.npz          flattened leaves (keyed a0, a1, ...)

Trees are nested dicts, lists and tuples of tensors (``train.tree``; an int8
moment is two leaves, payload and scales).  Writes go to a temp dir and an
atomic rename, so a failure mid-save never corrupts the latest checkpoint.
numpy has no bfloat16, so bf16 leaves are widened to f32 on save and cast
back to the target leaf's dtype on restore (exact both ways).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import flatten, unflatten_like


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(t)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    leaves, treedef = flatten(tree)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        arrays = {f"a{i}": _to_numpy(x) for i, x in enumerate(leaves)}
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": int(step),
            "n_leaves": len(leaves),
            "treedef": treedef,
            "extra": extra or {},
            "complete": True,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return str(final)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(ckpt_dir.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def list_checkpoints(ckpt_dir: str):
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    out = []
    for p in sorted(d.glob("step_*")):
        m = p / "manifest.json"
        if m.exists():
            try:
                mf = json.loads(m.read_text())
                if mf.get("complete"):
                    out.append((mf["step"], str(p)))
            except json.JSONDecodeError:
                continue
    return out


def restore_checkpoint(path: str, tree_like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (shape validated), each
    leaf on the device and in the dtype of ``tree_like``'s leaf."""
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    leaves, _ = flatten(tree_like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(leaves)}")
    new_leaves = []
    with np.load(p / "arrays.npz") as data:
        for i, ref in enumerate(leaves):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            new_leaves.append(torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype))
    return unflatten_like(tree_like, new_leaves), manifest


def restore_latest(ckpt_dir: str, tree_like: Any
                   ) -> Optional[Tuple[Any, Dict]]:
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        return None
    return restore_checkpoint(ckpts[-1][1], tree_like)
