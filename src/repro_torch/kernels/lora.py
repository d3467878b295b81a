"""Wrappers of the CUDA C++ segmented LoRA kernels (``csrc/lora.cu``).

Replace the Pallas TPU kernels ``lora_shrink_kernel`` (K5) and
``lora_expand_kernel`` (K6) of ``src/repro/kernels/lora.py``; the source
file's header says how the kernels are laid out and what bounds them.
Every row of a batch applies its own adapter, selected from a slab of
per-tenant factors by a per-row slot index; rows with index -1 (base rows)
come out as exact zeros.  Ragged ranks share one slab: an adapter of lower
rank is zero-padded to the slab's rank, and its padding contributes exactly
zero.

Each wrapper checks what it is given and raises on anything its kernel does
not take, allocates the output with ``torch.empty`` and launches on the
current CUDA stream.  Tensors that lie on the CPU take the plain versions
(``ref.lora_shrink_ref`` / ``ref.lora_expand_ref``); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (chip_smoke.py reads and zeroes them)
shrink_launches = 0
expand_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# repro_lora_shrink(x, a, idx, h, T, d, R, S, dtype, stream)
_SHRINK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
# repro_lora_expand(h, b, idx, y, T, R, O, block_out, S, dtype, stream)
_EXPAND_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
MAX_RANK = 64         # csrc/lora.cu's MAX_RANK
_MAX_TILES = 65535    # the expand grid's y axis
_INT_MAX = 2**31 - 1


def load_kernels():
    """The two C entry points (shrink, expand), built from ``csrc/lora.cu``
    at the first call."""
    return (build.load("lora", "repro_lora_shrink", _SHRINK_ARGTYPES),
            build.load("lora", "repro_lora_expand", _EXPAND_ARGTYPES))


def _check_common(what, act, slab, idx, rank_axis):
    if act.device != slab.device or idx.device != slab.device:
        raise ValueError(f"{what}: all inputs must share one device")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: idx must be int32, got {idx.dtype}")
    if slab.dtype not in _DTYPES:
        raise TypeError(f"{what}: slab must be float32 or bfloat16, got "
                        f"{slab.dtype}")
    if act.dim() != 2 or slab.dim() != 3 or idx.shape != (act.shape[0],):
        raise ValueError(f"{what}: want rows (T,·), slab (S,·,·) and idx "
                         f"(T,), got {tuple(act.shape)}, {tuple(slab.shape)}"
                         f" and {tuple(idx.shape)}")
    r = slab.shape[rank_axis]
    if r % 8 or not 8 <= r <= MAX_RANK:
        raise ValueError(f"{what}: rank {r} must be a multiple of 8 in "
                         f"[8, {MAX_RANK}]")
    if slab.shape[0] < 1 or max(act.numel(), slab.numel()) > _INT_MAX:
        raise ValueError(f"{what}: slab {tuple(slab.shape)} or rows "
                         f"{tuple(act.shape)} out of the kernel's range")
    if not (act.is_contiguous() and slab.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")


def lora_shrink_kernel(x: torch.Tensor, a_slab: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """x (T, d); a_slab (S, d, R); idx (T,) int32 slot per row, -1 = no
    adapter -> (T, R) float32.  x and the slab share a dtype."""
    global shrink_launches
    _check_common("lora_shrink", x, a_slab, idx, 2)
    if x.dtype != a_slab.dtype:
        raise TypeError(f"lora_shrink: x and a_slab must share a dtype, got "
                        f"{x.dtype} and {a_slab.dtype}")
    t, d = x.shape
    s, d2, r = a_slab.shape
    if d != d2:
        raise ValueError(f"lora_shrink: x feature dim {d} != slab {d2}")
    if x.device.type == "cpu":
        return ref.lora_shrink_ref(x, a_slab, idx)
    if x.device.type != "cuda":
        raise ValueError(f"lora_shrink: unsupported device {x.device}")
    if a_slab.data_ptr() % 16:
        raise ValueError("lora_shrink: a_slab must be 16-byte aligned")
    out = torch.empty((t, r), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    fn, _ = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a_slab.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), t, d, r, s, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lora_shrink kernel launch failed: cudaError "
                           f"{err}")
    shrink_launches += 1
    return out


def lora_expand_kernel(h: torch.Tensor, b_slab: torch.Tensor,
                       idx: torch.Tensor, block_out: int = 256
                       ) -> torch.Tensor:
    """h (T, R) float32; b_slab (S, R, O); idx (T,) int32 -> (T, O) in the
    slab's dtype.  ``block_out`` is the output-feature tile one block
    covers; the result is bitwise the same for every value."""
    global expand_launches
    _check_common("lora_expand", h, b_slab, idx, 1)
    if h.dtype != torch.float32:
        raise TypeError(f"lora_expand: h must be float32, got {h.dtype}")
    t, r = h.shape
    s, r2, o = b_slab.shape
    if r != r2:
        raise ValueError(f"lora_expand: h rank {r} != slab {r2}")
    block_out = int(block_out)
    if block_out < 1 or -(-o // block_out) > _MAX_TILES:
        raise ValueError(f"lora_expand: block_out {block_out} gives more "
                         f"than {_MAX_TILES} tiles of {o} outputs, or is < 1")
    if h.device.type == "cpu":
        return ref.lora_expand_ref(h, b_slab, idx, b_slab.dtype)
    if h.device.type != "cuda":
        raise ValueError(f"lora_expand: unsupported device {h.device}")
    out = torch.empty((t, o), dtype=b_slab.dtype, device=h.device)
    if t == 0 or o == 0:
        return out
    _, fn = load_kernels()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), b_slab.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), t, r, o, block_out, s, _DTYPES[b_slab.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"lora_expand kernel launch failed: cudaError "
                           f"{err}")
    expand_launches += 1
    return out
