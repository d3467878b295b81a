"""RMSNorm as a Triton kernel.

Replaces the Pallas TPU kernel ``rmsnorm_kernel`` of
``src/repro/kernels/rmsnorm.py``: ``x * rsqrt(mean(x^2) + eps) * w`` with
the reduction and scale in f32, written in x's dtype.  One program
normalises ROWS rows of BLOCK_D columns (the next power of two >= D, tail
masked), so a row is read once and written once.

Bound on the H100: bytes.  About four flops per element against two to
four bytes moved, two orders of magnitude under the card's flops/byte
balance point; the design therefore only keeps each row in registers
between its read and its write.  Small row counts (a decode step's few
tokens) launch few programs and are launch-latency bound.

The kernel body lives in ``_rmsnorm_triton.py``, which imports ``triton``;
this wrapper imports it inside the launching function, so this module
imports on machines without Triton.  CPU tensors take the plain version
(``ref.rmsnorm_ref``), CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

# kernel launches since the last reset (chip_smoke.py reads and zeroes it)
launches = 0


def _block_shape(d: int):
    block_d = 1 << max(d - 1, 0).bit_length()
    rows = max(1, min(16, 8192 // block_d))
    return block_d, rows


def rmsnorm_kernel(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                   ) -> torch.Tensor:
    """x (R, D), w (D,) -> (R, D) in x's dtype."""
    global launches
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x (R,D) and w (D,), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("rmsnorm: x and w must share one device")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: float32 or bfloat16 only, got {x.dtype} "
                        f"and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: inputs must be contiguous")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    from repro_torch.kernels._rmsnorm_triton import rmsnorm_rows as kernel
    n, d = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    block_d, rows = _block_shape(d)
    grid = (-(-n // rows),)
    with torch.cuda.device(x.device):
        kernel[grid](x, w, out, n, d, float(eps),
                     BLOCK_D=block_d, ROWS=rows, num_warps=4)
    launches += 1
    return out
