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

``RMSNormFn`` makes the kernel differentiable: its forward is the kernel,
its backward the analytic gradient in torch ops (``rmsnorm_bwd``).  That
backward is not a kernel: the TPU package has none either (its norm
gradient is XLA's autodiff of the jnp norm).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, refuse_grad

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
    refuse_grad("rmsnorm", x, w)
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


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5):
    """Gradients of ``rmsnorm_kernel(x, w, eps)`` for the output gradient g
    (R, D), in f32 and cast: ``dx = rstd (g w - x_hat mean(g w x_hat))`` and
    ``dw = sum_rows g x_hat``, with ``x_hat = x rstd``."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gw = g.float() * w.float()
    dx = rstd * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (g.float() * xhat).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


class RMSNormFn(torch.autograd.Function):
    """rmsnorm on (R, D) rows: the kernel forward (K2), the analytic
    backward in torch ops with rstd recomputed from the saved x."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        out = rmsnorm_kernel(x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)
