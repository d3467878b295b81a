"""Wrapper of the CUDA C++ rmsnorm kernels (``csrc/rmsnorm.cu``), K2.

Replaces the Pallas TPU kernel ``rmsnorm_kernel`` of
``src/repro/kernels/rmsnorm.py``: ``x * rsqrt(mean(x^2) + eps) * w``,
written in x's dtype, with the reduction and scale in f32 or (``f32=False``,
REPRO_NORM_F32=0) in x's dtype as the reference's ``rms_norm`` then
computes them.  The source file's
header says how the kernels are laid out and what bounds them.  Entry
points:

- ``rmsnorm_kernel``: one (R, D) tensor;
- ``rmsnorm_pair_kernel``: two tensors of one width, each with its own
  weight, in one launch (a layer's q and k norms); each output is bitwise
  its single launch;
- ``rmsnorm_bwd_kernel`` / ``rmsnorm_pair_bwd_kernel``: dx and dw, a row
  pass and a column pass with no atomics (the gradient of the reference's
  ``rms_norm`` under XLA's autodiff; the TPU package has no backward
  kernel).

``RMSNormFn`` and ``RMSNormPairFn`` make them differentiable.  Each wrapper
checks what it is given and raises on anything the kernels do not take,
allocates outputs with ``torch.empty`` and launches on the current CUDA
stream.  Tensors that lie on the CPU take the plain versions
(``ref.rmsnorm_ref``, ``ref.rmsnorm_bwd_ref``; a pair is two calls); CUDA
tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count, launch, ref, refuse_grad

# forward launches (single and pair) and backward calls (each launches the
# row pass and the column pass) since the last reset (chip_smoke.py reads
# and zeroes them)
launches = 0
bwd_launches = 0

_P = ctypes.c_void_p
# repro_rmsnorm_fwd(x0, w0, y0, r0, x1, w1, y1, r1, D, x_bf16, w_bf16,
#                   f32acc, eps, stream)
_FWD_ARGS = [_P] * 3 + [ctypes.c_longlong] + [_P] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_float, _P]
# repro_rmsnorm_bwd(x0, w0, g0, dx0, dw0, r0, x1, w1, g1, dx1, dw1, r1, D,
#                   x_bf16, w_bf16, f32acc, eps, part, parts, stream)
_BWD_ARGS = [_P] * 5 + [ctypes.c_longlong] + [_P] * 5 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_float, _P, ctypes.c_longlong, _P]
_DTYPES = (torch.float32, torch.bfloat16)
# (D, x is bf16) -> rows of one row block of the backward (one scratch row)
_BLOCK_ROWS: dict = {}


def load_kernels():
    """The C entry points (forward, backward, the backward's rows a block),
    built from ``csrc/rmsnorm.cu`` at the first call."""
    return (build.load("rmsnorm", "repro_rmsnorm_fwd", _FWD_ARGS),
            build.load("rmsnorm", "repro_rmsnorm_bwd", _BWD_ARGS),
            build.load("rmsnorm", "repro_rmsnorm_bwd_block_rows",
                       [ctypes.c_int, ctypes.c_int], ctypes.c_longlong))


def block_rows(d: int, dtype: torch.dtype) -> int:
    """Rows whose column sums the backward's row pass adds into one row of
    its scratch: a function of D and x's dtype alone (so dw's summation
    order is too).  Built and asked on the first call."""
    key = (d, dtype == torch.bfloat16)
    if key not in _BLOCK_ROWS:
        _BLOCK_ROWS[key] = int(load_kernels()[2](d, int(key[1])))
    return _BLOCK_ROWS[key]


def _check(name, x, w, g=None) -> None:
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"{name}: x (R,D) and w (D,), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if w.device != x.device or (g is not None and g.device != x.device):
        raise ValueError(f"{name}: all inputs must share one device")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 only, got {x.dtype} "
                        f"and {w.dtype}")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype):
        raise ValueError(f"{name}: g must have x's shape and dtype, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (g is None or g.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_pair(name, x1, w1, x2, w2, g1=None, g2=None) -> None:
    _check(name, x1, w1, g1)
    _check(name, x2, w2, g2)
    if x2.device != x1.device:
        raise ValueError(f"{name}: all inputs must share one device")
    if x2.shape[1] != x1.shape[1] or x2.dtype != x1.dtype \
            or w2.dtype != w1.dtype:
        raise ValueError(f"{name}: the two tensors must share D and dtypes, "
                         f"got {tuple(x1.shape)} {x1.dtype}/{w1.dtype} and "
                         f"{tuple(x2.shape)} {x2.dtype}/{w2.dtype}")


def _cuda(name, x) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(x1, w1, x2, w2, eps, f32):
    """Launch the forward over x1 (and x2, when given)."""
    y1 = torch.empty_like(x1)
    y2 = None if x2 is None else torch.empty_like(x2)
    r2 = 0 if x2 is None else x2.shape[0]
    if x1.shape[1] == 0 or x1.shape[0] + r2 == 0:
        return y1, y2
    launch("rmsnorm", x1.device, load_kernels()[0], x1.data_ptr(),
           w1.data_ptr(), y1.data_ptr(), x1.shape[0], _ptr(x2), _ptr(w2),
           _ptr(y2), r2, x1.shape[1], x1.dtype == torch.bfloat16,
           w1.dtype == torch.bfloat16, bool(f32), eps)
    count(globals(), "launches")
    return y1, y2


def rmsnorm_kernel(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                   f32: bool = True) -> torch.Tensor:
    """x (R, D), w (D,) -> (R, D) in x's dtype; ``f32``: reduce and scale
    in f32, else in x's dtype."""
    refuse_grad("rmsnorm", x, w)
    _check("rmsnorm", x, w)
    if not _cuda("rmsnorm", x):
        return ref.rmsnorm_ref(x, w, eps, f32)
    return _fwd(x, w, None, None, eps, f32)[0]


def rmsnorm_pair_kernel(x1: torch.Tensor, w1: torch.Tensor,
                        x2: torch.Tensor, w2: torch.Tensor,
                        eps: float = 1e-5, f32: bool = True):
    """x1 (R1, D) by w1 (D,) and x2 (R2, D) by w2 (D,) in one launch ->
    (y1, y2), each bitwise ``rmsnorm_kernel`` of its own pair."""
    refuse_grad("rmsnorm_pair", x1, w1, x2, w2)
    _check_pair("rmsnorm_pair", x1, w1, x2, w2)
    if not _cuda("rmsnorm_pair", x1):
        return ref.rmsnorm_ref(x1, w1, eps, f32), \
            ref.rmsnorm_ref(x2, w2, eps, f32)
    return _fwd(x1, w1, x2, w2, eps, f32)


def _bwd(x1, w1, g1, x2, w2, g2, eps, f32):
    """Launch the backward's two passes over x1 (and x2, when given)."""
    d = x1.shape[1]
    dx1, dw1 = torch.empty_like(x1), torch.empty_like(w1)
    dx2 = dw2 = None
    r2 = 0
    if x2 is not None:
        dx2, dw2, r2 = torch.empty_like(x2), torch.empty_like(w2), x2.shape[0]
    if d == 0:
        return dx1, dw1, dx2, dw2
    rb = block_rows(d, x1.dtype)
    parts = -(-x1.shape[0] // rb) + -(-r2 // rb)
    part = torch.empty((parts, d), dtype=torch.float32, device=x1.device)
    launch("rmsnorm backward", x1.device, load_kernels()[1], x1.data_ptr(),
           w1.data_ptr(), g1.data_ptr(), dx1.data_ptr(), dw1.data_ptr(),
           x1.shape[0], _ptr(x2), _ptr(w2), _ptr(g2), _ptr(dx2), _ptr(dw2),
           r2, d, x1.dtype == torch.bfloat16, w1.dtype == torch.bfloat16,
           bool(f32), eps, part.data_ptr(), parts)
    count(globals(), "bwd_launches")
    return dx1, dw1, dx2, dw2


def rmsnorm_bwd_kernel(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-5, f32: bool = True):
    """Gradients of ``rmsnorm_kernel(x, w, eps, f32)`` for the output
    gradient g (R, D) in x's dtype -> (dx in x's dtype, dw in w's)."""
    refuse_grad("rmsnorm_bwd", x, w, g)
    _check("rmsnorm_bwd", x, w, g)
    if not _cuda("rmsnorm_bwd", x):
        return ref.rmsnorm_bwd_ref(x, w, g, eps, f32=f32)
    return _bwd(x, w, g, None, None, None, eps, f32)[:2]


def rmsnorm_pair_bwd_kernel(x1, w1, g1, x2, w2, g2, eps: float = 1e-5,
                            f32: bool = True):
    """Gradients of ``rmsnorm_pair_kernel`` -> (dx1, dw1, dx2, dw2), in the
    same two launches as one tensor's; each bitwise its single call's."""
    refuse_grad("rmsnorm_pair_bwd", x1, w1, g1, x2, w2, g2)
    _check_pair("rmsnorm_pair_bwd", x1, w1, x2, w2, g1, g2)
    if not _cuda("rmsnorm_pair_bwd", x1):
        return ref.rmsnorm_bwd_ref(x1, w1, g1, eps, f32=f32) \
            + ref.rmsnorm_bwd_ref(x2, w2, g2, eps, f32=f32)
    return _bwd(x1, w1, g1, x2, w2, g2, eps, f32)


class RMSNormFn(torch.autograd.Function):
    """rmsnorm on (R, D) rows: the forward kernel, and the backward kernel
    with rstd recomputed from the saved x."""

    @staticmethod
    def forward(ctx, x, w, eps: float, f32: bool = True):
        out = rmsnorm_kernel(x, w, eps, f32)
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.f32 = eps, f32
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_kernel(x, w, g.contiguous(), ctx.eps, ctx.f32)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None, None)


class RMSNormPairFn(torch.autograd.Function):
    """Two rmsnorms of one width, each with its own weight, in one launch a
    direction (a layer's q and k norms)."""

    @staticmethod
    def forward(ctx, x1, w1, x2, w2, eps: float, f32: bool = True):
        y1, y2 = rmsnorm_pair_kernel(x1, w1, x2, w2, eps, f32)
        ctx.save_for_backward(x1, w1, x2, w2)
        ctx.eps, ctx.f32 = eps, f32
        return y1, y2

    @staticmethod
    def backward(ctx, g1, g2):
        x1, w1, x2, w2 = ctx.saved_tensors
        grads = rmsnorm_pair_bwd_kernel(x1, w1, g1.contiguous(), x2, w2,
                                         g2.contiguous(), ctx.eps, ctx.f32)
        return tuple(d if need else None for d, need in
                     zip(grads, ctx.needs_input_grad)) + (None, None)
