"""Wrapper of the CUDA C++ selective-scan kernels (``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``ssm_scan_kernel`` (K7) of
``src/repro/kernels/ssm_scan.py``; the source file's header says how the
kernels are laid out and what bounds them.  Entry points:

- ``ssm_scan_kernel``: the scan, (y, h_last) (serving, and every call that
  records no gradient);
- ``ssm_scan_ckpt_kernel``: the same launch also writing the state every
  ``WINDOW`` steps, which the backward rebuilds its windows from;
- ``ssm_scan_bwd_kernel``: the gradient, da, db, dc and dh0 (the TPU
  kernel has none: the JAX package differentiates its jnp scan).

``SSMScanFn`` makes the scan differentiable.  Each wrapper checks what it is
given and raises on anything the kernels do not take, allocates outputs and
scratch with ``torch.empty`` and launches on the current CUDA stream.
Tensors that lie on the CPU take the plain versions (``ref.ssm_scan_ref``,
``ref.ssm_scan_ckpt_ref``, ``ref.ssm_scan_bwd_ref``); CUDA tensors launch
the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, ref, refuse_grad

# forward launches (with or without checkpoints) and backward calls (each
# launches the windowed backward and dc's column sum) since the last reset
# (chip_smoke.py reads and zeroes them)
launches = 0
bwd_launches = 0

_P = ctypes.c_void_p
# repro_ssm_scan(a, b, c, h0, y, h_last, ckpt, window, B, T, D, N,
#                ab_bstride, c_bstride, y_bstride, stream)
_FWD_ARGS = [_P] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [_P]
# repro_ssm_scan_bwd(a, b, c, ckpt, dy, dh_last, da, db, dc, dh0, part,
#                    window, B, T, D, N, ab_bstride, c_bstride, y_bstride,
#                    stream)
_BWD_ARGS = [_P] * 11 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [_P]
MAX_STATE = 32        # one state element a lane, N lanes of one warp per d
_MAX_BATCH = 65535    # the grid's y axis
_THREADS = 256        # a block: 256 / N values of d (dc's partials a block)
WINDOW = 16           # steps between the forward's state checkpoints


def load_kernels():
    """The C entry points (forward, backward), built from
    ``csrc/ssm_scan.cu`` at the first call; the source's checkpoint window
    must be ``WINDOW``."""
    fwd = build.load("ssm_scan", "repro_ssm_scan", _FWD_ARGS)
    bwd = build.load("ssm_scan", "repro_ssm_scan_bwd", _BWD_ARGS)
    window = build.load("ssm_scan", "repro_ssm_scan_window", [])()
    if window != WINDOW:
        raise RuntimeError(f"ssm_scan: csrc/ssm_scan.cu checkpoints every "
                           f"{window} steps, the wrapper expects {WINDOW}")
    return fwd, bwd


def windows(t: int) -> int:
    """Checkpoints a T-step forward writes: one before every WINDOW-th
    step."""
    return -(-t // WINDOW)


def _check(a, b, c, h0=None) -> None:
    ts = (a, b, c) + (() if h0 is None else (h0,))
    if any(t.device != a.device for t in ts):
        raise ValueError("ssm_scan: all inputs must share one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssm_scan: a, b, c and h0 must be float32, got "
                        + "/".join(str(t.dtype) for t in ts))
    h0s = None if h0 is None else tuple(h0.shape)
    if a.dim() != 4 or b.shape != a.shape or c.dim() != 3 \
            or (h0 is not None and h0.dim() != 3):
        raise ValueError(f"ssm_scan: a, b (B,T,D,N), c (B,T,N), h0 (B,D,N); "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {h0s}")
    bsz, t, d, n = a.shape
    if c.shape != (bsz, t, n) or h0s not in (None, (bsz, d, n)):
        raise ValueError(f"ssm_scan: c {tuple(c.shape)} or h0 {h0s} do not "
                         f"match a {tuple(a.shape)}")
    if n < 1 or n > MAX_STATE or n & (n - 1):
        raise ValueError(f"ssm_scan: state size N={n} must be a power of two "
                         f"up to {MAX_STATE}")
    if bsz > _MAX_BATCH:
        raise ValueError(f"ssm_scan: batch {bsz} exceeds {_MAX_BATCH}")
    # each batch row of a/b is one (T, D, N) block and of c one (T, N)
    # block (views of a slice of a longer sequence qualify)
    inner = lambda x, want: all(  # noqa: E731
        x.stride(i) == s for i, s in enumerate(want, start=1) if x.shape[i] > 1)
    if a.stride() != b.stride() or not inner(a, (d * n, n, 1)) \
            or not inner(c, (n, 1)) \
            or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("ssm_scan: a/b must be (T,D,N)-contiguous per batch "
                         "row with equal strides, c (T,N)-contiguous, h0 "
                         "contiguous")


def _cuda(x) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    return True


def _fwd(a, b, c, h0, ckpt):
    """Launch the scan; ``ckpt`` (B, windows(T), D, N) or None."""
    global launches
    bsz, t, d, n = a.shape
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=a.device)
    launch("ssm_scan", a.device, load_kernels()[0], a.data_ptr(),
           b.data_ptr(), c.data_ptr(), h0.data_ptr(), y.data_ptr(),
           h_last.data_ptr(), None if ckpt is None else ckpt.data_ptr(),
           WINDOW, bsz, t, d, n, a.stride(0), c.stride(0), y.stride(0))
    launches += 1
    return y, h_last


def ssm_scan_kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor):
    """a, b (B,T,D,N) f32; c (B,T,N) f32; h0 (B,D,N) f32 -> (y (B,T,D) f32,
    h_last (B,D,N) f32): ``h_t = a_t * h_{t-1} + b_t``, ``y_t = <h_t, c_t>``
    over the state axis.  T may be 0 (then h_last equals h0)."""
    refuse_grad("ssm_scan", a, b, c, h0)
    _check(a, b, c, h0)
    if not _cuda(a):
        return ref.ssm_scan_ref(a, b, c, h0)
    return _fwd(a, b, c, h0, None)


def ssm_scan_ckpt_kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         h0: torch.Tensor):
    """``ssm_scan_kernel``'s (y, h_last), bit for bit, and ckpt (B,
    windows(T), D, N) f32: the state before steps 0, WINDOW, 2 WINDOW, ...
    (so ``ckpt[:, 0]`` is h0), in the same launch."""
    refuse_grad("ssm_scan", a, b, c, h0)
    _check(a, b, c, h0)
    if not _cuda(a):
        return ref.ssm_scan_ckpt_ref(a, b, c, h0, WINDOW)
    bsz, t, d, n = a.shape
    ckpt = torch.empty((bsz, windows(t), d, n), dtype=torch.float32,
                       device=a.device)
    return _fwd(a, b, c, h0, ckpt) + (ckpt,)


def _check_bwd(a, b, c, ckpt, dy, dh_last) -> None:
    bsz, t, d, n = a.shape
    want = {"ckpt": (ckpt, (bsz, windows(t), d, n)), "dy": (dy, (bsz, t, d)),
            "dh_last": (dh_last, (bsz, d, n))}
    for name, (x, shape) in want.items():
        if x is None:
            continue
        if x.device != a.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"ssm_scan_bwd: {name} must be a contiguous "
                             f"float32 {shape} on {a.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not (a.is_contiguous() and b.is_contiguous() and c.is_contiguous()):
        raise ValueError("ssm_scan_bwd: a, b and c must be contiguous")


def ssm_scan_bwd_kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        ckpt: torch.Tensor, dy: torch.Tensor,
                        dh_last: torch.Tensor = None):
    """Gradients of the scan for dy (B,T,D) and dh_last (B,D,N) (None for
    zero), from the forward's inputs and ``ssm_scan_ckpt_kernel``'s ckpt
    -> (da, db (B,T,D,N), dc (B,T,N), dh0 (B,D,N)), all f32."""
    global bwd_launches
    refuse_grad("ssm_scan_bwd", a, b, c, ckpt, dy, dh_last)
    _check(a, b, c)
    _check_bwd(a, b, c, ckpt, dy, dh_last)
    bsz, t, d, n = a.shape
    if not _cuda(a):
        h0 = ckpt[:, 0] if t else a.new_zeros((bsz, d, n))
        return ref.ssm_scan_bwd_ref(a, b, c, h0, dy, dh_last)
    da, db = torch.empty_like(a), torch.empty_like(b)
    dc = torch.empty((bsz, t, n), dtype=torch.float32, device=a.device)
    dh0 = torch.empty((bsz, d, n), dtype=torch.float32, device=a.device)
    part = torch.empty((bsz, t, -(-d * n // _THREADS), n),
                       dtype=torch.float32, device=a.device)
    launch("ssm_scan backward", a.device, load_kernels()[1], a.data_ptr(),
           b.data_ptr(), c.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
           None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
           db.data_ptr(), dc.data_ptr(), dh0.data_ptr(), part.data_ptr(),
           WINDOW, bsz, t, d, n, a.stride(0), c.stride(0), dy.stride(0))
    bwd_launches += 1
    return da, db, dc, dh0


class SSMScanFn(torch.autograd.Function):
    """(y, h_last) = scan(a, b, c, h0): the forward kernel writing its state
    checkpoints, and the backward kernels from the saved (a, b, c, ckpt).
    An unused output's gradient arrives as None (dh_last of a loss that
    reads y alone), and the kernel reads it as zero."""

    @staticmethod
    def forward(ctx, a, b, c, h0):
        y, h_last, ckpt = ssm_scan_ckpt_kernel(a, b, c, h0)
        ctx.save_for_backward(a, b, c, ckpt)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, b, c, ckpt = ctx.saved_tensors
        if dy is None:
            dy = a.new_zeros(a.shape[:3])
        grads = ssm_scan_bwd_kernel(
            a, b, c, ckpt, dy.contiguous(),
            None if dh_last is None else dh_last.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
