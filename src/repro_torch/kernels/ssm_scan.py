"""Wrapper of the CUDA C++ selective-scan kernel (``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``ssm_scan_kernel`` (K7) of
``src/repro/kernels/ssm_scan.py``; the source file's header says how the
kernel is laid out and what bounds it.  The wrapper checks what it is given
and raises on anything the kernel does not take, allocates the outputs with
``torch.empty`` and launches on the current CUDA stream.  Tensors that lie
on the CPU take the plain version (``ref.ssm_scan_ref``); CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref, refuse_grad

# kernel launches since the last reset (chip_smoke.py reads and zeroes it)
launches = 0

# repro_ssm_scan(a, b, c, h0, y, h_last, B, T, D, N, ab_bstride, c_bstride,
#                y_bstride, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
MAX_STATE = 32        # one state element a lane, N lanes of one warp per d
_MAX_BATCH = 65535    # the grid's y axis


def load_kernel():
    """The kernel's C entry point, built from ``csrc/ssm_scan.cu`` at the
    first call."""
    return build.load("ssm_scan", "repro_ssm_scan", _ARGTYPES)


def _check(a, b, c, h0) -> None:
    ts = (a, b, c, h0)
    if any(t.device != a.device for t in ts):
        raise ValueError("ssm_scan: all inputs must share one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssm_scan: a, b, c and h0 must be float32, got "
                        + "/".join(str(t.dtype) for t in ts))
    if a.dim() != 4 or b.shape != a.shape or c.dim() != 3 or h0.dim() != 3:
        raise ValueError(f"ssm_scan: a, b (B,T,D,N), c (B,T,N), h0 (B,D,N); "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(h0.shape)}")
    bsz, t, d, n = a.shape
    if c.shape != (bsz, t, n) or h0.shape != (bsz, d, n):
        raise ValueError(f"ssm_scan: c {tuple(c.shape)} or h0 "
                         f"{tuple(h0.shape)} do not match a {tuple(a.shape)}")
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
            or not inner(c, (n, 1)) or not h0.is_contiguous():
        raise ValueError("ssm_scan: a/b must be (T,D,N)-contiguous per batch "
                         "row with equal strides, c (T,N)-contiguous, h0 "
                         "contiguous")


def ssm_scan_kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor):
    """a, b (B,T,D,N) f32; c (B,T,N) f32; h0 (B,D,N) f32 -> (y (B,T,D) f32,
    h_last (B,D,N) f32): ``h_t = a_t * h_{t-1} + b_t``, ``y_t = <h_t, c_t>``
    over the state axis.  T may be 0 (then h_last equals h0)."""
    global launches
    refuse_grad("ssm_scan", a, b, c, h0)
    _check(a, b, c, h0)
    if a.device.type == "cpu":
        return ref.ssm_scan_ref(a, b, c, h0)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {a.device}")
    bsz, t, d, n = a.shape
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=a.device)
    fn = load_kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), h0.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), bsz, t, d, n, a.stride(0),
                 c.stride(0), y.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h_last
