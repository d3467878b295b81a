"""Wrapper of the CUDA C++ selective-scan kernels (``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``ssm_scan_kernel`` (K7) of
``src/repro/kernels/ssm_scan.py``; the source file's header says how the
kernels are laid out and what bounds them.  Entry points:

- ``ssm_scan_kernel``: the scan, (y, h_last) (serving, and every call that
  records no gradient);
- ``ssm_scan_ckpt_kernel``: the same launch also writing the state every
  ``WINDOW`` steps, which the backward rebuilds its windows from;
- ``ssm_scan_bwd_kernel``: the gradient, da, db, dc and dh0 (the TPU
  kernel has none: the JAX package differentiates its jnp scan);
- ``ssm_scan_fused_kernel``, ``ssm_scan_fused_ckpt_kernel`` and
  ``ssm_scan_fused_bwd_kernel``: the same three with Mamba1's
  discretisation (a = exp(dt A), b = (dt B) x) computed in the kernel from
  dt, A, B, C and x, whose backward gives d(dt), dA, dB, dC, dx and dh0 and
  never da or db (what every Mamba1 layer of the port calls).

``SSMScanFn`` and ``SSMScanFusedFn`` make the scans differentiable.  Each wrapper checks what it is
given and raises on anything the kernels do not take, allocates outputs and
scratch with ``torch.empty`` and launches on the current CUDA stream.
Tensors that lie on the CPU take the plain versions (``ref.ssm_scan_ref``,
``ref.ssm_scan_ckpt_ref``, ``ref.ssm_scan_bwd_ref``; the fused entries
``ref.ssm_discretise_ref`` before them, and ``ref.ssm_scan_fused_bwd_ref``);
CUDA tensors launch the kernels or raise; ``meta`` tensors get empty
outputs.  Each call reports to the dry run's analyzer (``kernels.costed``)
the dots of the reference's scan (``mamba._chunked_selective_scan``): its
``einsum("btdn,btn->btd")``, 2 B T D N FLOPs, in the forward and that
einsum's two transposes in the backward (``scan_flops``; the
discretisation and the associative scan are elementwise), and its outputs'
bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (build, costed, count, device_branch, launch,
                                 ref, refuse_grad)

# forward launches (with or without checkpoints, fused or not) and backward
# calls (each launches the windowed backward and the ordered sums of its
# partials) since the last reset (chip_smoke.py reads and zeroes them)
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
# repro_ssm_scan_fused(dt, x, bm, c, A, h0, y, h_last, ckpt, window, bf16,
#                      B, T, D, N, bm_bstride, bm_tstride, c_bstride,
#                      c_tstride, stream)
_FUSED_ARGS = [_P] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4 + [_P]
# repro_ssm_scan_fused_bwd(dt, x, bm, c, A, ckpt, dy, dh_last, ddt, dx, dbm,
#                          dc, dA, dh0, part, dA_part, window, bf16, B, T, D,
#                          N, bm_bstride, bm_tstride, c_bstride, c_tstride,
#                          stream)
_FUSED_BWD_ARGS = [_P] * 16 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4 \
    + [_P]
# the model dtypes the fused entries take for x, B and C
_FUSED_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 32        # one state element a lane, N lanes of one warp per d
_MAX_BATCH = 65535    # the grid's y axis
_THREADS = 256        # a block: 256 / N values of d (dc's partials a block)
WINDOW = 16           # steps between the forward's state checkpoints


def load_kernels():
    """The C entry points (forward, backward, fused forward, fused
    backward), built from ``csrc/ssm_scan.cu`` at the first call; the
    source's checkpoint window must be ``WINDOW``."""
    fwd = build.load("ssm_scan", "repro_ssm_scan", _FWD_ARGS)
    bwd = build.load("ssm_scan", "repro_ssm_scan_bwd", _BWD_ARGS)
    fused = build.load("ssm_scan", "repro_ssm_scan_fused", _FUSED_ARGS)
    fused_bwd = build.load("ssm_scan", "repro_ssm_scan_fused_bwd",
                           _FUSED_BWD_ARGS)
    window = build.load("ssm_scan", "repro_ssm_scan_window", [])()
    if window != WINDOW:
        raise RuntimeError(f"ssm_scan: csrc/ssm_scan.cu checkpoints every "
                           f"{window} steps, the wrapper expects {WINDOW}")
    return fwd, bwd, fused, fused_bwd


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


def scan_flops(bsz: int, t: int, d: int, n: int, dots: int) -> int:
    """FLOPs of ``dots`` products of the reference scan's readout at (B, T,
    D, N): each 2 B T D N (the forward's y = <h, c>; the backward's dh =
    dy c and dc = <h, dy>)."""
    return dots * 2 * bsz * t * d * n


def _f32(*shape, like):
    return like.new_empty(shape, dtype=torch.float32)


def _fwd(a, b, c, h0, ckpt):
    """Launch the scan; ``ckpt`` (B, windows(T), D, N) or None."""
    bsz, t, d, n = a.shape
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=a.device)
    launch("ssm_scan", a.device, load_kernels()[0], a.data_ptr(),
           b.data_ptr(), c.data_ptr(), h0.data_ptr(), y.data_ptr(),
           h_last.data_ptr(), None if ckpt is None else ckpt.data_ptr(),
           WINDOW, bsz, t, d, n, a.stride(0), c.stride(0), y.stride(0))
    count(globals(), "launches")
    return y, h_last


def ssm_scan_kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor):
    """a, b (B,T,D,N) f32; c (B,T,N) f32; h0 (B,D,N) f32 -> (y (B,T,D) f32,
    h_last (B,D,N) f32): ``h_t = a_t * h_{t-1} + b_t``, ``y_t = <h_t, c_t>``
    over the state axis.  T may be 0 (then h_last equals h0)."""
    refuse_grad("ssm_scan", a, b, c, h0)
    _check(a, b, c, h0)
    return costed("ssm_scan", scan_flops(*a.shape, 1), _scan, a, b, c, h0)


def _scan(a, b, c, h0):
    branch = device_branch("ssm_scan", a)
    if branch == "meta":
        bsz, t, d, n = a.shape
        return _f32(bsz, t, d, like=a), _f32(bsz, d, n, like=a)
    if branch == "cpu":
        return ref.ssm_scan_ref(a, b, c, h0)
    return _fwd(a, b, c, h0, None)


def ssm_scan_ckpt_kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         h0: torch.Tensor):
    """``ssm_scan_kernel``'s (y, h_last), bit for bit, and ckpt (B,
    windows(T), D, N) f32: the state before steps 0, WINDOW, 2 WINDOW, ...
    (so ``ckpt[:, 0]`` is h0), in the same launch."""
    refuse_grad("ssm_scan", a, b, c, h0)
    _check(a, b, c, h0)
    return costed("ssm_scan", scan_flops(*a.shape, 1), _scan_ckpt, a, b, c,
                  h0)


def _scan_ckpt(a, b, c, h0):
    branch = device_branch("ssm_scan", a)
    bsz, t, d, n = a.shape
    if branch == "meta":
        return _f32(bsz, t, d, like=a), _f32(bsz, d, n, like=a), \
            _f32(bsz, windows(t), d, n, like=a)
    if branch == "cpu":
        return ref.ssm_scan_ckpt_ref(a, b, c, h0, WINDOW)
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
    refuse_grad("ssm_scan_bwd", a, b, c, ckpt, dy, dh_last)
    _check(a, b, c)
    _check_bwd(a, b, c, ckpt, dy, dh_last)
    return costed("ssm_scan_bwd", scan_flops(*a.shape, 2), _scan_bwd, a, b,
                  c, ckpt, dy, dh_last)


def _scan_bwd(a, b, c, ckpt, dy, dh_last):
    branch = device_branch("ssm_scan_bwd", a)
    bsz, t, d, n = a.shape
    if branch == "meta":
        return torch.empty_like(a), torch.empty_like(b), \
            _f32(bsz, t, n, like=a), _f32(bsz, d, n, like=a)
    if branch == "cpu":
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
    count(globals(), "bwd_launches")
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


# -- the fused entries: Mamba1's discretisation inside the kernel ------------

def _check_fused(dt, A, Bm, C, x, h0=None) -> None:
    ts = (dt, A, Bm, C, x) + (() if h0 is None else (h0,))
    if any(t.device != dt.device for t in ts):
        raise ValueError("ssm_scan_fused: all inputs must share one device")
    if dt.dim() != 3 or A.dim() != 2 or Bm.dim() != 3:
        raise ValueError(f"ssm_scan_fused: dt (B,T,D), A (D,N), B (B,T,N); "
                         f"got {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    bsz, t, d = dt.shape
    n = A.shape[1]
    want = {"x": (x, (bsz, t, d)), "A": (A, (d, n)), "B": (Bm, (bsz, t, n)),
            "C": (C, (bsz, t, n))}
    if h0 is not None:
        want["h0"] = (h0, (bsz, d, n))
    for name, (v, shape) in want.items():
        if tuple(v.shape) != shape:
            raise ValueError(f"ssm_scan_fused: {name} {tuple(v.shape)} does "
                             f"not match dt {tuple(dt.shape)} and A "
                             f"{tuple(A.shape)}: expected {shape}")
    if any(v.dtype != torch.float32
           for v in (dt, A) + (() if h0 is None else (h0,))):
        raise TypeError("ssm_scan_fused: dt, A and h0 must be float32")
    if x.dtype not in _FUSED_DTYPES or Bm.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"ssm_scan_fused: x, B and C must share one dtype of "
                        f"{_FUSED_DTYPES}, got {x.dtype}/{Bm.dtype}/"
                        f"{C.dtype}")
    if n < 1 or n > MAX_STATE or n & (n - 1):
        raise ValueError(f"ssm_scan_fused: state size N={n} must be a power "
                         f"of two up to {MAX_STATE}")
    if bsz > _MAX_BATCH:
        raise ValueError(f"ssm_scan_fused: batch {bsz} exceeds {_MAX_BATCH}")
    # B and C may be slices of the layer's projection: rows of any stride,
    # unit stride along N
    if not (dt.is_contiguous() and x.is_contiguous() and A.is_contiguous()
            and (h0 is None or h0.is_contiguous())) \
            or any(v.numel() and n > 1 and v.stride(2) != 1
                   for v in (Bm, C)):
        raise ValueError("ssm_scan_fused: dt, x, A and h0 must be "
                         "contiguous, B and C of unit stride along N")


def _fused_fwd(dt, A, Bm, C, x, h0, ckpt):
    """Launch the fused scan; ``ckpt`` (B, windows(T), D, N) or None."""
    bsz, t, d = dt.shape
    n = A.shape[1]
    y = torch.empty((bsz, t, d), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
    launch("ssm_scan fused", dt.device, load_kernels()[2], dt.data_ptr(),
           x.data_ptr(), Bm.data_ptr(), C.data_ptr(), A.data_ptr(),
           h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
           None if ckpt is None else ckpt.data_ptr(), WINDOW,
           int(x.dtype == torch.bfloat16), bsz, t, d, n, Bm.stride(0),
           Bm.stride(1), C.stride(0), C.stride(1))
    count(globals(), "launches")
    return y, h_last


def ssm_scan_fused_kernel(dt: torch.Tensor, A: torch.Tensor,
                          Bm: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                          h0: torch.Tensor):
    """dt (B,T,D) f32 (after softplus), A (D,N) f32, B and C (B,T,N) and x
    (B,T,D) in the model's dtype (f32 or bf16), h0 (B,D,N) f32 -> (y (B,T,D)
    f32, h_last (B,D,N) f32): the scan of a = exp(dt A), b = (dt B) x and
    c = C, with a and b made in the kernel."""
    refuse_grad("ssm_scan_fused", dt, A, Bm, C, x, h0)
    _check_fused(dt, A, Bm, C, x, h0)
    return costed("ssm_scan", _fused_flops(dt, A, 1), _fused, dt, A, Bm, C,
                  x, h0)


def _fused_flops(dt, A, dots: int) -> int:
    return scan_flops(*dt.shape, A.shape[1], dots)


def _fused(dt, A, Bm, C, x, h0):
    branch = device_branch("ssm_scan_fused", dt)
    if branch == "meta":
        bsz, t, d = dt.shape
        return _f32(bsz, t, d, like=dt), _f32(bsz, d, A.shape[1], like=dt)
    if branch == "cpu":
        return ref.ssm_scan_fused_ref(dt, A, Bm, C, x, h0)
    return _fused_fwd(dt, A, Bm, C, x, h0, None)


def ssm_scan_fused_ckpt_kernel(dt: torch.Tensor, A: torch.Tensor,
                               Bm: torch.Tensor, C: torch.Tensor,
                               x: torch.Tensor, h0: torch.Tensor):
    """``ssm_scan_fused_kernel``'s (y, h_last), bit for bit, and ckpt (B,
    windows(T), D, N) f32, the state before steps 0, WINDOW, 2 WINDOW, ...,
    in the same launch."""
    refuse_grad("ssm_scan_fused", dt, A, Bm, C, x, h0)
    _check_fused(dt, A, Bm, C, x, h0)
    return costed("ssm_scan", _fused_flops(dt, A, 1), _fused_ckpt, dt, A, Bm,
                  C, x, h0)


def _fused_ckpt(dt, A, Bm, C, x, h0):
    branch = device_branch("ssm_scan_fused", dt)
    bsz, t, d = dt.shape
    n = A.shape[1]
    if branch == "meta":
        return _f32(bsz, t, d, like=dt), _f32(bsz, d, n, like=dt), \
            _f32(bsz, windows(t), d, n, like=dt)
    if branch == "cpu":
        a, b = ref.ssm_discretise_ref(dt, A, Bm, x)
        return ref.ssm_scan_ckpt_ref(a, b, C.float(), h0, WINDOW)
    ckpt = torch.empty((bsz, windows(t), d, n), dtype=torch.float32,
                       device=dt.device)
    return _fused_fwd(dt, A, Bm, C, x, h0, ckpt) + (ckpt,)


def ssm_scan_fused_bwd_kernel(dt: torch.Tensor, A: torch.Tensor,
                              Bm: torch.Tensor, C: torch.Tensor,
                              x: torch.Tensor, ckpt: torch.Tensor,
                              dy: torch.Tensor, dh_last: torch.Tensor = None):
    """Gradients of the fused scan for dy (B,T,D) and dh_last (B,D,N) (None
    for zero), from its inputs and ``ssm_scan_fused_ckpt_kernel``'s ckpt ->
    (d(dt) (B,T,D) f32, dA (D,N) f32, dB and dC (B,T,N) and dx (B,T,D) in
    x's dtype, dh0 (B,D,N) f32)."""
    refuse_grad("ssm_scan_fused_bwd", dt, A, Bm, C, x, ckpt, dy, dh_last)
    _check_fused(dt, A, Bm, C, x)
    bsz, t, d = dt.shape
    n = A.shape[1]
    want = {"ckpt": (ckpt, (bsz, windows(t), d, n)), "dy": (dy, (bsz, t, d)),
            "dh_last": (dh_last, (bsz, d, n))}
    for name, (v, shape) in want.items():
        if v is None:
            continue
        if v.device != dt.device or v.dtype != torch.float32 \
                or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"ssm_scan_fused_bwd: {name} must be a "
                             f"contiguous float32 {shape} on {dt.device}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    return costed("ssm_scan_bwd", _fused_flops(dt, A, 2), _fused_bwd, dt, A,
                  Bm, C, x, ckpt, dy, dh_last)


def _fused_bwd(dt, A, Bm, C, x, ckpt, dy, dh_last):
    branch = device_branch("ssm_scan_fused_bwd", dt)
    bsz, t, d = dt.shape
    n = A.shape[1]
    if branch == "meta":
        return (_f32(bsz, t, d, like=dt), _f32(d, n, like=dt),
                Bm.new_empty((bsz, t, n)), C.new_empty((bsz, t, n)),
                torch.empty_like(x), _f32(bsz, d, n, like=dt))
    if branch == "cpu":
        h0 = ckpt[:, 0] if t else dt.new_zeros((bsz, d, n))
        return ref.ssm_scan_fused_bwd_ref(dt, A, Bm, C, x, h0, dy, dh_last)
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt = torch.empty((bsz, t, d), **f32)
    dA = torch.empty((d, n), **f32)
    dB = torch.empty((bsz, t, n), dtype=x.dtype, device=dt.device)
    dC = torch.empty_like(dB)
    dx = torch.empty_like(x)
    dh0 = torch.empty((bsz, d, n), **f32)
    part = torch.empty((2, bsz, t, -(-d * n // _THREADS), n), **f32)
    dA_part = torch.empty((bsz, d, n), **f32)
    launch("ssm_scan fused backward", dt.device, load_kernels()[3],
           dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), C.data_ptr(),
           A.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
           None if dh_last is None else dh_last.data_ptr(), ddt.data_ptr(),
           dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
           dh0.data_ptr(), part.data_ptr(), dA_part.data_ptr(), WINDOW,
           int(x.dtype == torch.bfloat16), bsz, t, d, n, Bm.stride(0),
           Bm.stride(1), C.stride(0), C.stride(1))
    count(globals(), "bwd_launches")
    return ddt, dA, dB, dC, dx, dh0


class SSMScanFusedFn(torch.autograd.Function):
    """(y, h_last) = fused scan(dt, A, B, C, x, h0): the fused forward
    kernel writing its state checkpoints, and the fused backward kernels
    from the saved inputs and checkpoints, which give each input's gradient
    in its dtype (A = -exp(A_log) stays a torch op outside, so autograd
    carries dA on to A_log).  An unused output's gradient arrives as None
    (dh_last of a loss that reads y alone), and the kernel reads it as
    zero."""

    @staticmethod
    def forward(ctx, dt, A, Bm, C, x, h0):
        y, h_last, ckpt = ssm_scan_fused_ckpt_kernel(dt, A, Bm, C, x, h0)
        ctx.save_for_backward(dt, A, Bm, C, x, ckpt)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, A, Bm, C, x, ckpt = ctx.saved_tensors
        if dy is None:
            dy = dt.new_zeros(dt.shape)
        grads = ssm_scan_fused_bwd_kernel(
            dt, A, Bm, C, x, ckpt, dy.contiguous(),
            None if dh_last is None else dh_last.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
