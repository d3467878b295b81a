"""Wrapper of the CUDA C++ matrix-product kernel (``csrc/matmul.cu``).

Replaces the Pallas TPU kernel ``matmul_kernel`` of
``src/repro/kernels/matmul.py``; the source file's header says how the
kernel is laid out and what bounds it.  The compiler's codegen
(``repro_torch.core.codegen.compile_term(use_kernels=True)``) reaches it for
every logical ``matmul``.  The wrapper checks what it is given and raises
on anything the kernel does not take, allocates the output with
``torch.empty`` and launches on the current CUDA stream.  Tensors that lie
on the CPU take the plain version (``ref.matmul_ref``); CUDA tensors launch
the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref, refuse_grad

# kernel launches since the last reset (chip_smoke.py reads and zeroes it)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# repro_matmul(a, b, c, M, N, K, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the kernel's grid puts 64-row tiles on its y axis (at most 65535)
MAX_ROWS = 65535 * 64
_INT_MAX = 2**31 - 1


def load_kernel():
    """The kernel's C entry point, built from ``csrc/matmul.cu`` at the
    first call."""
    return build.load("matmul", "repro_matmul", _ARGTYPES)


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype, accumulated in f32."""
    global launches
    refuse_grad("matmul", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: a (M,K) and b (K,N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError("matmul: a and b must share one device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul: a and b must both be float32 or bfloat16, "
                        f"got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: inputs must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if m > MAX_ROWS or max(k, n) > _INT_MAX:
        raise ValueError(f"matmul: shape ({m},{k})@({k},{n}) exceeds the "
                         f"kernel's grid ({MAX_ROWS} rows)")
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = load_kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                 _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out
