"""Wrappers of the CUDA C++ flash-attention kernels (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_kernel`` of
``src/repro/kernels/flash_attention.py`` and adds the backward that the TPU
kernel lacks; the source file's header says how the kernels are laid out and
what bounds them (bf16 on the tensor cores, f32 on the CUDA cores).
Grouped-query attention is read in the kernels: q is (B*H, Sq, hd) and k/v
(B*KV, Skv, hd), with B*KV dividing B*H, and no KV head is repeated.
``flash_attention_kernel`` returns the output and the
per-row log-sum-exp, ``flash_attention_bwd_kernel`` the three input
gradients from them, and ``FlashAttentionFn`` joins the two as a
``torch.autograd.Function``.  The wrappers check what they are given and
raise on anything the kernels do not take, allocate outputs and scratch with
``torch.empty`` and launch on the current CUDA stream.  Tensors that lie on
the CPU take the plain versions (``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``); CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count, ref, refuse_grad

# kernel launches since the last reset (chip_smoke.py reads and zeroes them):
# forward calls, and backward calls (each runs the D, dK/dV and dQ kernels)
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# repro_flash_attention_fwd(q, k, v, o, lse, BH, BKV, Sq, Skv, hd, causal,
#                           q_offset, dtype, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# repro_flash_attention_bwd(q, k, v, o, lse, do, dq, dk, dv, D, BH, BKV, Sq,
#                           Skv, hd, causal, q_offset, dtype, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]
MAX_BH = 65535      # the kernels' grid puts (batch, head) on its y axis
ALIGN = 16          # the bf16 kernels copy rows in 16-byte cp.async chunks


def load_kernels():
    """The forward and backward C entry points, built from
    ``csrc/flash_attention.cu`` at the first call."""
    return (build.load("flash_attention", "repro_flash_attention_fwd",
                       _FWD_ARGTYPES),
            build.load("flash_attention", "repro_flash_attention_bwd",
                       _BWD_ARGTYPES))


def _check(q, k, v, q_offset, extra=()) -> None:
    """extra: (name, tensor, expected shape, expected dtype) of the
    backward's further inputs."""
    ts = (q, k, v) + tuple(t for _, t, _, _ in extra)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention: all inputs must share one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must be one of float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[2] != q.shape[2] or k.shape[0] < 1 \
            or q.shape[0] % k.shape[0]:
        raise ValueError(f"flash_attention: q (BH,Sq,hd), k/v (BKV,Skv,hd) "
                         f"with BKV dividing BH, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, hd = q.shape
    if hd % 8 or hd > 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         "of 8 and at most 256")
    if k.shape[1] < 1:
        raise ValueError("flash_attention: at least one key")
    if bh > MAX_BH:
        raise ValueError(f"flash_attention: BH {bh} exceeds the kernels' "
                         f"grid ({MAX_BH})")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    for name, t, shape, dtype in extra:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"flash_attention: {name} must be {dtype} of "
                             f"shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention: inputs must be contiguous")


def _check_aligned(*ts) -> None:
    if any(t.data_ptr() % ALIGN for t in ts):
        raise ValueError(f"flash_attention: CUDA inputs must be "
                         f"{ALIGN}-byte aligned")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, q_offset: int = 0):
    """q (BH,Sq,hd), k/v (BKV,Skv,hd), BKV dividing BH (query head bh
    reads KV head bh // (BH // BKV)) -> (o (BH,Sq,hd) in q's dtype,
    lse (BH,Sq) f32)."""
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_aligned(q, k, v)
    bh, sq, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    fwd, _ = load_kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), bh, k.shape[0], sq, k.shape[1], hd,
                  int(bool(causal)), int(q_offset), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention forward launch failed: "
                           f"cudaError {err}")
    count(globals(), "launches")
    return o, lse


def flash_attention_bwd_kernel(q, k, v, o, lse, do, causal: bool = True,
                               q_offset: int = 0):
    """Gradients of ``flash_attention_kernel``'s o: q, k, v, o, do as in the
    forward, lse (BH,Sq) f32 from it -> (dq, dk, dv) in q's dtype, dk and dv
    (BKV,Skv,hd) summed over each KV head's group of query heads."""
    refuse_grad("flash_attention_bwd", q, k, v, o, lse, do)
    _check(q, k, v, q_offset, extra=(
        ("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
        ("lse", lse, q.shape[:2], torch.float32)))
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                           q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_aligned(q, k, v, o, do)
    bh, sq, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    scratch = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _, bwd = load_kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), bh,
                  k.shape[0], sq, k.shape[1], hd, int(bool(causal)),
                  int(q_offset), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {err}")
    count(globals(), "bwd_launches")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v) on q (BH,Sq,hd) and k/v (BKV,Skv,hd): the
    forward kernel, and the backward kernel from the saved (q, k, v, o,
    lse), whose dk and dv already hold each group's sum."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        o, lse = flash_attention_kernel(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None
