"""Wrapper of the CUDA C++ paged-attention kernel (``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernel ``paged_attention_kernel`` of
``src/repro/kernels/paged_attention.py``; the source file's header says how
the kernel is laid out and what bounds it.  The wrapper checks what it is
given and raises on anything the kernel does not take, allocates the output
with ``torch.empty`` and launches on the current CUDA stream.  Tensors that
lie on the CPU take the plain version (``ref.paged_attention_rows_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref, refuse_grad

# kernel launches since the last reset (chip_smoke.py reads and zeroes it)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# repro_paged_attention(q, k_pages, v_pages, block_tables, q_pos, kv_lens,
#                       out, B, KV, R, hd, bs, M, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def load_kernel():
    """The kernel's C entry point, built from ``csrc/paged_attention.cu`` at
    the first call."""
    return build.load("paged_attention", "repro_paged_attention", _ARGTYPES)


def _check(q, k_pages, v_pages, block_tables, q_pos, kv_lens) -> None:
    ts = (q, k_pages, v_pages, block_tables, q_pos, kv_lens)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_attention: all inputs must share one device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/pages must be one of float32 or "
                        f"bfloat16, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (block_tables, q_pos, kv_lens)):
        raise TypeError("paged_attention: block_tables, q_pos and kv_lens "
                        "must be int32")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("paged_attention: q (B,KV,R,hd), pages (N,bs,KV,hd)")
    b, kv, r, hd = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (kv, hd):
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or block_tables.shape[1] < 1:
        raise ValueError("paged_attention: block_tables must be (B, M>=1)")
    if q_pos.shape != (b, r) or kv_lens.shape != (b,):
        raise ValueError("paged_attention: q_pos (B,R), kv_lens (B,)")
    if hd % 8 or hd > 256:
        raise ValueError(f"paged_attention: head_dim {hd} must be a multiple "
                         "of 8 and at most 256")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention: inputs must be contiguous")


def paged_attention_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           q_pos: torch.Tensor, kv_lens: torch.Tensor,
                           pages_per_fetch: int = 1) -> torch.Tensor:
    """q (B,KV,R,hd); pages (N,bs,KV,hd); block_tables (B,M) int32; q_pos
    (B,R) int32 per-row causal bound; kv_lens (B,) int32 >= 1
    -> (B,KV,R,hd) in q's dtype.

    ``pages_per_fetch`` is the TPU kernel's DMA-grouping knob; the serve
    engine passes the value its compiler plan gives
    (``codegen.paged_pages_per_fetch``).  The CUDA kernel does not use it:
    its tile walk replaces per-fetch page grouping."""
    global launches
    refuse_grad("paged_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, block_tables, q_pos, kv_lens)
    if q.device.type == "cpu":
        return ref.paged_attention_rows_ref(
            q, k_pages, v_pages, block_tables, q_pos, kv_lens).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, kv, r, hd = q.shape
    _, bs, _, _ = k_pages.shape
    out = torch.empty_like(q)
    fn = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), q_pos.data_ptr(), kv_lens.data_ptr(),
                 out.data_ptr(), b, kv, r, hd, bs, block_tables.shape[1],
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
