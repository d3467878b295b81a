"""Model-facing wrappers of the port's kernels (mirrors
``src/repro/kernels/ops.py``): the GQA grouping of the paged-attention
callers, the row flattening of rmsnorm and the matrix product that the
compiler's codegen calls.  Each wrapper hands its tensors
to a kernel wrapper, which launches the kernel for CUDA tensors and runs the
plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul import matmul_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_kernel


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    pages_per_fetch: int = 1):
    """Paged decode attention: q (B,1,H,hd), pages (N,bs,KV,hd),
    block_tables (B,M) int32, seq_lens (B,) int32 valid KV entries per row
    (>= 1) -> (B,1,H,hd).  Head h serves KV head h // (H//KV); KV is never
    repeated or copied."""
    b, _, h, hd = q.shape
    kv = k_pages.shape[2]
    group = h // kv
    seq_lens = seq_lens.to(torch.int32)
    qg = q.reshape(b, kv, group, hd)            # head = kv_i * group + g_i
    qpos = (seq_lens - 1)[:, None].expand(b, group).contiguous()
    o = paged_attention_kernel(qg, k_pages, v_pages,
                               block_tables.to(torch.int32), qpos, seq_lens,
                               pages_per_fetch=pages_per_fetch)
    return o.reshape(b, 1, h, hd)


def paged_attention_chunk(q, k_pages, v_pages, block_tables, chunk_pos,
                          kv_lens, pages_per_fetch: int = 1):
    """Paged chunked-prefill attention: q (B,C,H,hd) at absolute positions
    chunk_pos (C,) int32, attending causally to the first kv_lens (B,)
    entries of the paged span -> (B,C,H,hd)."""
    b, c, h, hd = q.shape
    kv = k_pages.shape[2]
    group = h // kv
    # rows grouped per KV head: r = g_i * C + c_i
    qg = q.transpose(1, 2).reshape(b, kv, group * c, hd)
    qpos = chunk_pos.to(torch.int32).repeat(group)[None, :] \
        .expand(b, group * c).contiguous()
    o = paged_attention_kernel(qg, k_pages, v_pages,
                               block_tables.to(torch.int32).contiguous(),
                               qpos, kv_lens.to(torch.int32),
                               pages_per_fetch=pages_per_fetch)
    return o.reshape(b, kv, group, c, hd).permute(0, 3, 1, 2, 4) \
        .reshape(b, c, h, hd)


def rmsnorm(x, w, eps: float = 1e-5):
    """RMSNorm over the last axis of x (any leading shape)."""
    shape = x.shape
    out = rmsnorm_kernel(x.reshape(-1, shape[-1]).contiguous(),
                         w.contiguous(), eps)
    return out.reshape(shape)


def matmul(a, b):
    """(M,K) @ (K,N) -> (M,N) in a's dtype with an f32 accumulator; any
    shape (the TPU kernel's block sizes are not carried over)."""
    return matmul_kernel(a.contiguous(), b.contiguous())
