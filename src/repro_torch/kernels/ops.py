"""Model-facing wrappers of the port's kernels (mirrors
``src/repro/kernels/ops.py``): the GQA grouping of the paged-attention
callers, flash attention (the training path's, differentiable), the row
flattening of rmsnorm and of its pair (differentiable) and the matrix
product that the compiler's codegen calls, the segmented LoRA shrink,
expand and fused delta, the selective scan (differentiable) with its
chunked-prefill entry, and Mamba1's fused scan (its discretisation in the
kernel; differentiable).  Each wrapper hands its tensors to a kernel wrapper,
which launches the kernel for CUDA tensors and runs the plain version for
CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import rmsnorm as _k2
from repro_torch.kernels import ssm_scan as _k7
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.lora import (lora_delta_kernel, lora_expand_kernel,
                                     lora_shrink_kernel)
from repro_torch.kernels.matmul import matmul_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.ssm_scan import SSMScanFn, ssm_scan_kernel


def _int32(ids):
    """ids as a contiguous int32 tensor, with no call where they are one
    already (the LoRA wrappers run once per adapted projection)."""
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    return ids.contiguous()


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
    # rows grouped per KV head: r = g_i * C + c_i (with one query head per
    # KV head the reshape is a strided view, hence the copy)
    qg = q.transpose(1, 2).reshape(b, kv, group * c, hd).contiguous()
    qpos = chunk_pos.to(torch.int32).repeat(group)[None, :] \
        .expand(b, group * c).contiguous()
    o = paged_attention_kernel(qg, k_pages, v_pages,
                               block_tables.to(torch.int32).contiguous(),
                               qpos, kv_lens.to(torch.int32),
                               pages_per_fetch=pages_per_fetch)
    return o.reshape(b, kv, group, c, hd).permute(0, 3, 1, 2, 4) \
        .reshape(b, c, h, hd)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd).  GQA is read in the
    kernels: query head h reads KV head h // (H // KV), no KV head is
    repeated, and the backward kernel sums dK and dV over each group in a
    fixed order (no atomics, so the gradients are the same bits every run).
    The one copy of K and V is the move of the heads ahead of the sequence
    into the kernels' (B*KV, Skv, hd) layout (``contiguous`` copies nothing
    after the reshape has).  The call goes through
    ``FlashAttentionFn`` (forward and backward kernels), which records
    nothing when no input requires grad or grad mode is off."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * kvh, skv, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * kvh, skv, hd).contiguous()
    o = FlashAttentionFn.apply(qf, kf, vf, causal, q_offset)
    return o.reshape(b, h, sq, hd).transpose(1, 2)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rmsnorm(x, w, eps: float = 1e-5, f32: bool = True):
    """RMSNorm over the last axis of x (any leading shape): through
    ``RMSNormFn`` (the forward and backward kernels) when autograd records,
    else the forward kernel called directly, with no Function's host cost
    (serving, and the recompute's first pass).  ``f32``: reduce and scale
    in f32, else in x's dtype (REPRO_NORM_F32)."""
    shape = x.shape
    x2, w2 = x.reshape(-1, shape[-1]).contiguous(), w.contiguous()
    if _records(x2, w2):
        return _k2.RMSNormFn.apply(x2, w2, eps, f32).reshape(shape)
    return _k2.rmsnorm_kernel(x2, w2, eps, f32=f32).reshape(shape)


def rmsnorm_pair(x1, w1, x2, w2, eps: float = 1e-5, f32: bool = True):
    """RMSNorm of x1 by w1 and of x2 by w2 over one last axis (any leading
    shapes), in one launch a direction: a layer's q and k norms.  Each
    output is bitwise ``rmsnorm`` of its own pair; ``RMSNormPairFn`` when
    autograd records, else the pair kernel directly."""
    d = x1.shape[-1]
    a1, a2 = x1.reshape(-1, d).contiguous(), x2.reshape(-1, d).contiguous()
    v1, v2 = w1.contiguous(), w2.contiguous()
    if _records(a1, v1, a2, v2):
        y1, y2 = _k2.RMSNormPairFn.apply(a1, v1, a2, v2, eps, f32)
    else:
        y1, y2 = _k2.rmsnorm_pair_kernel(a1, v1, a2, v2, eps, f32=f32)
    return y1.reshape(x1.shape), y2.reshape(x2.shape)


def matmul(a, b):
    """(M,K) @ (K,N) -> (M,N) in a's dtype with an f32 accumulator; any
    shape (the TPU kernel's block sizes are not carried over)."""
    return matmul_kernel(a.contiguous(), b.contiguous())


def lora_shrink(x, a_slab, idx, rows_per_seq: int = 1):
    """Segmented LoRA down-projection: each row of x (T,d) contracts against
    its own adapter's A, selected from the slab (S,d,R) by idx (-1 = base
    row, exact-zero output) -> (T,R) f32.  idx holds one slot per sequence
    of ``rows_per_seq`` rows (per row by default).  The gather happens
    inside the kernel; no per-row (d,R) copy is made."""
    return lora_shrink_kernel(x.contiguous(), a_slab.contiguous(),
                              _int32(idx),
                              rows_per_seq=rows_per_seq)


def ssm_scan(a, b, c, h0):
    """Batched selective scan: a, b (B,T,D,N), c (B,T,N), h0 (B,D,N), all
    f32 -> (y (B,T,D), h_last (B,D,N)).  The batch axis is the kernel's
    own (the JAX entry vmaps a single-sequence kernel).  Through
    ``SSMScanFn`` (the forward kernel with its state checkpoints, and the
    backward kernels) when autograd records, else the kernel called
    directly: serving launches and bits are those of the plain scan."""
    a, b, c, h0 = (t.contiguous() for t in (a, b, c, h0))
    if _records(a, b, c, h0):
        return SSMScanFn.apply(a, b, c, h0)
    return ssm_scan_kernel(a, b, c, h0)


def ssm_scan_chunked(a, b, c, h0, chunk: int):
    """Batched chunked-prefill scan: the shapes and result of the reference's
    ``chunk``-steps-a-launch scan (state carried between chunks, a ragged
    tail padded with the identity step a = 1, b = 0).  The recurrence is
    sequential, so chunking changes no bit of y or h_last
    (``ref.ssm_scan_chunked_ref`` shows it), and the CUDA kernel keeps its
    state in registers rather than a tile of ``chunk`` steps: one launch
    over all T, with ``chunk`` checked and otherwise unused."""
    if chunk < 1:
        raise ValueError(f"ssm_scan_chunked: chunk must be >= 1, got {chunk}")
    return ssm_scan(a, b, c, h0)


def ssm_scan_fused(dt, A, Bm, C, x, h0):
    """Mamba1's selective scan with its discretisation in the kernel: dt
    (B,T,D) f32 after softplus, A (D,N) f32, B and C (B,T,N) and x (B,T,D)
    in the model's dtype, h0 (B,D,N) f32 -> (y (B,T,D) f32, h_last (B,D,N)
    f32), the scan of a = exp(dt A), b = (dt B) x and c = C.  No (B,T,D,N)
    tensor is made.  One launch over all T (a chunked prefill gives the
    same bits: masked positions, dt = 0, are identity steps).  Through
    ``SSMScanFusedFn`` (the forward kernel with its state checkpoints, and
    the fused backward kernels) when autograd records, else the kernel
    called directly.  B and C may be slices of the layer's projection;
    they are copied only if their last axis is strided."""
    dt, A, x, h0 = (t.contiguous() for t in (dt, A, x, h0))
    Bm, C = (t if t.shape[-1] == 1 or t.stride(-1) == 1 else t.contiguous()
             for t in (Bm, C))
    if _records(dt, A, Bm, C, x, h0):
        return _k7.SSMScanFusedFn.apply(dt, A, Bm, C, x, h0)
    return _k7.ssm_scan_fused_kernel(dt, A, Bm, C, x, h0)


def lora_expand(h, b_slab, idx, block_out: int = 256, rows_per_seq: int = 1):
    """Segmented LoRA up-projection: h (T,R) f32 against the slab (S,R,O) by
    idx (one slot per sequence of ``rows_per_seq`` rows) -> (T,O) in the
    slab's dtype.  ``block_out`` tiles the output features (the plan's
    choice, ``codegen.lora_tiles``)."""
    return lora_expand_kernel(h.contiguous(), b_slab.contiguous(),
                              _int32(idx),
                              block_out=block_out, rows_per_seq=rows_per_seq)


def lora_delta(x, a_slab, b_slab, ids, rows_per_seq: int = 1,
               block_out: int = 256, base=None):
    """The segmented LoRA delta in one launch: x (T,d) through each
    sequence's own A (S,d,R) and B (S,R,O), ids (T / rows_per_seq,) one slot
    per sequence -> (T,O) in x's dtype, plus ``base`` (T,O) when given.
    Bitwise ``lora_expand(lora_shrink(x))`` (+ base) at the same
    ``rows_per_seq``; h never leaves the chip."""
    return lora_delta_kernel(x.contiguous(), a_slab.contiguous(),
                             b_slab.contiguous(),
                             _int32(ids),
                             rows_per_seq=rows_per_seq, block_out=block_out,
                             base=None if base is None else base.contiguous())
