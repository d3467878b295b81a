"""Plain PyTorch versions of the port's kernels.

Each mirrors its oracle in ``src/repro/kernels/ref.py``: the CPU tests hold
the port against JAX through them, ``chip_smoke.py`` holds each kernel
against them on the card, and the kernel wrappers run them for tensors that
lie on the CPU.  They are deliberately straightforward: gather the whole
span and take an exact masked softmax in f32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_rows_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_tables: torch.Tensor,
                             q_pos: torch.Tensor, kv_lens: torch.Tensor
                             ) -> torch.Tensor:
    """The paged-attention kernel's own interface: q (B,KV,R,hd) with R query
    rows grouped under each KV head, per-row causal bound q_pos (B,R), span
    length kv_lens (B,) -> (B,KV,R,hd) in f32."""
    b, kv, r, hd = q.shape
    bs = k_pages.shape[1]
    m = block_tables.shape[1]
    tables = block_tables.long()
    kg = k_pages[tables].reshape(b, m * bs, kv, hd).float()
    vg = v_pages[tables].reshape(b, m * bs, kv, hd).float()
    s = torch.einsum("bkrd,bskd->bkrs", q.float(), kg) / math.sqrt(hd)
    kpos = torch.arange(m * bs, device=q.device)[None, None, None, :]
    live = (kpos <= q_pos[:, None, :, None]) & \
           (kpos < kv_lens[:, None, None, None])
    p = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    return torch.einsum("bkrs,bskd->bkrd", p, vg)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode: q (B,1,H,hd) -> (B,1,H,hd)."""
    b, _, h, hd = q.shape
    kv = k_pages.shape[2]
    group = h // kv
    qg = q.reshape(b, kv, group, hd)
    qpos = (seq_lens - 1)[:, None].expand(b, group)
    o = paged_attention_rows_ref(qg, k_pages, v_pages, block_tables, qpos,
                                 seq_lens)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def paged_attention_chunk_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_tables: torch.Tensor,
                              chunk_pos: torch.Tensor, kv_lens: torch.Tensor
                              ) -> torch.Tensor:
    """Chunked prefill: q (B,C,H,hd), absolute positions chunk_pos (C,)."""
    b, c, h, hd = q.shape
    kv = k_pages.shape[2]
    group = h // kv
    qg = q.transpose(1, 2).reshape(b, kv, group * c, hd)
    qpos = chunk_pos.repeat(group)[None, :].expand(b, group * c)
    o = paged_attention_rows_ref(qg, k_pages, v_pages, block_tables, qpos,
                                 kv_lens)
    return o.reshape(b, kv, group, c, hd).permute(0, 3, 1, 2, 4) \
        .reshape(b, c, h, hd).to(q.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) @ b (K,N) in f32, cast to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# Largest ``row_rel_err`` a kernel may show against its plain version, by the
# output's dtype.  bf16: kernel and plain version each round their f32 result
# once, and where the two f32 values straddle a rounding midpoint they land
# one bf16 step apart, at most 2^-7 of the element and so of its row's
# largest value; 2e-2 leaves 2.5 times that.  f32: reassociation only.
ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """How far a kernel's output is from its plain version, row by row.

    A row is one vector of the last axis (one head of one query for
    attention, one token for rmsnorm).  Returns ``(max |got - want|, max over
    rows of max|got - want|_row / max|want|_row)``.  Normalising each row by
    its own largest value keeps rows of small outputs (attention over long,
    nearly uniform spans) as tightly held as rows of large ones, so a kernel
    that zeroes or truncates them cannot hide under the largest row."""
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float(diff.max()), float((diff / scale).max())
