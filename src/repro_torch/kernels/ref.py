"""Plain PyTorch versions of the port's kernels.

Each mirrors its oracle in ``src/repro/kernels/ref.py``: the CPU tests hold
the port against JAX through them, ``chip_smoke.py`` holds each kernel
against them on the card, and the kernel wrappers run them for tensors that
lie on the CPU.  They are deliberately straightforward: gather the whole
span (or each row's whole adapter matrix) and compute in f32.
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


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain attention's accumulation type: f32, or f64 for f64 inputs
    (the witness that both f32 sides are held against)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _group_kv(q, k):
    """k (BKV,S,hd) repeated to q's BH rows: row bh is KV row bh // group."""
    group = q.shape[0] // k.shape[0]
    return k if group == 1 else k.repeat_interleave(group, dim=0)


def _sum_groups(g, kv_rows):
    """(BH,S,hd) gradient of the repeated K or V -> (BKV,S,hd), each KV
    row the sum over its group in one fixed order."""
    return g if g.shape[0] == kv_rows else \
        g.unflatten(0, (kv_rows, -1)).sum(1)


def _flash_scores(q, k, causal, q_offset):
    """Scaled scores (BH,Sq,Skv) in ``_acc`` (k already at q's BH rows) and
    the visibility mask (Sq,Skv)."""
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[2]
    acc = _acc(q)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) / math.sqrt(hd)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    live = qpos >= kpos if causal else torch.ones_like(qpos >= kpos)
    return s, live


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0):
    """q (BH,Sq,hd), k/v (BKV,Skv,hd), BKV dividing BH (query head bh reads
    KV head bh // (BH // BKV)): exact softmax attention in f32 (f64 for f64
    inputs) -> (o in q's dtype, lse (BH,Sq) in the accumulation type, the
    log-sum-exp of each row's scaled scores)."""
    k, v = _group_kv(q, k), _group_kv(q, v)
    s, live = _flash_scores(q, k, causal, q_offset)
    s = torch.where(live, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.to(s.dtype))
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            q_offset: int = 0):
    """The analytic gradient of ``flash_attention_ref``'s o, with P
    recomputed from lse: (dq, dk, dv) in q's dtype, computed in f32 (f64
    for f64 inputs); dk and dv (BKV,Skv,hd) summed over each group."""
    kv_rows = k.shape[0]
    k, v = _group_kv(q, k), _group_kv(q, v)
    s, live = _flash_scores(q, k, causal, q_offset)
    acc = s.dtype
    p = torch.where(live, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    dof = do.to(acc)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.to(acc))
    delta = (dof * o.to(acc)).sum(-1, keepdim=True)
    ds = p * (dp - delta) / math.sqrt(q.shape[2])
    dq = torch.einsum("bqk,bkd->bqd", ds, k.to(acc))
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(acc))
    return dq.to(q.dtype), _sum_groups(dk, kv_rows).to(k.dtype), \
        _sum_groups(dv, kv_rows).to(v.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) @ b (K,N) in f32, cast to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def lora_shrink_ref(x: torch.Tensor, a_slab: torch.Tensor, idx: torch.Tensor
                    ) -> torch.Tensor:
    """x (T,d), a_slab (S,d,R), idx (T,) int32 (-1 = no adapter) -> (T,R)
    f32.  Gathers each row's whole adapter matrix; rows with idx < 0 are
    exact zeros."""
    a = a_slab[idx.clamp_min(0).long()].float()                # (T, d, R)
    h = torch.einsum("td,tdr->tr", x.float(), a)
    return torch.where((idx >= 0)[:, None], h, 0.0)


def lora_expand_ref(h: torch.Tensor, b_slab: torch.Tensor, idx: torch.Tensor,
                    out_dtype=None) -> torch.Tensor:
    """h (T,R) f32, b_slab (S,R,O), idx (T,) -> (T,O) in ``out_dtype``
    (default h's), exact zeros where idx < 0."""
    bm = b_slab[idx.clamp_min(0).long()].float()               # (T, R, O)
    y = torch.einsum("tr,tro->to", h.float(), bm)
    y = torch.where((idx >= 0)[:, None], y, 0.0)
    return y.to(out_dtype or h.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor):
    """Sequential selective scan with a batch axis: a, b (B,T,D,N), c
    (B,T,N), h0 (B,D,N) -> (y (B,T,D), h_last (B,D,N)), one step at a time:
    ``h = a_t * h + b_t``, ``y_t = sum_n h * c_t``."""
    h = h0
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append((h * c[:, t, None, :]).sum(-1))
    if not ys:
        return a.new_zeros(a.shape[:3]), h0.clone()
    return torch.stack(ys, dim=1), h


def ssm_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         h0: torch.Tensor, chunk: int):
    """Oracle of ``ops.ssm_scan_chunked``: sequential scans over
    ``chunk``-step slices, each resuming from the previous slice's final
    state (the chunked-prefill carry contract spelled out)."""
    ys, h = [], h0
    for s in range(0, a.shape[1], chunk):
        y, h = ssm_scan_ref(a[:, s:s + chunk], b[:, s:s + chunk],
                            c[:, s:s + chunk], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


# Largest ``row_rel_err`` a kernel may show against its plain version, by the
# output's dtype.  bf16: kernel and plain version each round their f32 result
# once, and where the two f32 values straddle a rounding midpoint they land
# one bf16 step apart, at most 2^-7 of the element and so of its row's
# largest value; 2e-2 leaves 2.5 times that.  f32: reassociation only.
ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Gradients of attention (K3's backward) are held with a floor and their own
# f32 limit.  Rows whose exact gradient is zero (dQ of the first causal
# query row: P is 1 on key 0, so dP equals D) come out of any f32 backward
# as its rounding noise; each row is therefore held to at least 1e-2 of the
# tensor's largest value.  Against that floor the zero rows dominate: at
# qwen3-0.6b's training shape (BH 128, S 512, hd 128, causal), on an NVIDIA
# H100 80GB HBM3, the f32 plain backward and the kernel both sit 7.9e-5
# from the f64 plain backward, both in a first causal row (noise of 8e-7 of
# the tensor's largest value), and 3.7e-5 from each other; dK and dV read
# 3e-6.  So f32 is held to 1e-4, and bf16 keeps the forward's limit.
# ``chip_smoke.py`` measures that witness on every run and holds the kernel
# to twice the f32 plain version's distance from f64.
GRAD_ROW_FLOOR = 1e-2
GRAD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def row_rel_err(got: torch.Tensor, want: torch.Tensor,
                floor: float = 0.0) -> tuple:
    """How far a kernel's output is from its plain version, row by row.

    A row is one vector of the last axis (one head of one query for
    attention, one token for rmsnorm).  Returns ``(max |got - want|, max over
    rows of max|got - want|_row / max|want|_row)``.  Normalising each row by
    its own largest value keeps rows of small outputs (attention over long,
    nearly uniform spans) as tightly held as rows of large ones, so a kernel
    that zeroes or truncates them cannot hide under the largest row.

    ``floor`` > 0 holds each row to at least ``floor`` times the tensor's
    largest value: for gradients, whose rows can be exact zeros that both
    sides compute as rounding noise (dQ of the first causal query row,
    where P is 1 on key 0 and dP equals D there)."""
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1)
    if floor:
        scale = scale.clamp_min(floor * float(want.abs().max()))
    scale = scale.clamp_min(torch.finfo(torch.float32).tiny)
    return float(diff.max()), float((diff / scale).max())
