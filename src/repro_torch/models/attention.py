"""GQA attention (mirrors ``src/repro/models/attention.py``, single device):
the plain prefill and decode paths the dense oracle uses, and the paged
block-pool paths the serve engine uses.  The paged paths take an optional
per-layer ``lora`` descriptor (``repro_torch.models.lora``) that adds each
row's adapter delta to the q/k/v and output projections.

The paged paths update the KV slabs **in place** (the JAX functions return
new arrays); they still return the slabs so call sites read the same.  They
keep the reference's null-block rule: dead decode rows and padded prefill
positions all write block 0, which is never read unmasked.

On a sharded serve engine (``shard``, the engine's ``ServeShard``; the
reference's ``shard_map`` branches) each rank's pages hold its own
KV/n heads: the rank scatters its kv heads' new K/V into its local pages,
attends its H/n query heads (those grouped under its kv heads, so GQA
never crosses a rank) with the same kernel, and the per-rank outputs are
all-gathered on the heads axis before ``wo``, or stay local for a
row-parallel ``wo`` under REPRO_TP_REDUCE_SCATTER=1 (one all_reduce on its
partial sums instead).  No floating-point sum spans ranks in the
attention, so identity mode is the single device's bit for bit.

A training step on a mesh (``attention_block``'s ``shard``, a
``TrainShard``) computes in the reference's GSPMD layout on "model": q/k/v
column-parallel on the rank's H/n and KV/n heads (its kv heads' groups,
so GQA stays on the rank), the q/k norms' weights behind *f* (each rank
normalises other heads), the flash-attention kernel on the rank's heads
and ``wo`` row-parallel with one ``all_reduce``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.param_sharding import (ServeShard, tp_linear,
                                                    tp_whole)
from repro_torch.distributed.sharding import TrainShard, weight_use
from repro_torch.models import lora as lora_mod
from repro_torch.models.layers import (apply_rope, default_mrope_sections,
                                      rms_norm_pair, truncated_normal)
from repro_torch.perf import perf

# q chunks of this size bound the live score tensor to (B,H,CHUNK,S_kv);
# REPRO_ATTN_CHUNK overrides it where a caller passes this default
Q_CHUNK = 1024
NEG_INF = -1e30


def _paged_impl(device: torch.device) -> str:
    """REPRO_PAGED_ATTN, with "auto" meaning the kernel for CUDA tensors and
    the dense gather for CPU tensors.  "gather" on CUDA is an explicit
    opt-in; "kernel" on CPU runs the kernel wrapper's plain version."""
    mode = perf().paged_attn
    if mode == "auto":
        return "kernel" if device.type == "cuda" else "gather"
    return mode


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd) \
        .reshape(b, s, kv * n_rep, hd)


def _attend_block(q, k, v, mask_add, scale):
    """q (B,Hq,Sq,hd) k/v (B,Hq,Skv,hd) -> (B,Hq,Sq,hd); f32 softmax with an
    additive mask."""
    scores = (q @ k.transpose(-1, -2)).float() * scale
    if mask_add is not None:
        scores = scores + mask_add
    probs = torch.softmax(scores, dim=-1)
    return probs.to(v.dtype) @ v


def _causal_mask_add(qpos, kpos):
    """(Sq,Skv) f32 additive mask: 0 where visible, -1e30 where masked."""
    return torch.where(qpos[:, None] >= kpos[None, :], 0.0, NEG_INF) \
        .to(torch.float32)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, q_offset: int = 0,
                         chunk: int = Q_CHUNK,
                         impl: Optional[str] = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd).

    ``impl`` (the reference's argument): "reference" (the default) is the
    plain path, which the dense oracle keeps; long queries go in chunks so
    the score tensor never exceeds (B, H, chunk, Skv), the chunk taken from
    ``REPRO_ATTN_CHUNK`` when the caller passes the default (as the
    reference does).  "kernel" (the
    reference's "pallas") is ``ops.flash_attention``: the flash-attention
    kernel on CUDA tensors, differentiable through its backward kernel."""
    impl = impl or "reference"
    if impl == "kernel":
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl != "reference":
        raise ValueError(f"multi_head_attention: impl {impl!r} is not "
                         "'reference' or 'kernel'")
    chunk = perf().attn_chunk if chunk == Q_CHUNK else chunk
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    kh = _repeat_kv(k, h // kv).transpose(1, 2)          # (B,H,Skv,hd)
    vh = _repeat_kv(v, h // kv).transpose(1, 2)
    qh = q.transpose(1, 2)                               # (B,H,Sq,hd)
    kpos = torch.arange(skv, device=q.device)

    def block(q_blk, start, n):
        qpos = q_offset + start + torch.arange(n, device=q.device)
        mask = _causal_mask_add(qpos, kpos)[None, None] if causal else None
        return _attend_block(q_blk, kh, vh, mask, scale)

    if sq <= 2 * chunk or sq % chunk != 0:
        out = block(qh, 0, sq)
    else:
        out = torch.cat([block(qh[:, :, i:i + chunk], i, chunk)
                         for i in range(0, sq, chunk)], dim=2)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len) -> torch.Tensor:
    """q (B,1,H,hd); caches (B,Smax,KV,hd); positions >= cur_len are masked.
    ``cur_len`` is an int / 0-d tensor (one length for all rows) or a (B,)
    tensor of per-row lengths."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    kh = _repeat_kv(k_cache, h // kv)
    vh = _repeat_kv(v_cache, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kh).float() * scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    lens = torch.as_tensor(cur_len, device=q.device)
    if lens.dim() == 0:
        mask_add = torch.where(kpos < lens, 0.0, NEG_INF) \
            .to(torch.float32)[None, None, None, :]
    else:
        mask_add = torch.where(kpos[None, :] < lens[:, None], 0.0, NEG_INF) \
            .to(torch.float32)[:, None, None, :]
    probs = torch.softmax(scores + mask_add, dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh)


# ---------------------------------------------------------------------------
# Paged KV: block-pool scatter/gather attention
# ---------------------------------------------------------------------------

def paged_gather(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pages (N,bs,KV,hd), tables (B,M) -> (B, M*bs, KV, hd); position i of
    the gathered axis is token i of the row (null entries gather block 0,
    which the caller's length mask hides)."""
    b, m = tables.shape
    _, bs, kv, hd = pages.shape
    return pages[tables.long()].reshape(b, m * bs, kv, hd)


def paged_scatter_token(pages: torch.Tensor, tables: torch.Tensor,
                        positions: torch.Tensor, values: torch.Tensor
                        ) -> torch.Tensor:
    """Write one token's KV per batch row into the pool, **in place**.
    pages (N,bs,KV,hd); tables (B,M); positions (B,); values (B,KV,hd).
    Dead rows (null table entries) all land on block 0."""
    bs = pages.shape[1]
    m = tables.shape[1]
    positions = positions.long()
    idx = torch.clamp(positions // bs, 0, m - 1)
    blk = torch.gather(tables.long(), 1, idx[:, None])[:, 0]
    pages[blk, positions % bs] = values.to(pages.dtype)
    return pages


def _paged_decode_attend(q, k_pages, v_pages, block_tables, seq_lens,
                         pages_per_fetch=1):
    if _paged_impl(q.device) == "kernel":
        from repro_torch.kernels import ops
        return ops.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens + 1,
                                   pages_per_fetch=pages_per_fetch)
    kg = paged_gather(k_pages, block_tables)
    vg = paged_gather(v_pages, block_tables)
    return decode_attention(q, kg, vg, seq_lens + 1)


def _out_project(p, o: torch.Tensor, lora, shard) -> torch.Tensor:
    """o (B,S,H,hd) -> (B,S,d) through ``wo``.  On a sharded engine ``o``
    holds this rank's heads: gathered first, or consumed in place by a
    row-parallel ``wo`` in reduce-scatter mode (``tp_linear``)."""
    oh = o.flatten(2)
    out, local = tp_linear(oh, p["wo"], shard, x_local=shard is not None)
    return tp_whole(lora_mod.add_delta("o", out, oh, lora), local, shard)


def attention_decode_block_paged(cfg: ModelConfig, p, x: torch.Tensor,
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 pages_per_fetch: int = 1,
                                 lora: Optional[dict] = None, shard=None):
    """One-token attention against a paged cache.  x (B,1,d); pages
    (N,bs,KV,hd) updated in place (KV/n heads on a sharded engine's rank);
    block_tables (B,M); seq_lens (B,) KV entries already written per row
    (the new token lands at seq_lens[b]); ``pages_per_fetch`` is the kernel
    plan's, handed to the kernel; ``lora`` one layer's adapter descriptor
    or None; ``shard`` a sharded engine's ``ServeShard`` or None.  Returns
    (out, k_pages, v_pages)."""
    seq_lens = seq_lens.to(torch.int32)
    q, k, v = qkv_project(cfg, p, x, seq_lens[:, None], lora=lora,
                          shard=shard)
    paged_scatter_token(k_pages, block_tables, seq_lens, k[:, 0])
    paged_scatter_token(v_pages, block_tables, seq_lens, v[:, 0])
    o = _paged_decode_attend(q, k_pages, v_pages, block_tables, seq_lens,
                             pages_per_fetch)
    return _out_project(p, o, lora, shard), k_pages, v_pages


def attention_prefill_chunk_block(cfg: ModelConfig, p, x: torch.Tensor,
                                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                                  block_table: torch.Tensor,
                                  chunk_pos: torch.Tensor,
                                  prompt_len: torch.Tensor,
                                  m_used: Optional[int] = None,
                                  pages_per_fetch: int = 1,
                                  lora: Optional[dict] = None, shard=None):
    """One prompt chunk's attention against the paged cache (batch of 1).
    x (1,C,d); block_table (1,M); chunk_pos (C,) absolute positions;
    positions >= prompt_len are padding whose KV goes to the null block.
    ``m_used`` bounds the attended span to the table's first blocks; ``lora``
    is one layer's adapter descriptor or None; ``shard`` a sharded engine's
    ``ServeShard`` (its rank's KV/n heads in the pages) or None.  Pages are
    updated in place.  Returns (out, k_pages, v_pages)."""
    q, k, v = qkv_project(cfg, p, x, chunk_pos[None, :], lora=lora,
                          shard=shard)
    bs = k_pages.shape[1]
    if m_used is not None:
        block_table = block_table[:, :min(m_used, block_table.shape[1])]
    m = block_table.shape[1]
    pos = chunk_pos.long()
    valid = pos < prompt_len
    idx = torch.clamp(pos // bs, 0, m - 1)
    blk = torch.where(valid, block_table[0].long()[idx], 0)
    off = pos % bs
    k_pages[blk, off] = k[0].to(k_pages.dtype)
    v_pages[blk, off] = v[0].to(v_pages.dtype)
    o = _paged_prefill_attend(cfg, q, k_pages, v_pages, block_table,
                              chunk_pos, pages_per_fetch)
    return _out_project(p, o, lora, shard), k_pages, v_pages


def _paged_prefill_attend(cfg: ModelConfig, q, k_pages, v_pages, block_table,
                          chunk_pos, pages_per_fetch=1):
    if _paged_impl(q.device) == "kernel":
        from repro_torch.kernels import ops
        kv_lens = (chunk_pos[-1:] + 1).to(torch.int32)    # span written so far
        return ops.paged_attention_chunk(q, k_pages, v_pages, block_table,
                                         chunk_pos, kv_lens,
                                         pages_per_fetch=pages_per_fetch)
    m, bs = block_table.shape[1], k_pages.shape[1]
    kg = paged_gather(k_pages, block_table)         # (1, m_used*bs, KV, hd)
    vg = paged_gather(v_pages, block_table)
    h_q, kv = q.shape[2], kg.shape[2]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    kh = _repeat_kv(kg, h_q // kv).transpose(1, 2)            # (1,H,m*bs,hd)
    vh = _repeat_kv(vg, h_q // kv).transpose(1, 2)
    qh = q.transpose(1, 2)                                    # (1,H,C,hd)
    kpos = torch.arange(m * bs, device=q.device)
    mask_add = _causal_mask_add(chunk_pos, kpos)[None, None]
    return _attend_block(qh, kh, vh, mask_add, scale).transpose(1, 2)


# ---------------------------------------------------------------------------
# Projections (+ rope + qk-norm)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen, dtype, device):
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    tn = lambda shape, sc: truncated_normal(gen, shape, sc, dtype, device)  # noqa: E731
    p = {"wq": tn((d, qd), s), "wk": tn((d, kvd), s), "wv": tn((d, kvd), s),
         "wo": tn((qd, d), 1.0 / math.sqrt(qd))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def qkv_project(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor, lora: Optional[dict] = None,
                shard=None):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd) with qk-norm and RoPE
    (M-RoPE at qwen2-vl's sections when ``positions`` holds three streams,
    (3,B,S)).  ``lora`` (serve only) adds each row's adapter delta to the q/k/v
    projections before reshape, qk-norm and RoPE; None runs none of it.
    ``shard`` (a sharded serve engine's) gives this rank's H/n and KV/n
    heads: computed on them where the weights are column-parallel in
    reduce-scatter mode, else computed whole and cut, so they are the
    single device's heads bit for bit.  A training step's ``TrainShard``
    gives the rank's heads from column-parallel weights."""
    hd = cfg.resolved_head_dim
    heads, local = [], []
    for proj in ("q", "k", "v"):
        y, loc = tp_linear(x, p["w" + proj], shard)
        y = lora_mod.add_delta(proj, y, x, lora)
        heads.append(y.unflatten(-1, (-1, hd)))
        local.append(loc)
    q, k, v = heads
    if cfg.qk_norm:
        wqn, wkn = p["q_norm"], p["k_norm"]
        if isinstance(shard, TrainShard):
            # on a training mesh each rank normalises its own heads: the
            # weights' gradients are partial over "model"
            split = local[0] or shard.model_split
            wqn, wkn = (weight_use(w, None, shard=shard, split=split)
                        for w in (wqn, wkn))
        q, k = rms_norm_pair(q, wqn, k, wkn, cfg.norm_eps)
    if cfg.rope != "none":
        sections = default_mrope_sections(hd) if cfg.rope == "mrope" \
            else None
        q = apply_rope(q, positions, cfg.rope_theta, sections)
        k = apply_rope(k, positions, cfg.rope_theta, sections)
    if isinstance(shard, ServeShard):
        q, k, v = (t if loc else t[:, :, shard.part(t.shape[2])]
                   .contiguous() for t, loc in zip((q, k, v), local))
    return q, k, v


def attention_block(cfg: ModelConfig, p, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True,
                    impl: Optional[str] = None, shard=None) -> torch.Tensor:
    """Full-sequence attention with its projections and no cache: x (B,S,d)
    at positions (B,S) -> (B,S,d).  The hybrid's shared block over a whole
    sequence (the JAX package's ``hybrid._segment_fwd``) and each layer of
    ``transformer.lm_loss`` (with ``impl="kernel"``; ``shard`` a training
    step's on a mesh: the rank's heads)."""
    q, k, v = qkv_project(cfg, p, x, positions, shard=shard)
    o = multi_head_attention(q, k, v, causal=causal, impl=impl)
    b, s = x.shape[:2]
    out, local = tp_linear(o.reshape(b, s, -1), p["wo"], shard,
                           x_local=q.shape[2] < cfg.n_heads)
    return tp_whole(out, local, shard)


def attention_decode_block(cfg: ModelConfig, p, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cur_len: int, positions: torch.Tensor):
    """One-token attention against a dense (B,Smax,KV,hd) cache, written in
    place at ``cur_len``; returns (out, k_cache, v_cache)."""
    q, k, v = qkv_project(cfg, p, x, positions)
    k_cache[:, cur_len:cur_len + 1] = k.to(k_cache.dtype)
    v_cache[:, cur_len:cur_len + 1] = v.to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, cur_len + 1)
    out = o.reshape(x.shape[0], 1, cfg.q_dim) @ p["wo"]
    return out, k_cache, v_cache
