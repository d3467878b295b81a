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


# csrc/paged_attention.cu's split length (key positions a split-KV block)
PAGED_SPLIT = 512


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor, q_pos: torch.Tensor,
                              kv_lens: torch.Tensor, split: int = PAGED_SPLIT,
                              drop=None) -> torch.Tensor:
    """The split-KV kernel's algorithm in plain PyTorch (the tests hold it
    against the Pallas kernel): the span cut at fixed multiples of
    ``split``, each slice's (m, l, acc) in f32 with p rounded to v's dtype
    in acc, the slices merged in order (weights exp(m_j - max m)), l
    floored at 1e-30 -> (B,KV,R,hd) f32.  A slice that a row cannot see
    enters with weight exactly 0.  ``drop``: one slice left out (the
    planted fault of ``chip_smoke.py``)."""
    b, kv, r, hd = q.shape
    bs = k_pages.shape[1]
    m = block_tables.shape[1]
    tables = block_tables.long()
    kg = k_pages[tables].reshape(b, m * bs, kv, hd).float()
    vg = v_pages[tables].reshape(b, m * bs, kv, hd).to(v_pages.dtype)
    s = torch.einsum("bkrd,bskd->bkrs", q.float(), kg) / math.sqrt(hd)
    kpos = torch.arange(m * bs, device=q.device)[None, None, None, :]
    live = (kpos <= q_pos[:, None, :, None]) & \
           (kpos < kv_lens[:, None, None, None])
    x = torch.where(live, s, NEG_INF)
    parts = []
    for j, lo in enumerate(range(0, m * bs, split)):
        if j == drop:
            continue
        xj = x[..., lo:lo + split]
        mj = xj.amax(-1)
        pj = torch.exp(xj - mj[..., None])
        acc = torch.einsum("bkrs,bskd->bkrd", pj.to(vg.dtype).float(),
                           vg[:, lo:lo + split].float())
        parts.append((mj, pj.sum(-1), acc))
    mm = torch.stack([mj for mj, _, _ in parts]).amax(0)
    acc = torch.zeros_like(parts[0][2])
    ll = torch.zeros_like(mm)
    for mj, lj, aj in parts:
        w = torch.exp(mj - mm)
        acc = acc + w[..., None] * aj
        ll = ll + w * lj
    return acc / ll.clamp_min(1e-30)[..., None]


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


def matmul_split_k_ref(a: torch.Tensor, b: torch.Tensor, splits: int,
                       drop=None) -> torch.Tensor:
    """Split-K in plain PyTorch, the matmul kernel's reduction (the tests
    hold it against the Pallas kernel): K cut into ``splits`` slices of
    equal length, each slice's f32 partial product, the partials summed in
    slice order and cast to a's dtype.  ``drop``: one slice left out (the
    planted fault of ``chip_smoke.py``)."""
    k = a.shape[1]
    per = max(1, -(-k // splits))
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                        device=a.device)
    for j, lo in enumerate(range(0, k, per)):
        if j != drop:
            total = total + a[:, lo:lo + per].float() @ b[lo:lo + per].float()
    return total.to(a.dtype)


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


def lora_delta_ref(x: torch.Tensor, a_slab: torch.Tensor,
                   b_slab: torch.Tensor, idx: torch.Tensor,
                   base: torch.Tensor = None, drop_slice=None,
                   slices: int = 8) -> torch.Tensor:
    """The fused LoRA delta: ``lora_expand_ref(lora_shrink_ref(x))`` in x's
    dtype (per-row idx), plus ``base`` when given, added as PyTorch adds
    two tensors of that dtype.  ``drop_slice``: d cut into ``slices`` slices
    of equal length (the fused kernel's cluster) and that one left out of
    the shrink, the planted fault of ``chip_smoke.py``."""
    if drop_slice is not None:
        per = -(-x.shape[1] // slices)
        x = x.clone()
        x[:, drop_slice * per:(drop_slice + 1) * per] = 0
    y = lora_expand_ref(lora_shrink_ref(x, a_slab, idx), b_slab, idx,
                        x.dtype)
    return y if base is None else base + y


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                f32: bool = True) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in x's dtype.
    ``f32``: the reduction and the scale in f32 (REPRO_NORM_F32=1, the
    default).  Off, they run in x's dtype (``_rmsnorm_narrow``); for an f32
    x the two are one computation."""
    if not f32 and x.dtype != torch.float32:
        return _rmsnorm_narrow(x, w, eps)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _narrow_rstd(x: torch.Tensor, eps: float) -> torch.Tensor:
    """rsqrt(mean(x^2) + eps) of each row as the reference computes it in
    x's dtype, returned in f32 (its values are x's dtype's).

    What XLA makes of the reference's ``rms_norm`` under REPRO_NORM_F32=0
    on the CPU (its compiled HLO): the square stays an f32 product (exact
    for bf16 operands; XLA drops the round trip through bf16 before the
    f32 sum), the sum is f32, the mean is that sum times the f32 reciprocal
    of D rounded once to x's dtype, then ``+ eps`` (eps in x's dtype) and
    the rsqrt are each computed in f32 and rounded.  Every op here is an
    f32 op and a rounding, never a bf16 op of PyTorch's: its CPU rsqrt of a
    small bf16 tensor rounds the square root before the division."""
    dt = x.dtype
    var = (x.float().square().sum(dim=-1, keepdim=True)
           * (1.0 / x.shape[-1])).to(dt).float()
    eps_dt = torch.tensor(eps, dtype=dt).item()
    return torch.rsqrt((var + eps_dt).to(dt).float()).to(dt).float()


def _rmsnorm_narrow(x: torch.Tensor, w: torch.Tensor, eps: float
                    ) -> torch.Tensor:
    """``rmsnorm_ref`` with the reduction and the scale in x's dtype: the
    reference's ``rms_norm`` under REPRO_NORM_F32=0 (bitwise at bf16 on the
    CPU, ``tests/test_torch_serve.py``).  Each product is rounded to x's
    dtype, and w is cast to it first."""
    dt = x.dtype
    xh = (x.float() * _narrow_rstd(x, eps)).to(dt).float()
    return (xh * w.to(dt).float()).to(dt)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5, mean_term: bool = True,
                    drop_rows=None, f32: bool = True):
    """Gradients of ``rmsnorm_ref(x, w, eps, f32)`` for the output gradient
    g (R, D): ``dx = rstd (g w - x_hat mean(g w x_hat))`` and ``dw =
    sum_rows g x_hat``, with ``x_hat = x rstd``; in f32 and cast, or (``f32``
    off, x not f32) each product and difference rounded to x's dtype, the
    sums in f32.  The planted faults of ``chip_smoke.py``:
    ``mean_term=False`` drops dx's mean term; ``drop_rows=(start, stop)``
    leaves those rows out of dw (one row block of the kernel's column
    sum)."""
    if f32 or x.dtype == torch.float32:
        xf = x.float()
        rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        xhat = xf * rstd
        gw = g.float() * w.float()
        if mean_term:
            gw = gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True)
        dx = rstd * gw
        gx = g.float() * xhat
    else:
        dt = x.dtype

        def rd(t):
            return t.to(dt).float()
        rstd = _narrow_rstd(x, eps)
        gf = g.float()
        xhat = rd(x.float() * rstd)
        gw = rd(gf * w.to(dt).float())
        if mean_term:
            mean = rd((gw * xhat).sum(dim=-1, keepdim=True)
                      * (1.0 / x.shape[-1]))
            gw = rd(gw - rd(xhat * mean))
        dx = rstd * gw
        gx = rd(gf * xhat)
    if drop_rows is not None:
        gx[drop_rows[0]:drop_rows[1]] = 0
    return dx.to(x.dtype), gx.sum(dim=0).to(w.dtype)


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


def ssm_scan_ckpt_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      h0: torch.Tensor, window: int):
    """``ssm_scan_ref``'s (y, h_last) and the states before steps 0,
    ``window``, 2 ``window``, ... stacked on axis 1 (B, ceil(T/window), D,
    N): the forward's checkpoints, from the same steps."""
    h, ys, ckpt = h0, [], []
    for t in range(a.shape[1]):
        if t % window == 0:
            ckpt.append(h)
        h = a[:, t] * h + b[:, t]
        ys.append((h * c[:, t, None, :]).sum(-1))
    if not ys:
        return a.new_zeros(a.shape[:3]), h0.clone(), a.new_zeros(
            (a.shape[0], 0) + tuple(h0.shape[1:]))
    return torch.stack(ys, dim=1), h, torch.stack(ckpt, dim=1)


def ssm_scan_bwd_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     h0: torch.Tensor, dy: torch.Tensor,
                     dh_last: torch.Tensor = None, prev_state: bool = True,
                     drop_d=None):
    """Gradients of ``ssm_scan_ref`` for dy (B,T,D) and dh_last (B,D,N) (None
    for zero) -> (da, db (B,T,D,N), dc (B,T,N), dh0 (B,D,N)), walking the
    steps backwards with ``g = dy_t c_t + a_{t+1} g_{t+1}`` (the carry starts
    at dh_last): ``da_t = g h_{t-1}``, ``db_t = g``, ``dc_t = sum_d dy_t
    h_t``, ``dh0 = a_0 g_0``, each product and sum rounded in the order of
    ``csrc/ssm_scan.cu`` (dc's sum over d excepted).  The planted faults of
    ``chip_smoke.py``: ``prev_state=False`` takes h_t in place of h_{t-1}
    in da; ``drop_d=(start, stop)`` leaves those d out of dc (one block's
    partial of the kernel's column sum)."""
    hs, h = [h0], h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    carry = torch.zeros_like(h0) if dh_last is None else dh_last
    da, db = torch.empty_like(a), torch.empty_like(b)
    dc = a.new_empty(c.shape)
    for t in reversed(range(a.shape[1])):
        g = dy[:, t, :, None] * c[:, t, None, :] + carry
        da[:, t] = g * hs[t if prev_state else t + 1]
        db[:, t] = g
        carry = a[:, t] * g
        p = dy[:, t, :, None] * hs[t + 1]
        if drop_d is not None:
            p[:, drop_d[0]:drop_d[1]] = 0
        dc[:, t] = p.sum(1)
    return da, db, dc, carry.clone() if carry is dh_last else carry



def ssm_discretise_ref(dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                       x: torch.Tensor):
    """Mamba1's discretisation: dt (..., D) f32, A (D, N) f32, B (..., N) and
    x (..., D) in the model's dtype -> a = exp(dt A), b = (dt B) x, both
    (..., D, N) f32, each product rounded in that order.  A masked position
    (dt = 0) gives a = 1 and b = 0 exactly."""
    a = torch.exp(dt[..., None] * A)
    b = dt[..., None] * Bm.float()[..., None, :] * x.float()[..., None]
    return a, b


def ssm_scan_fused_ref(dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                       C: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """The fused scan's plain version: ``ssm_discretise_ref`` then
    ``ssm_scan_ref`` with c = C in f32 -> (y (B,T,D), h_last (B,D,N))."""
    a, b = ssm_discretise_ref(dt, A, Bm, x)
    return ssm_scan_ref(a, b, C.float(), h0)


def ssm_discretise_bwd_ref(da: torch.Tensor, db: torch.Tensor,
                           a: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                           Bm: torch.Tensor, x: torch.Tensor, drop_n=None,
                           drop_b=None, drop_d=None):
    """The discretisation's chain rule: from the scan's da, db (B,T,D,N) and
    a = exp(dt A) -> (d(dt) (B,T,D) f32, dA (D,N) f32, dB (B,T,N) and dx
    (B,T,D) in their inputs' dtypes), each product rounded as
    ``csrc/ssm_scan.cu`` rounds it (its sums over n, d and (b, t) in
    another order): u = da a, v = db x, d(dt) = sum_n (u A + v B), dx =
    sum_n db (dt B), dB = sum_d v dt, dA = sum_{b,t} u dt.  The planted
    faults of ``chip_smoke.py``: ``drop_n`` leaves that lane (state index)
    out of d(dt); ``drop_b`` leaves that batch row out of dA (one row of the
    kernel's (B, D, N) partial); ``drop_d=(start, stop)`` leaves those d out
    of dB (one block's partial)."""
    bf, dtn = Bm.float()[..., None, :], dt[..., None]
    u = da * a
    v = db * x.float()[..., None]
    pdt = u * A + v * bf
    if drop_n is not None:
        pdt[..., drop_n] = 0
    ddt = pdt.sum(-1)
    del pdt
    dx = (db * (dtn * bf)).sum(-1)
    pb = v * dtn
    del v
    if drop_d is not None:
        pb[:, :, drop_d[0]:drop_d[1]] = 0
    dB = pb.sum(2)
    del pb
    pa = u * dtn
    del u
    if drop_b is not None:
        pa[drop_b] = 0
    dA = pa.sum((0, 1))
    return ddt, dA, dB.to(Bm.dtype), dx.to(x.dtype)


def ssm_scan_fused_bwd_ref(dt: torch.Tensor, A: torch.Tensor,
                           Bm: torch.Tensor, C: torch.Tensor,
                           x: torch.Tensor, h0: torch.Tensor,
                           dy: torch.Tensor, dh_last: torch.Tensor = None,
                           **faults):
    """Gradients of ``ssm_scan_fused_ref`` for dy (B,T,D) and dh_last (B,D,N)
    (None for zero) -> (d(dt) (B,T,D) f32, dA (D,N) f32, dB and dC (B,T,N)
    and dx (B,T,D) in their inputs' dtypes, dh0 (B,D,N) f32):
    ``ssm_scan_bwd_ref`` for da, db, dc and dh0, then
    ``ssm_discretise_bwd_ref`` (which takes the planted ``faults``)."""
    a, b = ssm_discretise_ref(dt, A, Bm, x)
    da, db, dc, dh0 = ssm_scan_bwd_ref(a, b, C.float(), h0, dy, dh_last)
    del b
    ddt, dA, dB, dx = ssm_discretise_bwd_ref(da, db, a, dt, A, Bm, x,
                                             **faults)
    return ddt, dA, dB, dc.to(C.dtype), dx, dh0


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
