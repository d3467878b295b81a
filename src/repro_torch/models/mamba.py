"""Mamba1 (selective scan) and Mamba2 (SSD) blocks (mirrors
``src/repro/models/mamba.py``).

Mamba1's recurrence and its discretisation (``a = exp(dt * A)``,
``b = dt * B * x``) run in one selective-scan kernel,
``ops.ssm_scan_fused``, from dt, A, B, C and x: on CUDA tensors the CUDA
kernel of ``kernels/csrc/ssm_scan.cu``, which makes a and b in registers
and never writes a (B, S, d_inner, N) tensor; on CPU tensors its plain
version, ``_discretise`` then the sequential scan.  The JAX package
materialises ``a``/``b`` and hands them to its kernel, and computes the
recurrence with an associative scan inside each ``cfg.ssm.chunk``-step
chunk; the kernel walks the steps in order, so its result does not depend
on where the chunks fall, and it agrees with the JAX package to float32
reassociation.  Under autograd (the ssm family's loss) the scan goes
through ``SSMScanFusedFn``: the same forward launch, also writing state
checkpoints, and the fused K7 backward kernels, which give d(dt), dA, dB,
dC, dx and dh0; A = -exp(A_log) and everything around the scan are torch
ops that autograd differentiates.

Mamba2's SSD runs in torch einsums, as the JAX package runs it in
``jnp.einsum`` (it has no kernel of its own); its gated norm over
``d_inner`` goes through ``layers.rms_norm``, the rmsnorm kernel on CUDA.

Decode is the O(1) single-step recurrence on a carried (conv window, ssm
state); states keep the JAX layouts (``h`` (B, d_inner, N) for Mamba1,
(B, H, P, N) for Mamba2; ``conv`` (B, K-1, d_inner)).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rms_norm, truncated_normal


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def _silu(x: torch.Tensor) -> torch.Tensor:
    """silu in f32, result in x's dtype."""
    return F.silu(x.float()).to(x.dtype)


# ===========================================================================
# Mamba1
# ===========================================================================

def init_mamba1(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    d, di, n, k = cfg.d_model, _d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    dtr = _dt_rank(cfg)
    tn = lambda shape, s: truncated_normal(gen, shape, s, dtype, device)  # noqa: E731
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, n + 1, **f32))[None, :].expand(di, n)
    return {
        "in_proj": tn((d, 2 * di), 1.0 / math.sqrt(d)),
        "conv_w": tn((k, di), 1.0 / math.sqrt(k)),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": tn((di, dtr + 2 * n), 1.0 / math.sqrt(di)),
        "dt_proj": tn((dtr, di), 1.0 / math.sqrt(dtr)),
        "dt_bias": torch.full((di,), -4.6, **f32),   # softplus^-1(0.01)
        "A_log": a_log.contiguous(),
        "D": torch.ones((di,), **f32),
        "out_proj": tn((di, d), 1.0 / math.sqrt(di)),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (K,C) -> (B,S,C), taps summed in
    order in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + s, :] * w[j][None, None, :]
    return out + b[None, None, :]


def _selective_scan(p, dt: torch.Tensor, b_ssm: torch.Tensor,
                    c_ssm: torch.Tensor, xs: torch.Tensor, h0: torch.Tensor):
    """dt (B,S,di) f32, B and C (B,S,N), x (B,S,di), h0 (B,di,N) f32 ->
    (y (B,S,di) f32, h_last): the fused selective-scan kernel, one launch
    over all S (the reference's ``cfg.ssm.chunk`` scan granule changes no
    bit of the result)."""
    return ops.ssm_scan_fused(dt, -torch.exp(p["A_log"]), b_ssm, c_ssm, xs,
                              h0)


def _discretise(dt: torch.Tensor, a_log: torch.Tensor, b_ssm: torch.Tensor,
                xs: torch.Tensor):
    """dt (..., di) f32, A_log (di, N), B (..., N), x (..., di) ->
    a = exp(dt * A), b = dt * B * x, both (..., di, N) f32: the first half
    of the fused scan's plain version (``ref.ssm_discretise_ref``).  A
    masked position (dt = 0) gives a = exp(0) = 1 and b = 0 exactly."""
    return ref.ssm_discretise_ref(dt, -torch.exp(a_log), b_ssm, xs)


def _project(cfg: ModelConfig, p, xs: torch.Tensor):
    """Post-conv activations xs (..., di) -> (dt (..., di) f32 after
    softplus, B (..., N), C (..., N))."""
    dtr, n = _dt_rank(cfg), cfg.ssm.d_state
    proj = xs @ p["x_proj"]
    dt_r, b_ssm, c_ssm = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])
    return dt, b_ssm, c_ssm


def _gate_out(p, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """(y + D * x) * silu(z) @ out_proj."""
    y = (y + p["D"] * xs.float()).to(dtype)
    return (y * _silu(z)) @ p["out_proj"]


def _tail_window(x_pre: torch.Tensor, w: int) -> torch.Tensor:
    """Last ``w`` pre-activation conv inputs (left-padded with zeros when
    S < w)."""
    s = x_pre.shape[1]
    if s >= w:
        return x_pre[:, s - w:, :].contiguous()
    return F.pad(x_pre, (0, 0, w - s, 0))


def mamba1_forward(cfg: ModelConfig, p, x: torch.Tensor,
                   h0: torch.Tensor = None) -> Tuple[torch.Tensor, Dict]:
    """x (B,S,d) -> (y (B,S,d), state {"h", "conv"})."""
    bsz = x.shape[0]
    di, n = _d_inner(cfg), cfg.ssm.d_state
    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    xs = _silu(causal_conv1d(xs, p["conv_w"], p["conv_b"]))
    dt, b_ssm, c_ssm = _project(cfg, p, xs)
    if h0 is None:
        h0 = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    y, h_last = _selective_scan(p, dt, b_ssm, c_ssm, xs, h0)
    out = _gate_out(p, y, xs, z, x.dtype)
    return out, {"h": h_last,
                 "conv": _tail_window(xz[..., :di], cfg.ssm.d_conv - 1)}


def mamba1_decode_step(cfg: ModelConfig, p, x: torch.Tensor, state: Dict):
    """x (B,1,d); state {"h" (B,di,N) f32, "conv" (B,K-1,di)}.  The one-step
    recurrence is the selective-scan kernel at T = 1."""
    di = _d_inner(cfg)
    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]                         # (B,1,di)
    window = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)  # (B,K,di)
    conv = torch.einsum("bki,ki->bi", window, p["conv_w"]) + p["conv_b"]
    xs1 = _silu(conv)                                          # (B,di)
    dt, b_ssm, c_ssm = _project(cfg, p, xs1)
    y, h = _selective_scan(p, dt[:, None], b_ssm[:, None], c_ssm[:, None],
                           xs1[:, None], state["h"].float())
    out = _gate_out(p, y[:, 0], xs1, z[:, 0], x.dtype)[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :]}


def _conv_with_carry(xs: torch.Tensor, carry: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """Depthwise causal conv of one chunk continuing a longer sequence.
    ``carry`` (B,K-1,C) holds the previous chunk's last K-1 pre-activation
    conv inputs (zeros on the first chunk, as the from-scratch conv's left
    pad).  Returns the chunk's conv outputs and the extended input."""
    k = w.shape[0]
    ext = torch.cat([carry.to(xs.dtype), xs], dim=1)   # (B, K-1+C, C)
    return causal_conv1d(ext, w, b)[:, k - 1:], ext


def _next_conv_carry(ext: torch.Tensor, valid_len: int, k: int
                     ) -> torch.Tensor:
    """The carry window after a chunk whose first ``valid_len`` positions
    are real: the K-1 extended entries ending at the last real token, which
    start at index ``valid_len`` (the old carry when ``valid_len`` is 0)."""
    return ext[:, valid_len:valid_len + k - 1, :].contiguous()


def _pad_mask(dt: torch.Tensor, valid_len: int) -> torch.Tensor:
    """dt (B,C,·) with the chunk's positions >= valid_len set to 0."""
    pos = torch.arange(dt.shape[1], device=dt.device)
    return torch.where((pos < valid_len)[None, :, None], dt, 0.0)


def mamba1_chunk(cfg: ModelConfig, p, x: torch.Tensor, state: Dict,
                 valid_len: int):
    """One prompt chunk continuing from carried state (chunked prefill).

    x (B,C,d); state as in ``mamba1_decode_step``; positions >= valid_len
    are padding, masked to identity scan steps (dt -> 0 gives a = exp(0) =
    1 and b = 0), so ``h_last`` is the state after the last real token and
    the padded outputs are discarded by the caller."""
    di, k = _d_inner(cfg), cfg.ssm.d_conv
    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    conv, ext = _conv_with_carry(xs, state["conv"], p["conv_w"], p["conv_b"])
    xs = _silu(conv)
    dt, b_ssm, c_ssm = _project(cfg, p, xs)
    dt = _pad_mask(dt, valid_len)
    y, h_last = _selective_scan(p, dt, b_ssm, c_ssm, xs, state["h"].float())
    out = _gate_out(p, y, xs, z, x.dtype)
    return out, {"h": h_last, "conv": _next_conv_carry(ext, valid_len, k)}


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def _ssd_heads(cfg: ModelConfig) -> int:
    return _d_inner(cfg) // cfg.ssm.head_dim


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    d, di, n = cfg.d_model, _d_inner(cfg), cfg.ssm.d_state
    h, k = _ssd_heads(cfg), cfg.ssm.d_conv
    tn = lambda shape, s: truncated_normal(gen, shape, s, dtype, device)  # noqa: E731
    f32 = dict(dtype=torch.float32, device=device)
    s = 1.0 / math.sqrt(d)
    return {
        "in_proj_zx": tn((d, 2 * di), s),
        "in_proj_bcdt": tn((d, 2 * n + h), s),
        "conv_w": tn((k, di), 1.0 / math.sqrt(k)),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((h,), **f32),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": tn((di, d), 1.0 / math.sqrt(di)),
    }


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """la (..., cs) log-decay per step -> L (..., cs, cs) with
    L[i,j] = sum_{j<k<=i} la_k for i >= j, -inf otherwise."""
    cs = la.shape[-1]
    cum = torch.cumsum(la, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=la.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: torch.Tensor = None):
    """Chunked SSD (Mamba2).  x (B,S,H,P), dt (B,S,H) f32 (post-softplus),
    A (H,) f32 negative, B/C (B,S,N) -> (y (B,S,H,P) f32, h_last
    (B,H,P,N))."""
    bsz, s, hh, pp = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # dt = 0 pad steps: decay exp(0) = 1 and zero input keep the state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xf = x.float().reshape(bsz, nc, chunk, hh, pp)
    dtc = dt.reshape(bsz, nc, chunk, hh)
    bc = B.float().reshape(bsz, nc, chunk, n)
    cc = C.float().reshape(bsz, nc, chunk, n)
    la_h = (dtc * A).transpose(2, 3)                      # (B,nc,H,cs)
    lmat = torch.exp(_segsum(la_h))                       # (B,nc,H,cs,cs)

    # intra-chunk (quadratic within the chunk)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)      # (B,nc,cs,cs)
    w = scores[:, :, None] * lmat                         # (B,nc,H,cs,cs)
    xw = xf * dtc[..., None]                              # dt-weighted inputs
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xw)

    # chunk states: S_c = sum_j exp(la_last - cum_j) dt_j B_j x_j
    cum = torch.cumsum(la_h, dim=-1)                      # (B,nc,H,cs)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    sc = torch.einsum("bchj,bcjn,bcjhp->bchpn", decay_to_end, bc, xw)

    # inter-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(cum[..., -1])                 # (B,nc,H)
    h = h0 if h0 is not None else torch.zeros(
        (bsz, hh, pp, n), dtype=torch.float32, device=x.device)
    h_in = []
    for i in range(nc):
        h_in.append(h)
        h = chunk_decay[:, i, :, None, None] * h + sc[:, i]
    h_in = torch.stack(h_in, dim=1)                       # (B,nc,H,P,N)

    # inter-chunk contribution: y[i] = (C_i . h_in) * exp(cum_i)
    y_inter = torch.einsum("bcin,bchpn,bchi->bcihp", cc, h_in, torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, s + pad, hh, pp)[:, :s]
    return y, h


def _mamba2_out(cfg: ModelConfig, p, y: torch.Tensor, xh: torch.Tensor,
                z: torch.Tensor, dtype) -> torch.Tensor:
    """(y + D * x), the gated norm over d_inner, and out_proj."""
    di = _d_inner(cfg)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(*y.shape[:-2], di).to(dtype)
    y = rms_norm(y * _silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def _split_bcdt(cfg: ModelConfig, bcdt: torch.Tensor):
    n = cfg.ssm.d_state
    return torch.split(bcdt, [n, n, _ssd_heads(cfg)], dim=-1)


def mamba2_forward(cfg: ModelConfig, p, x: torch.Tensor, h0=None):
    """x (B,S,d) -> (y (B,S,d), state {"h" (B,H,P,N), "conv"})."""
    bsz, s, _ = x.shape
    di = _d_inner(cfg)
    hh, pp = _ssd_heads(cfg), cfg.ssm.head_dim
    zx = x @ p["in_proj_zx"]
    b_ssm, c_ssm, dt = _split_bcdt(cfg, x @ p["in_proj_bcdt"])
    z, xs = zx[..., :di], zx[..., di:]
    xs = _silu(causal_conv1d(xs, p["conv_w"], p["conv_b"]))
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B,S,H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(bsz, s, hh, pp)
    y, h_last = ssd_forward(xh, dt, A, b_ssm, c_ssm, cfg.ssm.chunk, h0)
    out = _mamba2_out(cfg, p, y, xh, z, x.dtype)
    return out, {"h": h_last,
                 "conv": _tail_window(zx[..., di:], cfg.ssm.d_conv - 1)}


def mamba2_decode_step(cfg: ModelConfig, p, x: torch.Tensor, state: Dict):
    """x (B,1,d); state {"h" (B,H,P,N) f32, "conv" (B,K-1,di)}."""
    bsz = x.shape[0]
    di = _d_inner(cfg)
    hh, pp = _ssd_heads(cfg), cfg.ssm.head_dim
    zx = (x @ p["in_proj_zx"])[:, 0]
    b_ssm, c_ssm, dt = _split_bcdt(cfg, (x @ p["in_proj_bcdt"])[:, 0])
    z, xs = zx[..., :di], zx[..., di:]
    window = torch.cat([state["conv"].to(xs.dtype), xs[:, None, :]], dim=1)
    conv = torch.einsum("bki,ki->bi", window, p["conv_w"]) + p["conv_b"]
    xs1 = F.silu(conv.float())                            # (B,di) f32
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))            # (B,H)
    xh = xs1.reshape(bsz, hh, pp)
    binc = torch.einsum("bh,bn,bhp->bhpn", dt, b_ssm.float(), xh)
    h = a[..., None, None] * state["h"].float() + binc
    y = torch.einsum("bhpn,bn->bhp", h, c_ssm.float())
    out = _mamba2_out(cfg, p, y, xh, z, x.dtype)[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :]}


def mamba2_chunk(cfg: ModelConfig, p, x: torch.Tensor, state: Dict,
                 valid_len: int):
    """One prompt chunk continuing from carried state (chunked prefill).
    Padded tail positions are masked via dt -> 0 (SSD's own pad rule), so
    ``h_last`` is the state after the last real token.  The conv carry is
    the last K-1 pre-activation inputs (``zx[..., di:]``: Mamba2 splits z
    first)."""
    bsz, c, _ = x.shape
    di, k = _d_inner(cfg), cfg.ssm.d_conv
    hh, pp = _ssd_heads(cfg), cfg.ssm.head_dim
    zx = x @ p["in_proj_zx"]
    b_ssm, c_ssm, dt = _split_bcdt(cfg, x @ p["in_proj_bcdt"])
    z, xs = zx[..., :di], zx[..., di:]
    conv, ext = _conv_with_carry(xs, state["conv"], p["conv_w"], p["conv_b"])
    xs = _silu(conv)
    dt = _pad_mask(F.softplus(dt.float() + p["dt_bias"]), valid_len)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(bsz, c, hh, pp)
    y, h_last = ssd_forward(xh, dt, A, b_ssm, c_ssm, cfg.ssm.chunk,
                            state["h"].float())
    out = _mamba2_out(cfg, p, y, xh, z, x.dtype)
    return out, {"h": h_last, "conv": _next_conv_carry(ext, valid_len, k)}
