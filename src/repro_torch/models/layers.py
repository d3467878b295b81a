"""Shared layer primitives (mirrors ``src/repro/models/layers.py``): rms_norm,
RoPE, MLPs, embeddings, the loss and the init helpers.

Functions are plain PyTorch on tensors; params are plain dicts of tensors.
Initializers draw from an explicit ``torch.Generator``.  M-RoPE is not in
this slice (see ROADMAP.md).  ``apply_mlp`` takes an optional per-layer LoRA
descriptor (``repro_torch.models.lora``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.lora import add_delta
from repro_torch.perf import require_norm_f32


def truncated_normal(gen: torch.Generator, shape, scale, dtype,
                     device) -> torch.Tensor:
    """N(0,1) truncated to [-2, 2], times ``scale``, drawn in f32 and cast
    (the JAX package's ``truncated_normal``; the draws differ, the law is the
    same)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """f32 reduction and scale, result in x's dtype.  CUDA tensors run the
    Triton rmsnorm kernel, CPU tensors its plain version, both through
    ``RMSNormFn`` (``ops.rmsnorm``), which records only when autograd
    does."""
    require_norm_f32()
    return ops.rmsnorm(x, w, eps)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (...,) -> angles (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate-half RoPE.  x (B,S,H,hd), positions (B,S)."""
    if positions.dim() != 2:
        raise NotImplementedError(
            "M-RoPE position streams are not ported yet (ROADMAP: VLM slice)")
    half = x.shape[-1] // 2
    angles = _rope_angles(positions, x.shape[-1], theta)     # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(cfg: ModelConfig, gen, d_ff: int, dtype, device):
    d = cfg.d_model
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    tn = lambda shape, s: truncated_normal(gen, shape, s, dtype, device)  # noqa: E731
    if cfg.act == "swiglu":
        return {"wi_gate": tn((d, d_ff), s_in), "wi_up": tn((d, d_ff), s_in),
                "wo": tn((d_ff, d), s_out)}
    return {"wi": tn((d, d_ff), s_in), "wo": tn((d_ff, d), s_out)}


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor,
              lora: Optional[dict] = None) -> torch.Tensor:
    """The dense FFN; ``lora`` (serve only) adds each row's adapter delta to
    the gate/up (or wi) and down projections."""
    if cfg.act == "swiglu":
        g = add_delta("gate", x @ p["wi_gate"], x, lora)
        u = add_delta("up", x @ p["wi_up"], x, lora)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = add_delta("wi", x @ p["wi"], x, lora)
        if cfg.act == "squared_relu":
            h = torch.square(F.relu(h.float())).to(x.dtype)
        elif cfg.act == "gelu":
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        else:
            raise ValueError(f"unknown activation {cfg.act!r}")
    return add_delta("down", h @ p["wo"], h, lora)


def init_embed(cfg: ModelConfig, gen, dtype, device):
    p = {"embed": truncated_normal(gen, (cfg.vocab, cfg.d_model), 1.0, dtype,
                                   device)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal(gen, (cfg.d_model, cfg.vocab),
                                        1.0 / math.sqrt(cfg.d_model), dtype,
                                        device)
    return p


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.long()]


def logits_from_hidden(cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ p["embed"].T
    return h @ p["unembed"]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean next-token loss; logits (B,S,V) any dtype, labels (B,S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()
