"""Shared layer primitives (mirrors ``src/repro/models/layers.py``): rms_norm,
RoPE and M-RoPE, sinusoidal positions, MLPs, embeddings, the loss and the
init helpers.

Functions are plain PyTorch on tensors; params are plain dicts of tensors.
Initializers draw from an explicit ``torch.Generator``.  ``apply_mlp``
takes an optional per-layer LoRA descriptor (``repro_torch.models.lora``).
Every weight use goes through ``tp_linear`` / ``tp_embed``
(``repro_torch.distributed.param_sharding``), which take the sharded serve
engine's ``shard`` (its ``ServeShard``) or a training step's on a mesh (a
``TrainShard``); without one they are the plain ``x @ w`` and
``table[ids]``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.param_sharding import (tp_embed, tp_linear,
                                                    tp_whole)
from repro_torch.kernels import ops
from repro_torch.models.lora import add_delta
from repro_torch.perf import norm_f32


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
    """Result in x's dtype; the reduction and scale in f32, or in x's dtype
    under REPRO_NORM_F32=0, as the reference's.  CUDA tensors run the CUDA
    rmsnorm kernel, CPU tensors its plain version (``ops.rmsnorm``, through
    ``RMSNormFn`` when autograd records)."""
    return ops.rmsnorm(x, w, eps, norm_f32())


def rms_norm_pair(x1: torch.Tensor, w1: torch.Tensor, x2: torch.Tensor,
                  w2: torch.Tensor, eps: float = 1e-5):
    """``rms_norm(x1, w1, eps), rms_norm(x2, w2, eps)`` over one last axis,
    bit for bit, in one kernel launch (``ops.rmsnorm_pair``): a layer's q and
    k norms."""
    return ops.rmsnorm_pair(x1, w1, x2, w2, eps, norm_f32())


def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (...,) -> angles (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """Rotate-half RoPE.  x (B,S,H,hd); positions (B,S), or (3,B,S) for
    M-RoPE (qwen2-vl's temporal / height / width streams): the half head
    dim is cut into ``mrope_sections`` and each section takes its angles
    from its own stream.  (B,S) positions give plain RoPE whatever the
    sections."""
    half = x.shape[-1] // 2
    angles = _rope_angles(positions, x.shape[-1], theta)
    if positions.dim() == 3:
        if mrope_sections is None or len(mrope_sections) != 3 \
                or sum(mrope_sections) != half:
            raise ValueError(f"apply_rope: three position streams need three "
                             f"sections summing to {half}, got "
                             f"{mrope_sections}")
        # angles (3, B, S, half) -> (B, S, half), section i from stream i
        angles = torch.cat([a[..., lo:lo + n] for a, lo, n in zip(
            angles, (0, mrope_sections[0], half - mrope_sections[2]),
            mrope_sections)], dim=-1)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def default_mrope_sections(head_dim: int) -> tuple:
    """qwen2-vl's (t, h, w) sections of the half head dim: (16, 24, 24) of
    64 at head_dim 128, the same proportions at other widths."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) f32 table: sin of position x frequency in the first half,
    cos in the second (the encoder-decoder's absolute positions)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim)
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_mlp(cfg: ModelConfig, gen, d_ff: int, dtype, device):
    d = cfg.d_model
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    tn = lambda shape, s: truncated_normal(gen, shape, s, dtype, device)  # noqa: E731
    if cfg.act == "swiglu":
        return {"wi_gate": tn((d, d_ff), s_in), "wi_up": tn((d, d_ff), s_in),
                "wo": tn((d_ff, d), s_out)}
    return {"wi": tn((d, d_ff), s_in), "wo": tn((d_ff, d), s_out)}


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor,
              lora: Optional[dict] = None, shard=None) -> torch.Tensor:
    """The dense FFN; ``lora`` (serve only) adds each row's adapter delta to
    the gate/up (or wi) and down projections; ``shard`` (a sharded serve
    engine's, never with ``lora``) runs it over tensor-parallel weights:
    the in-projections' outputs stay this rank's ff slice where their
    weights are column-parallel, and the down projection's row-parallel
    partial sums meet in one all_reduce (``tp_linear``).  A training
    step's shard computes the same layout differentiably; in its
    sequence-parallel region (``TrainShard.seq_region``) the weights are
    gathered whole and the hidden stays the rank's sequence slice."""
    if cfg.act == "swiglu":
        # one rule (mlp_in) lays out both, so both are local or neither
        g, local = tp_linear(x, p["wi_gate"], shard)
        g = add_delta("gate", g, x, lora)
        u = add_delta("up", tp_linear(x, p["wi_up"], shard)[0], x, lora)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h, local = tp_linear(x, p["wi"], shard)
        h = add_delta("wi", h, x, lora)
        if cfg.act == "squared_relu":
            h = torch.square(F.relu(h.float())).to(x.dtype)
        elif cfg.act == "gelu":
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        else:
            raise ValueError(f"unknown activation {cfg.act!r}")
    y, y_local = tp_linear(h, p["wo"], shard, x_local=local)
    return tp_whole(add_delta("down", y, h, lora), y_local, shard)


def init_embed(cfg: ModelConfig, gen, dtype, device):
    p = {"embed": truncated_normal(gen, (cfg.vocab, cfg.d_model), 1.0, dtype,
                                   device)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal(gen, (cfg.d_model, cfg.vocab),
                                        1.0 / math.sqrt(cfg.d_model), dtype,
                                        device)
    return p


def embed_tokens(p, tokens: torch.Tensor, shard=None) -> torch.Tensor:
    return tp_embed(p["embed"], tokens, shard)


def logits_from_hidden(cfg: ModelConfig, p, h: torch.Tensor,
                       shard=None) -> torch.Tensor:
    w = p["embed"] if cfg.tie_embeddings else p["unembed"]
    return tp_whole(*tp_linear(h, w, shard, transpose=cfg.tie_embeddings),
                    shard)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean next-token loss; logits (B,S,V) any dtype, labels (B,S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()
