"""AdamW with global-norm clipping, a cosine schedule and optional int8
block-quantized moments (mirrors ``src/repro/train/optimizer.py``).

Plain tensor code over the port's parameter trees, not ``torch.optim``: the
state keeps the reference's layout ``{"step", "m", "v"}`` with ``m``/``v``
shaped like the parameters, so it crosses ``repro_torch.bridge`` to the JAX
package and back.  Every update is computed in f32 and cast to the
parameter's dtype.  int8 moments hold 1 B a value plus an f32 scale per 256
(~2.03 B a parameter for both moments together instead of 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.train.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # "f32" | "int8": int8 stores m/v block-quantized (block 256, f32 scales)
    state_dtype: str = "f32"
    quant_block: int = 256


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_frac * lr``;
    f32 like the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


# -- int8 block quantization -------------------------------------------------

@dataclasses.dataclass
class Quantized:
    """Block-quantized f32 tensor: int8 payload (blocks, block) and per-block
    f32 scales (blocks, 1), of a tensor of ``shape`` padded by ``pad``."""
    q: Any
    scale: Any
    shape: Tuple[int, ...]
    pad: int


def quantize(x: torch.Tensor, block: int) -> Quantized:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Quantized(q, scale.to(torch.float32), tuple(x.shape), pad)


def dequantize(d: Quantized) -> torch.Tensor:
    flat = (d.q.to(torch.float32) * d.scale).reshape(-1)
    if d.pad:
        flat = flat[:flat.numel() - d.pad]
    return flat.reshape(d.shape)


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        if cfg.state_dtype not in ("f32", "int8"):
            raise ValueError(f"AdamW: state_dtype {cfg.state_dtype!r} is not "
                             "'f32' or 'int8'")
        self.cfg = cfg

    def init(self, params) -> Dict[str, Any]:
        def zero_like(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if self.cfg.state_dtype == "int8":
                return quantize(z, self.cfg.quant_block)
            return z
        device = leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": map_tree(zero_like, params),
                "v": map_tree(zero_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any],
                                                   Dict]:
        """(new params, new state, {"lr", "grad_norm"}); nothing is updated
        in place.  The global norm is taken in f32 over every gradient leaf
        and reported before clipping."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = cosine_lr(cfg, step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in leaves(grads)))
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1 - cfg.b1 ** stepf
        bc2 = 1 - cfg.b2 ** stepf

        def upd(p, g, m, v):
            if cfg.state_dtype == "int8":
                m, v = dequantize(m), dequantize(v)
            g = g.to(torch.float32) * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            mh, vh = m / bc1, v / bc2
            pf = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
            new_p = (pf - lr * delta).to(p.dtype)
            if cfg.state_dtype == "int8":
                m = quantize(m, cfg.quant_block)
                v = quantize(v, cfg.quant_block)
            return new_p, m, v

        out = map_tree(upd, params, grads, state["m"], state["v"])
        return _pick(out, 0), {"step": step, "m": _pick(out, 1),
                               "v": _pick(out, 2)}, \
            {"lr": lr, "grad_norm": gnorm}


def _pick(tree, i):
    """Element ``i`` of every (new_p, m, v) leaf of ``tree`` (a tree of dicts
    and lists, as parameter trees are)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
