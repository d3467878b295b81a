"""AdamW with global-norm clipping, a cosine schedule and optional int8
block-quantized moments (mirrors ``src/repro/train/optimizer.py``).

Plain tensor code over the port's parameter trees, not ``torch.optim``: the
state keeps the reference's layout ``{"step", "m", "v"}`` with ``m``/``v``
shaped like the parameters, so it crosses ``repro_torch.bridge`` to the JAX
package and back.  Every update is computed in f32 and cast to the
parameter's dtype and written into the leaf's own storage (the update is
in place).  int8 moments hold 1 B a value plus an f32 scale per 256
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


# a leaf's update runs over slices of at most this many values, so its f32
# temporaries stay bounded: about ten of them at once, 45 GB for the
# 1.25-billion-value embedding of qwen2-vl-72b in one slice, 2.5 GB in
# slices of 64 Mi.  Every op is elementwise (or, for int8 moments,
# block-local, and slices start on block boundaries), so the bits do not
# depend on the slicing
UPDATE_CHUNK = 1 << 26


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
        """(params, state, {"lr", "grad_norm"}), updated in place: each
        leaf's weight, ``m`` and ``v`` (an int8 moment's payload and scales)
        are overwritten in their own storage once the leaf's new values are
        computed, and ``state["step"]`` is advanced, so one train state is
        alive at a time (the reference donates its state to the jitted
        step).  A caller that needs the old tree afterwards clones it first.
        The global norm is taken in f32 over every gradient leaf and
        reported before clipping."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = cosine_lr(cfg, step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in leaves(grads)))
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1 - cfg.b1 ** stepf
        bc2 = 1 - cfg.b2 ** stepf

        def upd_slice(p, g, m, v):
            """The update of one slice of a leaf's values (flat views of
            the weight, f32 moments): the new weight written into ``p``,
            the new moments returned."""
            g = g.to(torch.float32) * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            mh, vh = m / bc1, v / bc2
            pf = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
            return m, v

        def upd(p, g, m_old, v_old):
            flat, gflat = p.view(-1), g.reshape(-1)
            step_ = UPDATE_CHUNK - UPDATE_CHUNK % cfg.quant_block
            for lo in range(0, flat.numel(), step_):
                hi = min(flat.numel(), lo + step_)
                if cfg.state_dtype == "int8":
                    m, v = (_slice_moment(x, lo, hi, cfg.quant_block)
                            for x in (m_old, v_old))
                else:
                    m, v = m_old.view(-1)[lo:hi], v_old.view(-1)[lo:hi]
                m, v = upd_slice(flat[lo:hi], gflat[lo:hi], m, v)
                for old, new in ((m_old, m), (v_old, v)):
                    if cfg.state_dtype == "int8":
                        _store_moment(old, lo, new, cfg.quant_block)
                    else:
                        old.view(-1)[lo:hi] = new

        map_tree(upd, params, grads, state["m"], state["v"])
        state["step"].copy_(step)
        return params, state, {"lr": lr, "grad_norm": gnorm}


def _slice_moment(d: Quantized, lo: int, hi: int, block: int
                  ) -> torch.Tensor:
    """Values ``lo:hi`` of a quantized moment, ``lo`` on a block
    boundary: its blocks dequantized."""
    b0, b1 = lo // block, -(-hi // block)
    return (d.q[b0:b1].to(torch.float32) * d.scale[b0:b1]) \
        .reshape(-1)[:hi - lo]


def _store_moment(d: Quantized, lo: int, x: torch.Tensor, block: int
                  ) -> None:
    """Quantize values ``lo:lo + len(x)`` (``lo`` on a block boundary)
    into the moment's own payload and scales: each block's scale is its own
    values' (the last block zero-padded, as ``quantize`` pads it), so the
    bits equal quantizing the whole leaf."""
    new = quantize(x, block)
    b0 = lo // block
    d.q[b0:b0 + new.q.shape[0]] = new.q
    d.scale[b0:b0 + new.scale.shape[0]] = new.scale
