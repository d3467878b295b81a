"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch (mirrors
``src/repro/models/moe.py``).

Tokens are scattered into a per-sequence (E, C, d) buffer (dest index =
expert*C + rank-within-expert), the experts run as batched products over
expert-stacked weights (``torch.bmm``: the reference leaves these einsums
to XLA, so they have no hand-written kernel), and the results are gathered
back and scaled by the router gate.  Ranks are cumulative sums *within each
sequence*; capacity is per top-k slot, each slot dispatching on its own.
Tokens past an expert's capacity go to one extra row, E*C, which is cut
off, so they get no expert output.

The router runs in f32 whatever the model's dtype (its weight is stored
f32), the SiLU in f32 cast back, and the routed output accumulates in the
activation dtype in top-k order, as in the reference.

Decode (S = 1) gathers each token's selected experts' weights
(``apply_moe_decode``, REPRO_MOE_DECODE=gather) or dispatches all decode
tokens of the batch as one group with a capacity
(``apply_moe_decode_dispatch``, =dispatch).

On a sharded serve engine each entry point takes its ``shard``
(``param_sharding.ServeShard``).  The router is replicated, so every rank
routes every token alike; the expert stacks are sharded inside each expert
as the reference's ``moe_expert_in`` / ``_out`` rules say: ``wi_gate`` and
``wi_up`` column-parallel on ``d_ff_expert``, ``wo`` row-parallel.  In
identity mode a rank gathers what it uses (a whole stack for a dispatch,
only the selected experts' rows at a gather decode: the same bits as
indexing the gathered stack), so the arithmetic is one device's; in
reduce-scatter mode each rank computes its ``d_ff_expert`` slice and the
down projection's partial sums meet in one ``ServeMesh.reduce``, where
``tp_linear`` puts it for a dense MLP.  The shared expert goes through
``apply_mlp``.  There is no expert parallelism.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.param_sharding import TPWeight, tp_use
from repro_torch.models.layers import apply_mlp, init_mlp, truncated_normal


def _expert_stack(gen, shape, scale, dtype, device) -> torch.Tensor:
    """An (E, ...) stack of ``truncated_normal`` draws made one expert at a
    time, so no f32 temporary of the whole stack exists (a full-width
    stack is up to 10.7 GB in bf16)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = truncated_normal(gen, shape[1:], scale, dtype, device)
    return out


def init_moe(cfg: ModelConfig, gen, dtype, device):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": truncated_normal(gen, (d, e), s_in, torch.float32, device),
        "wi_gate": _expert_stack(gen, (e, d, f), s_in, dtype, device),
        "wi_up": _expert_stack(gen, (e, d, f), s_in, dtype, device),
        "wo": _expert_stack(gen, (e, f, d), s_out, dtype, device),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, m.n_shared_experts * f, dtype,
                               device)
    return p


def _select(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The k most probable experts of each token, best first (the one step
    of ``_route`` that picks; ``chip_smoke.RouteLog`` records it)."""
    return torch.topk(probs, k, dim=-1, sorted=True).indices


def _route(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B,S,d) -> (gates (B,S,k) f32, idx (B,S,k) int64, aux_loss f32
    scalar)."""
    m = cfg.moe
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    idx = _select(probs, m.top_k)
    gates = probs.gather(-1, idx)
    if m.top_k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    # load-balance auxiliary loss (Switch): E * sum_e(frac_e * prob_e), the
    # fraction taken from each token's first choice
    assign = F.one_hot(idx[..., 0], m.n_experts).float()
    frac = assign.mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = m.n_experts * (frac * mean_prob).sum()
    return gates, idx, aux


def _dispatch_one(x: torch.Tensor, idx: torch.Tensor, n_experts: int,
                  capacity: int):
    """x (B,S,d), idx (B,S) -> buf (B,E,C,d), dest (B,S), keep (B,S)."""
    b, s, d = x.shape
    idx = idx.long()
    onehot = F.one_hot(idx, n_experts)                       # (B,S,E)
    pos = onehot.cumsum(dim=1) - 1
    rank = pos.gather(-1, idx[..., None])[..., 0]            # (B,S)
    keep = rank < capacity
    dest = torch.where(keep, idx * capacity + rank,
                       torch.full_like(idx, n_experts * capacity))
    rows = n_experts * capacity + 1
    # out of place into zeros, so autograd reaches x; every kept token has
    # its own row, and only the cut-off row E*C takes several
    flat = dest + torch.arange(b, device=x.device)[:, None] * rows
    buf = x.new_zeros((b * rows, d)).index_add(0, flat.reshape(-1),
                                               x.reshape(b * s, d))
    buf = buf.reshape(b, rows, d)[:, :-1, :]
    return buf.reshape(b, n_experts, capacity, d), dest, keep


def _stack(w, shard):
    """An expert stack at its use: (the tensor to multiply, whether it is
    this rank's slice).  A plain stack as it is; a tensor-parallel one
    gathered whole (identity mode) or its local slice (reduce-scatter)."""
    w = tp_use(w, shard)
    return (w.local, True) if isinstance(w, TPWeight) else (w, False)


def _rows(w, sel: torch.Tensor, shard):
    """Experts ``sel`` of a stack (T experts, one a token): indexed; a
    tensor-parallel stack's local slice indexed, then gathered over the
    ranks in identity mode (the bits of indexing the gathered stack, with
    T/E of its bytes moved) or kept in reduce-scatter mode.  Returns (rows,
    whether they are this rank's slice)."""
    if not isinstance(w, TPWeight):
        return w[sel], False
    if shard is None:
        raise ValueError("a tensor-parallel expert stack used outside a "
                         "sharded call (pass the engine's ServeShard)")
    local = w.local[sel]
    if shard.reduce_scatter:
        return local, True
    return shard.mesh.gather(local, w.dim), False


def _down(h: torch.Tensor, wo: torch.Tensor, local: bool, shard
          ) -> torch.Tensor:
    """The down projection ``bmm(h, wo)``; a row-parallel slice's partial
    sums added over the ranks (one ``ServeMesh.reduce``, in f32)."""
    out = torch.bmm(h, wo)
    return shard.mesh.reduce(out) if local else out


def _expert_ffn(cfg: ModelConfig, p, buf: torch.Tensor, shard=None
                ) -> torch.Tensor:
    """buf (B,E,C,d) -> (B,E,C,d) through the expert-stacked SwiGLU: one
    batched product per weight over all experts, each expert's rows of
    every sequence together."""
    b, e, c, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, b * c, d)
    wg, _ = _stack(p["wi_gate"], shard)
    wu, _ = _stack(p["wi_up"], shard)
    wo, local = _stack(p["wo"], shard)
    g = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    h = F.silu(g.float()).to(buf.dtype) * u
    out = _down(h, wo, local, shard)
    return out.reshape(e, b, c, d).transpose(0, 1)


def _combine(cfg: ModelConfig, p, x: torch.Tensor, gates, idx, capacity,
             shard=None) -> torch.Tensor:
    """The routed output of x (B,S,d): each top-k slot dispatched on its
    own at ``capacity`` and its expert rows gathered back, scaled by the
    gate (0 for a dropped token), summed in slot order in x's dtype."""
    m = cfg.moe
    b, s, d = x.shape
    y = torch.zeros_like(x)
    for k in range(m.top_k):
        buf, dest, keep = _dispatch_one(x, idx[..., k], m.n_experts,
                                        capacity)
        out = _expert_ffn(cfg, p, buf, shard).reshape(
            b, m.n_experts * capacity, d)
        out = torch.cat([out, out.new_zeros((b, 1, d))], dim=1)
        gathered = torch.gather(out, 1, dest[..., None].expand(b, s, d))
        w = (gates[..., k] * keep.to(gates.dtype))[..., None]
        y = y + gathered * w.to(x.dtype)
    return y


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor, shard=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill MoE: x (B,S,d) -> (y (B,S,d), aux_loss)."""
    m = cfg.moe
    s = x.shape[1]
    gates, idx, aux = _route(cfg, p, x)
    capacity = max(1, int(math.ceil(s / m.n_experts * m.capacity_factor)))
    y = _combine(cfg, p, x, gates, idx, capacity, shard)
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x, shard=shard)
    return y, aux


def apply_moe_decode_dispatch(cfg: ModelConfig, p, x: torch.Tensor,
                              shard=None) -> torch.Tensor:
    """Decode MoE by capacity-based dispatch: all B*S decode tokens form
    one dispatch group."""
    m = cfg.moe
    b, s, d = x.shape
    gates, idx, _ = _route(cfg, p, x)
    capacity = max(1, int(math.ceil(b * s * m.capacity_factor
                                    / m.n_experts)))
    y = _combine(cfg, p, x.reshape(1, b * s, d),
                 gates.reshape(1, b * s, m.top_k),
                 idx.reshape(1, b * s, m.top_k), capacity,
                 shard).reshape(b, s, d)
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x, shard=shard)
    return y


def apply_moe_decode(cfg: ModelConfig, p, x: torch.Tensor, shard=None
                     ) -> torch.Tensor:
    """Decode MoE (S=1): gather each token's expert weights and run them
    locally."""
    m = cfg.moe
    b, s, d = x.shape
    gates, idx, _ = _route(cfg, p, x)
    xt = x.reshape(b * s, 1, d)
    idx = idx.reshape(b * s, m.top_k)
    gates = gates.reshape(b * s, m.top_k)
    y = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    for k in range(m.top_k):
        sel = idx[:, k]
        g = torch.bmm(xt, _rows(p["wi_gate"], sel, shard)[0])   # (T,1,f)
        u = torch.bmm(xt, _rows(p["wi_up"], sel, shard)[0])
        h = F.silu(g.float()).to(x.dtype) * u
        out = _down(h, *_rows(p["wo"], sel, shard), shard)[:, 0]  # (T,d)
        y = y + out * gates[:, k, None].to(x.dtype)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + apply_mlp(cfg, p["shared"], x, shard=shard)
    return y
