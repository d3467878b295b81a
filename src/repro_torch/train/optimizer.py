"""AdamW with global-norm clipping, a cosine schedule and optional int8
block-quantized moments (mirrors ``src/repro/train/optimizer.py``).

Plain tensor code over the port's parameter trees, not ``torch.optim``: the
state keeps the reference's layout ``{"step", "m", "v"}`` with ``m``/``v``
shaped like the parameters, so it crosses ``repro_torch.bridge`` to the JAX
package and back.  Every update is computed in f32 and cast to the
parameter's dtype and written into the leaf's own storage (the update is
in place).  int8 moments hold 1 B a value plus an f32 scale per 256
(~2.03 B a parameter for both moments together instead of 8).

On a training mesh (``layout``, a ``sharding.TrainLayout``) the tensors are
this rank's shards.  f32 moments mirror the weight's spec, so the update is
elementwise on the rank's shard; under "dp" the moments are ZeRO-1 slices,
and each rank updates its slice of the weight and ``all_gather``s the
whole.  The global norm counts each distinct value once: a leaf replicated
over an axis is counted only by that axis's coordinate 0, and the ranks'
sums meet in one ``all_reduce`` (no 1/n scaling, which would not be
exact).  int8 moments keep the single device's blocks: a rank holds a
contiguous range of the whole leaf's blocks (``opt_state_specs``) and
updates it in ``MESH_UPDATE_CHUNK`` windows from the gathered gradient and
weight values, the new values summed back into every rank's shard
(``_blocks_update``), so a checkpoint of whole quantized leaves moves
between meshes and the update is one device's.
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


# an int8 leaf's update on a training mesh runs over windows of at most
# this many values of the whole leaf: besides the update's own f32
# temporaries a window holds the gathered gradient and weight values, the
# rank's positions in it and its summed new values, and the ranks that
# share one card each hold theirs
MESH_UPDATE_CHUNK = 1 << 24

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


def quantized_like(shape, block: int) -> Quantized:
    """The layout of a block-quantized moment of a leaf of ``shape``: its
    payload and scales as meta tensors (no storage), for the spec
    functions (``sharding.train_layout``)."""
    n = math.prod(shape)
    pad = (-n) % block
    nb = (n + pad) // block
    return Quantized(torch.empty((nb, block), dtype=torch.int8, device="meta"),
                     torch.empty((nb, 1), dtype=torch.float32,
                                 device="meta"), tuple(shape), pad)


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

    def init(self, params, layout=None) -> Dict[str, Any]:
        """Zero moments shaped like ``params`` (on a mesh, the rank's
        shards under ``layout``: a ZeRO moment is the rank's slice, an int8
        moment the rank's range of the whole leaf's blocks)."""

        def zero_like(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if self.cfg.state_dtype == "int8":
                return quantize(z, self.cfg.quant_block)
            return z
        device = leaves(params)[0].device

        def moments():
            if layout is None:
                return map_tree(zero_like, params)
            return map_tree(lambda specs, p: _zero_slice(
                p, specs, layout, self.cfg.quant_block),
                _spec_pairs(layout), params)
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": moments(), "v": moments()}

    @torch.no_grad()
    def update(self, grads, state, params, layout=None
               ) -> Tuple[Any, Dict[str, Any], Dict]:
        """(params, state, {"lr", "grad_norm"}), updated in place: each
        leaf's weight, ``m`` and ``v`` (an int8 moment's payload and scales)
        are overwritten in their own storage once the leaf's new values are
        computed, and ``state["step"]`` is advanced, so one train state is
        alive at a time (the reference donates its state to the jitted
        step).  A caller that needs the old tree afterwards clones it first.
        The global norm is taken in f32 over every gradient leaf and
        reported before clipping.  On a mesh (``layout``) the trees are the
        rank's shards (see the module's docstring)."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = cosine_lr(cfg, step)
        gs = leaves(grads)
        if layout is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(
                g.to(torch.float32))) for g in gs))
        else:
            gnorm = _mesh_norm(gs, layout)
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

        if layout is None:
            map_tree(upd, params, grads, state["m"], state["v"])
        else:
            _mesh_update(upd, upd_slice, params, grads, state, layout,
                         cfg.quant_block)
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


# -- a training mesh ---------------------------------------------------------

class _Specs:
    """A weight's spec and its moments' (one leaf to ``train.tree``): a
    tuple, or for int8 moments a ``Quantized`` of specs."""

    def __init__(self, param, moment):
        self.param, self.moment = param, moment


def _spec_pairs(layout):
    """A tree of ``_Specs`` in the weights' structure."""
    from repro_torch.distributed.sharding import _tree_map2
    return _tree_map2(_Specs, layout.params, layout.moments,
                      is_leaf=lambda x: isinstance(x, tuple))


def _zero_slice(p, specs: _Specs, layout, block: int):
    """A zero moment of weight shard ``p``: f32 of ``p``'s shape, or under
    a ZeRO spec the rank's slice of it; int8, the rank's blocks of the
    whole leaf's zero moment (``quantize``'s bits, made without the
    whole)."""
    from repro_torch.distributed.sharding import local_shard, shard_ranges
    mesh = layout.mesh
    if isinstance(specs.moment, Quantized):
        spec = specs.moment
        whole = ((math.prod(spec.shape) + spec.pad) // block, block)
        nb = shard_ranges(whole, spec.q, mesh, mesh.coords)[0][1]
        one = quantize(torch.zeros((block,), dtype=torch.float32,
                                   device=p.device), block)
        return Quantized(one.q.expand(nb, block).contiguous(),
                         one.scale.expand(nb, 1).contiguous(), spec.shape,
                         spec.pad)
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if specs.moment == specs.param:
        return z
    return local_shard(z, specs.moment, mesh, mesh.coords)


def _counted(spec, coords) -> bool:
    """Whether this rank counts a leaf of ``spec`` in the global norm: only
    coordinate 0 of each axis the leaf is replicated over."""
    axes = set()
    for e in spec:
        axes.update(e if isinstance(e, tuple) else (e,))
    return all(i == 0 for a, i in coords.items() if a not in axes)


def _mesh_norm(gs, layout) -> torch.Tensor:
    coords = layout.mesh.coords
    counted = [_counted(s.param, coords) for s in leaves(_spec_pairs(layout))]
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g, c in zip(gs, counted) if c)
    if not isinstance(sq, torch.Tensor):
        sq = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    return torch.sqrt(layout.mesh.reduce(sq, "world"))


def _mesh_update(upd, upd_slice, params, grads, state, layout, block
                 ) -> None:
    """``upd`` over the rank's shards: in place where the moment mirrors the
    weight; on a ZeRO moment, on the rank's slice of the weight, which the
    ranks then ``all_gather`` whole; on int8 moments, ``_blocks_update``."""
    from repro_torch.distributed.sharding import local_shard
    mesh = layout.mesh

    def one(specs, p, g, m, v):
        if isinstance(specs.moment, Quantized):
            return _blocks_update(upd_slice, p, g, m, v, specs, layout,
                                  block)
        if specs.moment == specs.param:
            return upd(p, g, m, v)
        d = next(i for i, (a, b) in enumerate(zip(specs.moment, specs.param))
                 if a != b)
        ps = local_shard(p, specs.moment, mesh, mesh.coords)
        upd(ps, local_shard(g, specs.moment, mesh, mesh.coords), m, v)
        e = specs.moment[d]
        p.copy_(mesh.gather(ps, d, e if isinstance(e, str) else "world"))

    map_tree(one, _spec_pairs(layout), params, grads, state["m"], state["v"])


class _LocalIndex:
    """Where a rank's shard of a leaf sits in the whole leaf: its row-major
    positions map to increasing positions of the whole flattened leaf
    (``sharding.shard_ranges``)."""

    def __init__(self, shape, spec, mesh, coords):
        from repro_torch.distributed.sharding import shard_ranges
        ranges = shard_ranges(shape, spec, mesh, coords)
        self.maps = [[a + i for a in lo for i in range(size)]
                     for lo, size in ranges]
        self.local = [len(m) for m in self.maps]
        self.strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
        self.numel = math.prod(self.local)

    def whole_of(self, i: int) -> int:
        out = 0
        for d in reversed(range(len(self.local))):
            i, c = divmod(i, self.local[d])
            out += self.maps[d][c] * self.strides[d]
        return out

    def first_at(self, pos: int) -> int:
        """The first local position whose whole position is >= ``pos``."""
        lo, hi = 0, self.numel
        while lo < hi:
            mid = (lo + hi) // 2
            if self.whole_of(mid) < pos:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def whole(self, a: int, b: int, lo: int, device) -> torch.Tensor:
        """The whole positions of local positions ``a:b``, less ``lo``
        (offsets into a window that starts there; int64)."""
        i = torch.arange(a, b, device=device)
        out = torch.full_like(i, -lo)
        for d in reversed(range(len(self.local))):
            c = i % self.local[d]
            i = i.div_(self.local[d], rounding_mode="floor")
            out += torch.tensor(self.maps[d], device=device)[c] \
                * self.strides[d]
            del c
        return out


def _blocks_update(upd_slice, p, g, m, v, specs: _Specs, layout, block
                   ) -> None:
    """The int8 update of one leaf on a mesh, the single device's blocks:
    the moments hold a range of the whole leaf's blocks (every block when
    their spec does not split them), and the weight and gradient are the
    rank's shards.  In rounds, every rank takes the next window of at most
    ``MESH_UPDATE_CHUNK`` values of its block range (block-aligned):
    every rank sends the gradient and weight values it holds in each
    rank's window (one ``all_gather`` of the packed values, in their own
    dtype; skipped where every rank holds the whole leaf), updates its
    window with the single device's block-local quantization, and, when
    the blocks are split, the ranks ``all_gather`` their windows' new
    values and each writes the positions it holds into its shard.  Values
    are copied, never summed, so they arrive bit for bit."""
    from repro_torch.distributed.sharding import full_shape, shard_ranges
    mesh = layout.mesh
    pspec, mspec = specs.param, specs.moment
    shape = full_shape(p.shape, pspec, mesh)
    n = math.prod(shape)
    nb = (n + mspec.pad) // block
    every = _all_coords(mesh)
    me = mesh.rank

    def owned(coords):
        (b0,), k = shard_ranges((nb, block), mspec.q, mesh, coords)[0]
        return b0 * block, min(n, (b0 + k) * block)
    split = mspec.q[0] is not None
    # each rank's block range, or one range that every rank updates
    owners = [owned(c) for c in every] if split else [(0, n)]
    mine = me if split else 0
    whole_local = all(e is None for e in pspec)
    index = None if whole_local else [_LocalIndex(shape, pspec, mesh, c)
                                      for c in every]
    pflat, gflat = p.view(-1), g.reshape(-1)
    step = MESH_UPDATE_CHUNK - MESH_UPDATE_CHUNK % block
    span = max(hi - lo for lo, hi in owners)
    for k in range(0, span, step):
        wins = [(min(lo + k, hi), min(lo + k + step, hi))
                for lo, hi in owners]
        s, e = wins[mine]
        if whole_local:
            pw, gw = pflat[s:e], gflat[s:e]
        else:
            pw, gw = _gather_window(pflat, gflat, wins, mine, index, mesh)
        new = pw.clone()
        if s < e:
            lo = owners[mine][0]
            mm, vv = (_slice_moment(x, s - lo, e - lo, block)
                      for x in (m, v))
            mm, vv = upd_slice(new, gw, mm, vv)
            _store_moment(m, s - lo, mm, block)
            _store_moment(v, s - lo, vv, block)
        del pw, gw
        if split:
            buf = new.new_zeros((1, max(we - ws for ws, we in wins)))
            buf[0, :e - s] = new
            news = mesh.gather(buf, 0, "world")
        else:
            news = new[None]
        for r, (ws, we) in enumerate(wins):
            if we == ws:
                continue
            if whole_local:
                pflat[ws:we] = news[r, :we - ws]
            else:
                a, b = index[me].first_at(ws), index[me].first_at(we)
                pflat[a:b] = news[r][index[me].whole(a, b, ws, p.device)]


def _all_coords(mesh):
    """Every rank's coordinates, in rank order (row-major over the axes
    in the mesh's order)."""
    names, sizes = list(mesh.shape), list(mesh.shape.values())
    out = []
    for rank in range(math.prod(sizes)):
        c = {}
        for name, size in zip(reversed(names), reversed(sizes)):
            rank, c[name] = divmod(rank, size)
        out.append(c)
    return out


def _gather_window(pflat, gflat, wins, mine, index, mesh):
    """The weight and gradient values of window ``wins[mine]`` of the whole
    flattened leaf, from the ranks' shards: each rank packs the values it
    holds in every window, in window order (padded to the longest rank's
    pack), one ``all_gather`` brings every rank's pack, and the receiver
    places each rank's values for its own window (a value held by several
    ranks arrives equal from each)."""
    me = mesh.rank
    spans = [[(ix.first_at(ws), ix.first_at(we)) for ws, we in wins]
             for ix in index]
    sizes = [sum(b - a for a, b in sp) for sp in spans]
    pack = pflat.new_zeros((1, 2, max(sizes)))
    off = 0
    for a, b in spans[me]:
        pack[0, 0, off:off + b - a] = pflat[a:b]
        pack[0, 1, off:off + b - a] = gflat[a:b]
        off += b - a
    packs = mesh.gather(pack, 0, "world")
    ws, we = wins[mine]
    pw = pflat.new_empty((we - ws,))
    gw = gflat.new_empty((we - ws,))
    for r, sp in enumerate(spans):
        off = sum(b - a for a, b in sp[:mine])
        a, b = sp[mine]
        pos = index[r].whole(a, b, ws, pflat.device)
        pw[pos] = packs[r, 0, off:off + b - a]
        gw[pos] = packs[r, 1, off:off + b - a].to(gw.dtype)
    return pw, gw
