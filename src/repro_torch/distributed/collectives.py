"""Differentiable collectives of a training mesh
(``repro_torch.launch.mesh.TrainMesh``): what GSPMD inserts into the
reference's jitted step, written as ``torch.autograd.Function``s.

Every rank runs the same program (SPMD), so each rank enters the same
collectives in the same order, in the forward, in a rematerialised
recompute and in the backward.  ``axis`` is "data", "model" or "world".
A cotangent's backward follows what the computation after the collective
does on the ranks of that axis:

* split: the ranks compute on different rows (a data rank's batch slice, a
  sequence-parallel slice, a rank's heads), so each holds a partial
  gradient and the partials are summed;
* replicated: the ranks compute the same thing, so each already holds the
  whole gradient and keeps its own part.

A wrong choice gives gradients n times too large (or 1/n) while the loss
still falls, which only a leaf-by-leaf comparison with one device finds.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


class Gather(torch.autograd.Function):
    """``all_gather`` along ``dim`` over ``axis``.  Backward: the rank's own
    part of the cotangent, summed over ``axis`` first when ``grad_sum``
    (the computation after the gather is split on that axis: an FSDP
    weight's data ranks see different batch rows), kept as it is when not
    (it is replicated there: a tensor-parallel output gathered for a
    computation every model rank repeats)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad_sum):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad_sum = mesh, axis, dim, grad_sum
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = ctx.mesh.reduce(g, ctx.axis)
        return ctx.mesh.part(g, ctx.dim, ctx.axis), None, None, None, None


class Split(torch.autograd.Function):
    """The rank's own part of a tensor replicated over ``axis`` (along
    ``dim``).  Backward: ``all_gather`` of every rank's part of the
    cotangent, the whole cotangent of the replicated tensor."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.part(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g, ctx.dim, ctx.axis), None, None, None


class CopyTo(torch.autograd.Function):
    """Megatron's *f*, at the entry of a region split over ``axis`` (a
    tensor-parallel region on "model"; a replicated weight used by a data
    rank's batch slice on "data"): the identity forward, an ``all_reduce``
    of the partial cotangents backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce(g, ctx.axis), None, None


class ReduceFrom(torch.autograd.Function):
    """Megatron's *g*, at the exit of a region split over ``axis``: an
    ``all_reduce`` of the partial sums forward (a row-parallel product's, the
    experts of each rank), the identity backward (after it every rank
    computes the same thing and holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllReduce(torch.autograd.Function):
    """``all_reduce`` whose result every rank of ``axis`` uses as its own
    copy of one replicated value (each copy's cotangent counts): the sum
    forward and the sum of the copies' cotangents backward.  The MoE
    load-balance term's batch means over the data ranks."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce(g, ctx.axis), None, None


class MeanOver(torch.autograd.Function):
    """The mean of ``x`` over the ranks of ``axis`` (their sum divided by
    their number) as the global loss; backward, each rank's share of the
    cotangent (divided by the number), the rest of the sum arriving through
    the FSDP gathers' backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = mesh.size(axis)
        return mesh.reduce(x, axis) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class GatherBucket(torch.autograd.Function):
    """The FSDP gather of one or several weights over "data", one
    collective per dtype: ``xs[i]`` is split on dim ``dims[i]`` (None:
    replicated over "data", returned as it is).  Backward: one
    ``all_reduce`` per dtype of every cotangent (when ``grad_sum``: the
    data ranks' batches differ), then each sharded weight's own part."""

    @staticmethod
    def forward(ctx, mesh, dims, grad_sum, *xs):
        ctx.mesh, ctx.dims, ctx.grad_sum = mesh, dims, grad_sum
        out: List = list(xs)
        n = mesh.size("data")
        for idx in _by_dtype(xs, [d is not None for d in dims]):
            flat = torch.cat([xs[i].reshape(-1) for i in idx])
            parts = mesh.gather(flat, 0, "data").view(n, -1)
            off = 0
            for i in idx:
                k = xs[i].numel()
                out[i] = torch.cat([p[off:off + k].view(xs[i].shape)
                                    for p in parts], dim=dims[i])
                off += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        mesh, dims = ctx.mesh, ctx.dims
        gs = list(gs)
        if ctx.grad_sum:
            for idx in _by_dtype(gs, [True] * len(gs)):
                flat = mesh.reduce(torch.cat([gs[i].reshape(-1)
                                              for i in idx]), "data")
                off = 0
                for i in idx:
                    k = gs[i].numel()
                    gs[i] = flat[off:off + k].view(gs[i].shape)
                    off += k
        out = [g if d is None else mesh.part(g, d, "data")
               for g, d in zip(gs, dims)]
        return (None, None, None, *out)


class VocabParallelCE(torch.autograd.Function):
    """The mean next-token cross-entropy of logits split on the vocabulary
    over ``axis``: ``logits`` (B, S, V/n) f32 is this rank's slice, whose
    columns are the vocabulary's ``[lo, lo + V/n)`` with ``lo`` its
    coordinate times V/n; ``labels`` (B, S) whole.  Forward: the row max
    over the ranks (an ``all_reduce`` max of every rank's (B, S) maxima:
    exact), Σ exp(l − m) over the slice summed over ``axis``, the
    label's logit from the rank that holds it (zero elsewhere, summed:
    exact, each row has one nonzero source), and the mean of
    log Σ + m − ll over the rows, the same value on every rank of
    ``axis``.  Backward: (softmax − one-hot) on the slice times g / (B·S),
    with no collective (what follows the loss is replicated over ``axis``;
    the hidden's cotangent is summed by the *f* in front of the
    column-parallel head).  Saves the f32 slice and the row statistics."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, axis):
        v = logits.shape[-1]
        lo = mesh.index(axis) * v
        m, sum_exp = _row_stats(logits, mesh, axis)
        ids = labels.long() - lo
        mine = (ids >= 0) & (ids < v)
        ids = ids.clamp(0, v - 1)
        ll = torch.gather(logits, -1, ids[..., None])[..., 0]
        ll = mesh.reduce(torch.where(mine, ll, torch.zeros_like(ll)), axis)
        lse = torch.log(sum_exp) + m
        ctx.save_for_backward(logits, lse, ids, mine)
        return (lse - ll).mean()

    @staticmethod
    def backward(ctx, g):
        logits, lse, ids, mine = ctx.saved_tensors
        grad = (logits - lse[..., None]).exp_()
        grad.scatter_add_(-1, ids[..., None],
                          -mine[..., None].to(grad.dtype))
        grad.mul_(g / lse.numel())
        return grad, None, None, None


def _row_stats(logits, mesh, axis):
    """(m, Σ exp(l − m)) of each row of a vocabulary split over ``axis``:
    the max of every rank's row maxima, and the slices' sums added over
    ``axis``."""
    m = mesh.reduce(logits.amax(-1), axis, op="max")
    sum_exp = (logits - m[..., None]).exp_().sum(-1)
    return m, mesh.reduce(sum_exp, axis)


def _by_dtype(xs: Sequence[torch.Tensor], take: Sequence[bool]
              ) -> List[List[int]]:
    """Indices of ``xs`` where ``take``, grouped by dtype in first-seen
    order."""
    groups: dict = {}
    for i, (x, t) in enumerate(zip(xs, take)):
        if t:
            groups.setdefault(x.dtype, []).append(i)
    return list(groups.values())


def gather(x, mesh, axis, dim, grad_sum):
    return Gather.apply(x, mesh, axis, dim, grad_sum)


def split(x, mesh, axis, dim):
    return Split.apply(x, mesh, axis, dim)


def copy_to(x, mesh, axis):
    return CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    return ReduceFrom.apply(x, mesh, axis)


def all_reduce(x, mesh, axis):
    return AllReduce.apply(x, mesh, axis)


def mean_over(x, mesh, axis):
    return MeanOver.apply(x, mesh, axis)


def gather_bucket(xs, dims, mesh, grad_sum):
    return GatherBucket.apply(mesh, tuple(dims), grad_sum, *xs)


def vocab_parallel_ce(logits, labels, mesh, axis):
    return VocabParallelCE.apply(logits, labels, mesh, axis)
