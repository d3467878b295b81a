"""Step builders (mirrors ``src/repro/launch/steps.py``): the train step the
trainer runs, and the prefill and decode steps that serve the families the
paged engine refuses (the whisper-style encoder-decoder and the VLM stub
frontend) over a dense cache, as the reference serves them.

The prefill and decode steps run under ``torch.no_grad()``: serving never
records a graph, whatever the caller's weights require.  The train step
takes its loss and gradients from ``loss.backward()``: the parameters are
marked ``requires_grad`` for the step and released after it, so the
tensors the caller holds never keep a graph or a ``.grad``.

On a training mesh (``mesh=``, a ``TrainMesh``) the step runs on this
rank's shards (a ``sharding.TrainLayout``) and its slice of the batch:
the arithmetic is the single device's, split over the ranks, with the
collectives GSPMD inserts in the reference's jitted step.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.tree import leaves, map_tree


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True, device=None, mesh=None
                    ) -> Tuple[Callable, AdamW]:
    """(train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the optimizer).  The step returns the trees it was given,
    updated in place (``AdamW.update``).  Without ``opt_cfg`` the moments
    follow REPRO_OPT_STATE.

    With a training ``mesh`` the step is ``train_step(params, opt_state,
    batch, layout)``: ``params`` and ``opt_state`` are this rank's shards
    under ``layout`` (``sharding.train_layout``), ``batch`` its slice
    (``batch_split``: whether the ranks' slices differ, or a batch that does
    not divide is replicated).  The loss is the global mean: the data
    ranks' local means summed over "data" and divided by their number
    (``collectives.MeanOver``).  Under fsdp_tp each gradient arrives
    reduced by the backward of its FSDP gather; under dp the weights are
    replicated, the batch split over every rank, and the gradients are
    ``all_reduce``d over the world and divided by its size.  Over
    replicated rows nothing is summed."""
    fns = build_model(cfg, device)
    if opt_cfg is None:
        from repro_torch.perf import perf
        opt_cfg = AdamWConfig(state_dtype=perf().opt_state)
    opt = AdamW(opt_cfg)
    if mesh is not None:
        return _mesh_step(cfg, fns, opt, remat, mesh), opt

    def train_step(params, opt_state, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        try:
            loss = fns.loss(params, batch, remat=remat)
            loss.backward()
            grads = map_tree(lambda p: p.grad if p.grad is not None
                             else p.new_zeros(p.shape), params)
        finally:
            for p in ps:
                p.requires_grad_(False)
                p.grad = None
        new_params, new_state, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = loss.detach()
        return new_params, new_state, metrics

    return train_step, opt


def _mesh_step(cfg: ModelConfig, fns, opt: AdamW, remat: bool, mesh):
    def train_step(params, opt_state, batch, layout, batch_split=True):
        seq_len = batch["labels"].shape[1]
        shard = sharding.train_shard(mesh, seq_len, batch_split)
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        try:
            if shard.mode == "fsdp_tp":
                model_params = sharding._tree_map2(
                    lambda spec, w: sharding.TrainWeight(
                        w, tuple(spec), sharding.full_shape(w.shape, spec,
                                                            mesh)),
                    layout.params, params)
            else:
                model_params = params
            local = fns.loss(model_params, batch, remat=remat, shard=shard)
            axis = shard.batch_axis
            if shard.mode == "dp":
                local.backward()
                loss = mesh.reduce(local.detach(), axis) / mesh.size(axis) \
                    if batch_split else local.detach()
            else:
                loss = col.mean_over(local, mesh, axis) if batch_split \
                    else local
                loss.backward()
            grads = map_tree(lambda p: p.grad if p.grad is not None
                             else p.new_zeros(p.shape), params)
        finally:
            for p in ps:
                p.requires_grad_(False)
                p.grad = None
        if shard.mode == "dp" and batch_split:
            grads = _dp_mean(grads, mesh)
        new_params, new_state, metrics = opt.update(grads, opt_state, params,
                                                    layout=layout)
        metrics["loss"] = loss.detach()
        return new_params, new_state, metrics

    return train_step


def _dp_mean(grads, mesh):
    """Replicated weights' gradients under dp: ``all_reduce``d over the
    world (in f32, one collective per dtype) and divided by its size."""
    flat = leaves(grads)
    out = {}
    for dtype in dict.fromkeys(g.dtype for g in flat):
        gs = [g for g in flat if g.dtype == dtype]
        buf = mesh.reduce(torch.cat([g.float().reshape(-1) for g in gs]),
                          "world") / mesh.world
        off = 0
        for g in gs:
            out[id(g)] = buf[off:off + g.numel()].view(g.shape).to(dtype)
            off += g.numel()
    return map_tree(lambda g: out[id(g)], grads)


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """prefill_step(params, batch) -> (cache, last-position logits (B,V)):
    the family's ``prefill`` (a dense cache of the prompt's capacity)."""
    fns = build_model(cfg, device)

    def prefill_step(params, batch):
        with torch.no_grad():
            return fns.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None) -> Callable:
    """decode_step(params, cache, batch) -> (cache, logits (B,V)): the
    family's ``decode_step``, writing the cache in place."""
    fns = build_model(cfg, device)

    def decode_step(params, cache, batch):
        with torch.no_grad():
            return fns.decode_step(params, cache, batch)

    return decode_step

