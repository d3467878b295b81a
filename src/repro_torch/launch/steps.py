"""Step builders (mirrors ``src/repro/launch/steps.py``): the train step the
trainer runs, and the prefill and decode steps that serve the families the
paged engine refuses (the whisper-style encoder-decoder and the VLM stub
frontend) over a dense cache, as the reference serves them.

The prefill and decode steps run under ``torch.no_grad()``: serving never
records a graph, whatever the caller's weights require.  The train step
takes its loss and gradients from ``loss.backward()``: the parameters are
marked ``requires_grad`` for the step and released after it, so the
tensors the caller holds never keep a graph or a ``.grad``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.tree import leaves, map_tree


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True, device=None
                    ) -> Tuple[Callable, AdamW]:
    """(train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the optimizer).  The step returns the trees it was given,
    updated in place (``AdamW.update``).  Without ``opt_cfg`` the moments
    follow REPRO_OPT_STATE."""
    fns = build_model(cfg, device)
    if opt_cfg is None:
        from repro_torch.perf import perf
        opt_cfg = AdamWConfig(state_dtype=perf().opt_state)
    opt = AdamW(opt_cfg)

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

