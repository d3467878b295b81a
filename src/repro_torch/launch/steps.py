"""The train step the trainer runs (mirrors ``make_train_step`` of
``src/repro/launch/steps.py``; the serve engine calls ``ModelFns``
directly, so its prefill and decode step builders are not carried over).

The train step takes its loss and gradients from ``loss.backward()``: the
parameters are marked ``requires_grad`` for the step and released after it,
so the tensors the caller holds never keep a graph or a ``.grad``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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

