"""Model dispatch (mirrors ``src/repro/models/model_zoo.py``): one
``ModelFns`` bundle per architecture family.  The dense, moe and vlm
families share the transformer's functions (vlm takes the stub frontend's
embeds and M-RoPE positions); ssm, hybrid and the audio encoder-decoder
have their own.  The audio family has no paged interface (its paged
fields are None), and the serve engine refuses vlm and audio, as the
reference's does: they are served through ``launch.steps``.

The dry run reads shapes only: ``input_specs`` gives a cell's batch,
``abstract_params`` the weights and ``abstract_cache`` a decode cache, all
``meta`` tensors with the reference's shapes and dtypes (nothing is drawn
or stored).  ``build_model`` takes ``meta`` when it is named; every entry
point that runs a model refuses it."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, ssm_lm, transformer


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init: Callable              # (seed) -> params on the bundle's device
    # (params, batch, remat=, shard=) -> scalar loss; every family's takes
    # a training step's ``shard=`` on a mesh (the rank's batch rows as
    # ``sharding.batch_specs`` splits them: the VLM's positions on dim 1,
    # the audio frames on dim 0)
    loss: Callable
    # (params, batch, shard=) -> (cache, logits) and (params, cache, batch,
    # shard=) -> (cache, logits); every family's take a prefill or decode
    # step's ``shard=`` on a training mesh (``sharding.serve_shard``: the
    # rank's weights, batch rows and cache blocks)
    prefill: Callable
    decode_step: Callable
    make_cache: Callable        # (batch_size, max_len) -> cache
    # (ShapeSpec) -> {name: meta tensor}: a cell's global batch
    input_specs: Callable
    # paged serving interface (block-table-aware); caches update in place.
    # Stateful families (ssm, hybrid) take ``state_slots=`` on
    # make_paged_cache and read "state_slot(s)" from the batch; None for
    # the audio family, which has none
    # the transformer's take a sharded serve engine's ``n_model=`` and
    # ``shard=`` (the ranks' head split; see models/transformer.py)
    # (num_blocks, block_size[, state_slots=]) -> cache
    make_paged_cache: Optional[Callable] = None
    # (params, cache, batch) -> (cache, logits)
    decode_paged: Optional[Callable] = None
    # (params, cache, batch, m_used=) -> (cache, logits)
    prefill_chunk: Optional[Callable] = None
    # KVStore data plane: per-block device copy and device<->host movement
    paged_block_copy: Optional[Callable] = None  # (cache, src, dst) -> cache
    paged_block_read: Optional[Callable] = None  # (cache, idx) -> host tensors
    paged_block_write: Optional[Callable] = None  # (cache, idx, data) -> cache
    # StateSlab data plane: the same three operations at slot granularity
    # over the same cache; present exactly for the stateful families
    state_slot_copy: Optional[Callable] = None   # (cache, src, dst) -> cache
    state_slot_read: Optional[Callable] = None   # (cache, idx) -> host tensors
    state_slot_write: Optional[Callable] = None  # (cache, idx, data) -> cache


def build_model(cfg: ModelConfig, device=None) -> ModelFns:
    """The family's functions, with params and caches on ``device``
    (default cuda; ``meta`` for shapes only)."""
    fam = cfg.family
    if fam not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {fam!r}")
    dev = resolve_device(device, allow_meta=True)
    dtype = torch_dtype(cfg)
    specs = lambda spec: input_specs(cfg, spec)  # noqa: E731
    if fam == "audio":
        return ModelFns(
            init=lambda seed=0: encdec.init_encdec(cfg, seed, dev),
            loss=lambda p, b, **kw: encdec.encdec_loss(cfg, p, b, **kw),
            prefill=lambda p, b, shard=None: encdec.encdec_prefill(
                cfg, p, b, shard=shard),
            decode_step=lambda p, c, b, shard=None: encdec.encdec_decode_step(
                cfg, p, c, b, shard=shard),
            make_cache=lambda bs, ml: encdec.make_encdec_cache(
                cfg, bs, ml, dtype, dev),
            input_specs=specs,
        )
    if fam == "ssm":
        # attention-free: the "paged" cache is all slab, no KV pages, and
        # the block data plane is a no-op (the engine never grows a table)
        return ModelFns(
            init=lambda seed=0: ssm_lm.init_ssm_lm(cfg, seed, dev),
            loss=lambda p, b, **kw: ssm_lm.ssm_lm_loss(cfg, p, b, **kw),
            prefill=lambda p, b, shard=None: ssm_lm.ssm_lm_prefill(
                cfg, p, b, shard=shard),
            decode_step=lambda p, c, b, shard=None: ssm_lm.ssm_lm_decode_step(
                cfg, p, c, b, shard=shard),
            make_cache=lambda bs, ml: ssm_lm.make_ssm_cache(cfg, bs, dtype,
                                                            dev),
            input_specs=specs,
            make_paged_cache=lambda nb, bsz, state_slots=1:
                ssm_lm.make_ssm_paged_cache(cfg, state_slots, dtype, dev),
            decode_paged=lambda p, c, b: ssm_lm.ssm_lm_decode_step_paged(
                cfg, p, c, b),
            prefill_chunk=lambda p, c, b, m_used=None:
                ssm_lm.ssm_lm_prefill_chunk(cfg, p, c, b),
            paged_block_copy=lambda c, src, dst: c,
            paged_block_read=lambda c, idx: {},
            paged_block_write=lambda c, idx, data: c,
            state_slot_copy=ssm_lm.state_slot_copy,
            state_slot_read=ssm_lm.state_slot_read,
            state_slot_write=ssm_lm.state_slot_write,
        )
    if fam == "hybrid":
        # mixed layout: KV pages for the shared block's call sites and a
        # state slab for the Mamba2 backbone, in one cache
        return ModelFns(
            init=lambda seed=0: hybrid.init_hybrid(cfg, seed, dev),
            loss=lambda p, b, **kw: hybrid.hybrid_loss(cfg, p, b, **kw),
            prefill=lambda p, b, shard=None: hybrid.hybrid_prefill(
                cfg, p, b, shard=shard),
            decode_step=lambda p, c, b, shard=None: hybrid.hybrid_decode_step(
                cfg, p, c, b, shard=shard),
            make_cache=lambda bs, ml: hybrid.make_hybrid_cache(
                cfg, bs, ml, dtype, dev),
            input_specs=specs,
            make_paged_cache=lambda nb, bsz, state_slots=1:
                hybrid.make_hybrid_paged_cache(cfg, nb, bsz, state_slots,
                                               dtype, dev),
            decode_paged=lambda p, c, b: hybrid.hybrid_decode_step_paged(
                cfg, p, c, b),
            prefill_chunk=lambda p, c, b, m_used=None:
                hybrid.hybrid_prefill_chunk(cfg, p, c, b, m_used=m_used),
            paged_block_copy=hybrid.paged_block_copy,
            paged_block_read=hybrid.paged_block_read,
            paged_block_write=hybrid.paged_block_write,
            state_slot_copy=hybrid.state_slot_copy,
            state_slot_read=hybrid.state_slot_read,
            state_slot_write=hybrid.state_slot_write,
        )
    return ModelFns(
        init=lambda seed=0: transformer.init_lm(cfg, seed, dev),
        loss=lambda p, b, **kw: transformer.lm_loss(cfg, p, b, **kw),
        prefill=lambda p, b, shard=None: transformer.lm_prefill(
            cfg, p, b, shard=shard),
        decode_step=lambda p, c, b, shard=None: transformer.lm_decode_step(
            cfg, p, c, b, shard=shard),
        make_cache=lambda bs, ml: transformer.make_decode_cache(
            cfg, bs, ml, dtype, dev),
        input_specs=specs,
        make_paged_cache=lambda nb, bsz, n_model=1:
            transformer.make_paged_cache(cfg, nb, bsz, dtype, dev,
                                         n_model=n_model),
        decode_paged=lambda p, c, b, shard=None:
            transformer.lm_decode_step_paged(cfg, p, c, b, shard=shard),
        prefill_chunk=lambda p, c, b, m_used=None, shard=None:
            transformer.lm_prefill_chunk(cfg, p, c, b, m_used=m_used,
                                         shard=shard),
        paged_block_copy=transformer.paged_block_copy,
        paged_block_read=transformer.paged_block_read,
        paged_block_write=transformer.paged_block_write,
    )


def input_specs(cfg: ModelConfig, spec: ShapeSpec):
    """A cell's global batch as ``meta`` tensors, the reference's
    ``ModelFns.input_specs`` name for name: tokens and labels int32
    (B, S); the VLM's stub embeds (B, S, d) in the model's dtype and M-RoPE
    positions (3, B, S); the audio family's frames (B, S, d).  Prefill
    drops the labels, decode is one token (``token`` (B, 1), ``cur_len``
    a scalar; the VLM's embeds and positions of length 1; no ``cur_len``
    for ssm)."""
    b, s = spec.global_batch, spec.seq_len
    dtype = torch_dtype(cfg)
    fam = cfg.family

    def t(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    if spec.kind in ("train", "prefill"):
        if fam == "vlm":
            out = {"embeds": t((b, s, cfg.d_model), dtype),
                   "positions": t((3, b, s))}
        elif fam == "audio":
            out = {"frames": t((b, s, cfg.d_model), dtype),
                   "tokens": t((b, s))}
        else:
            out = {"tokens": t((b, s))}
        if spec.kind == "train":
            out["labels"] = t((b, s))
        return out
    if fam == "vlm":
        return {"embeds": t((b, 1, cfg.d_model), dtype),
                "positions": t((3, b, 1)), "cur_len": t(())}
    if fam == "ssm":
        return {"token": t((b, 1))}
    return {"token": t((b, 1)), "cur_len": t(())}


def abstract_params(cfg: ModelConfig):
    """``init``'s tree on ``meta``: every leaf's shape and dtype, nothing
    drawn (the init functions make each leaf empty there)."""
    return build_model(cfg, "meta").init(0)


def abstract_cache(cfg: ModelConfig, batch_size: int, max_len: int):
    """``make_cache(batch_size, max_len)``'s tree on ``meta``."""
    return build_model(cfg, "meta").make_cache(batch_size, max_len)
