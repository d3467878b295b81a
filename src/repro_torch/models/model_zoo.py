"""Model dispatch (mirrors ``src/repro/models/model_zoo.py``): one
``ModelFns`` bundle per architecture family.  This slice ports the dense
family; the others raise and name the ROADMAP slice that brings them."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import transformer

_LATER_SLICES = {
    "moe": "A6 (MoE)",
    "ssm": "A8 (SSM and hybrid)",
    "hybrid": "A8 (SSM and hybrid)",
    "vlm": "A11 (enc-dec and VLM)",
    "audio": "A11 (enc-dec and VLM)",
}


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init: Callable              # (seed) -> params on the bundle's device
    prefill: Callable           # (params, batch) -> (cache, logits)
    decode_step: Callable       # (params, cache, batch) -> (cache, logits)
    make_cache: Callable        # (batch_size, max_len) -> cache
    # paged serving interface (block-table-aware); caches update in place
    make_paged_cache: Callable  # (num_blocks, block_size) -> cache
    decode_paged: Callable      # (params, cache, batch) -> (cache, logits)
    prefill_chunk: Callable     # (params, cache, batch, m_used=) -> (cache, logits)
    # KVStore data plane: per-block device copy and device<->host movement
    paged_block_copy: Callable  # (cache, src, dst) -> cache
    paged_block_read: Callable  # (cache, idx) -> host tensors
    paged_block_write: Callable  # (cache, idx, data) -> cache


def build_model(cfg: ModelConfig, device=None) -> ModelFns:
    """The family's functions, with params and caches on ``device``
    (default cuda)."""
    if cfg.family != "dense":
        slice_ = _LATER_SLICES.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: "
            f"ROADMAP {slice_}")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    return ModelFns(
        init=lambda seed=0: transformer.init_lm(cfg, seed, dev),
        prefill=lambda p, b: transformer.lm_prefill(cfg, p, b),
        decode_step=lambda p, c, b: transformer.lm_decode_step(cfg, p, c, b),
        make_cache=lambda bs, ml: transformer.make_decode_cache(
            cfg, bs, ml, dtype, dev),
        make_paged_cache=lambda nb, bsz: transformer.make_paged_cache(
            cfg, nb, bsz, dtype, dev),
        decode_paged=lambda p, c, b: transformer.lm_decode_step_paged(
            cfg, p, c, b),
        prefill_chunk=lambda p, c, b, m_used=None: transformer.lm_prefill_chunk(
            cfg, p, c, b, m_used=m_used),
        paged_block_copy=transformer.paged_block_copy,
        paged_block_read=transformer.paged_block_read,
        paged_block_write=transformer.paged_block_write,
    )
