"""Model-side multi-LoRA glue (mirrors ``src/repro/models/lora.py``): add
each sequence's own adapter delta to a projection.

The serve engine puts a ``lora`` descriptor on a paged dispatch when (and
only when) at least one row holds an adapter:

    {"ids": (B,) int32 per-sequence adapter slot (-1 = base-only),
     "slabs": {proj: {"a": (L, S, d_in, R), "b": (L, S, R, d_out)}}}

The JAX package reshapes the slabs for its layer scan (``split_layers``);
the port's transformer loops over layers in Python and hands each layer the
slices ``slabs[proj]["a"][i]`` / ``["b"][i]``, so inside a layer a slab is
``(S, d_in, R)`` / ``(S, R, d_out)``.  Each adapted projection is one
launch of the fused segmented kernel (``ops.lora_delta``): the shrink, the
expand and the add of the base, with the ids read per sequence (``x``'s
second axis is the rows a sequence), so nothing is repeated per row.
``block_out``, the expand's output tile, comes from the engine's kernel
plan (``batch["lora_block_out"]``); the transformer puts it on each layer's
descriptor, so no module state carries it.  When the descriptor is None
nothing here runs: no zero-add and no launch, which is the
``adapter_id=None`` bitwise-identity contract.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def layer_slice(lora: Optional[dict], i: int, block_out: int
                ) -> Optional[dict]:
    """Layer ``i``'s descriptor: the per-sequence ids, the layer's slab
    slices (views of the engine's slab, not copies) and the expand tile."""
    if lora is None:
        return None
    return {"ids": lora["ids"], "block_out": int(block_out),
            "slabs": {p: {"a": sl["a"][i], "b": sl["b"][i]}
                      for p, sl in lora["slabs"].items()}}


def _fused(proj: str, x: torch.Tensor, lora: dict,
           base: Optional[torch.Tensor]) -> torch.Tensor:
    a = lora["slabs"][proj]["a"]
    b = lora["slabs"][proj]["b"]
    if a.dim() != 3:
        raise ValueError(f"lora slab for {proj} must be layer-sliced "
                         f"(S,d,R), got {tuple(a.shape)}")
    bsz, s, d = x.shape
    o = int(b.shape[-1])
    y = ops.lora_delta(x.reshape(bsz * s, d), a, b, lora["ids"],
                       rows_per_seq=s,
                       block_out=max(1, min(lora["block_out"], o)),
                       base=None if base is None else base.reshape(bsz * s, o))
    return y.reshape(bsz, s, o)


def delta(proj: str, x: torch.Tensor, lora: Optional[dict]
          ) -> Optional[torch.Tensor]:
    """The per-sequence LoRA delta of projection ``proj`` of one layer: x
    (B, S, d_in) -> (B, S, d_out) in x's dtype, or None when there is no
    descriptor or it does not adapt ``proj``.  ``lora`` is one layer's
    descriptor (``layer_slice``)."""
    if lora is None or proj not in lora["slabs"]:
        return None
    return _fused(proj, x, lora, None)


def add_delta(proj: str, base: torch.Tensor, x: torch.Tensor,
              lora: Optional[dict]) -> torch.Tensor:
    """base + delta(proj, x) in one launch; ``base`` passes through
    untouched (no add) when no LoRA is active."""
    if lora is None or proj not in lora["slabs"]:
        return base
    return _fused(proj, x, lora, base)
