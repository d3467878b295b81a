"""Decoder-only transformer, dense family (mirrors
``src/repro/models/transformer.py``).

The JAX package stacks layer weights and ``lax.scan``s over them; here
``params["layers"]`` is a list of per-layer dicts and the scan is a Python
loop.  Caches keep the JAX layouts so they cross the bridge unchanged: the
dense cache is ``(L, B, Smax, KV, hd)`` and the paged cache
``(L, N, bs, KV, hd)``, both slot-major (layer ``l`` of the forward pass
uses cache row ``l`` for dense archs).  Every cache update is in place.

Training: ``lm_loss`` runs every layer's attention through the
flash-attention kernel (``impl="kernel"``), forward and backward, and every
norm through ``RMSNormFn``; ``forward_hidden(remat=True)`` recomputes each
layer in the backward (``torch.utils.checkpoint``), keeping what
``REPRO_REMAT_POLICY`` says.

Multi-LoRA: the paged functions read ``batch.get("lora")`` (the engine's
adapter descriptor, ``repro_torch.models.lora``) and
``batch.get("lora_block_out")``; when the descriptor is absent no LoRA code
runs at all.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import lora as lora_mod
from repro_torch.models.layers import (
    apply_mlp, embed_tokens, init_embed, init_mlp, logits_from_hidden,
    rms_norm, softmax_cross_entropy,
)
from repro_torch.perf import perf


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; this slice serves the "
            "dense family (see ROADMAP.md)")


def init_layer(cfg: ModelConfig, gen, dtype, device) -> Dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    return {"ln1": ones(), "ln2": ones(),
            "attn": attn.init_attention(cfg, gen, dtype, device),
            "mlp": init_mlp(cfg, gen, cfg.d_ff, dtype, device)}


def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (default cuda)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": init_embed(cfg, gen, dtype, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "layers": [init_layer(cfg, gen, dtype, dev)
                   for _ in range(cfg.n_layers)],
    }


def _block(cfg: ModelConfig, lp, x: torch.Tensor, attend,
           lora: Optional[Dict] = None) -> torch.Tensor:
    """One pre-norm layer: ``attend`` maps the normed input to the
    attention output (it owns the cache update); ``lora`` is the layer's
    adapter descriptor for the MLP, or None."""
    h = x + attend(rms_norm(x, lp["ln1"], cfg.norm_eps))
    return h + apply_mlp(cfg, lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                         lora=lora)


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(cfg, params["embed"], h)


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, lp, x: torch.Tensor, positions: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    return _block(cfg, lp, x, lambda xn: attn.attention_block(
        cfg, lp["attn"], xn, positions, causal=True, impl=impl))


# the products a "dots" rematerialisation keeps: matrix products without
# batch dims (the reference's ``dots_with_no_batch_dims_saveable``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_context_fn():
    """``checkpoint``'s context_fn for REPRO_REMAT_POLICY: "dots" (the
    default) keeps the ``_SAVED_DOTS`` outputs and recomputes the rest;
    "nothing" runs everything in the layer again."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts,
                                        noop_context_fn)
    if perf().remat_policy == "nothing":
        return noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return lambda: create_selective_checkpoint_contexts(policy)


def forward_hidden(cfg: ModelConfig, params, embeds: torch.Tensor,
                   positions: torch.Tensor, remat: bool = False,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeds (B,S,d) -> (final-normed hidden (B,S,d), moe_aux scalar; 0 for
    the dense family).  ``remat`` recomputes each layer in the backward."""
    _require_dense(cfg)
    x = embeds
    context_fn = _remat_context_fn() if remat else None
    for lp in params["layers"]:
        if remat:
            x = checkpoint(_layer_fwd, cfg, lp, x, positions, impl,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = _layer_fwd(cfg, lp, x, positions, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(cfg: ModelConfig, params, batch: Dict, remat: bool = True
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,S),
    every attention through the flash-attention kernel."""
    if "embeds" in batch:
        raise NotImplementedError(
            "the VLM stub frontend's loss is not ported yet (ROADMAP A11)")
    tokens = batch["tokens"]
    b, s = tokens.shape
    embeds = embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
    h, aux = forward_hidden(cfg, params, embeds, positions, remat=remat,
                            impl="kernel")
    logits = logits_from_hidden(cfg, params["embed"], h)
    return softmax_cross_entropy(logits, batch["labels"]) + 0.01 * aux


# ---------------------------------------------------------------------------
# Dense oracle: full prefill + decode over a (L, B, Smax, KV, hd) cache
# ---------------------------------------------------------------------------

def lm_prefill(cfg: ModelConfig, params, batch: Dict
               ) -> Tuple[Dict, torch.Tensor]:
    """batch {"tokens" (B,S)} -> (cache of capacity S, last-position logits
    (B,V))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    ks, vs = [], []

    def attend(lp):
        def f(xn):
            q, k, v = attn.qkv_project(cfg, lp["attn"], xn, positions)
            ks.append(k)
            vs.append(v)
            o = attn.multi_head_attention(q, k, v, causal=True)
            return o.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"]
        return f

    for lp in params["layers"]:
        x = _block(cfg, lp, x, attend(lp))
    logits = _head(cfg, params, x[:, -1:, :])[:, 0, :]
    return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits


def make_decode_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype,
                      device=None) -> Dict:
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype, device=None) -> Dict:
    """Block-pool KV cache shared by all in-flight requests; block 0 is the
    null block (see ``repro_torch.serve.paged_cache``)."""
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def lm_decode_step(cfg: ModelConfig, params, cache: Dict, batch: Dict
                   ) -> Tuple[Dict, torch.Tensor]:
    """One decode step.  batch {"token" (B,1), "cur_len" int}: the new
    token's K/V are written at cur_len (in place); returns its logits (B,V)."""
    cur_len = int(batch["cur_len"])
    token = batch["token"]
    x = embed_tokens(params["embed"], token)
    positions = torch.full((token.shape[0], 1), cur_len, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params["layers"]):
        def attend(xn, lp=lp, i=i):
            o, _, _ = attn.attention_decode_block(
                cfg, lp["attn"], xn, cache["k"][i], cache["v"][i], cur_len,
                positions)
            return o
        x = _block(cfg, lp, x, attend)
    return cache, _head(cfg, params, x)[:, 0, :]


# ---------------------------------------------------------------------------
# Paged serving: block-table-aware chunked prefill + decode
# ---------------------------------------------------------------------------

def paged_block_copy(cache: Dict, src, dst) -> Dict:
    """Device-side copy of one KV block across all layers, in place: the
    copy-on-write data plane of ``repro_torch.serve.kv_store``."""
    for v in cache.values():
        v[:, int(dst)] = v[:, int(src)]
    return cache


def paged_block_read(cache: Dict, idx) -> Dict:
    """Block ``idx`` -> host tensors {(k|v): (L, bs, KV, hd)}, pinned when
    the cache lives on a CUDA device (the device->host half of a swap)."""
    out = {}
    for k, v in cache.items():
        blk = v[:, int(idx)]
        host = torch.empty(blk.shape, dtype=blk.dtype,
                           pin_memory=blk.is_cuda)
        host.copy_(blk)
        out[k] = host
    return out


def paged_block_write(cache: Dict, idx, data: Dict) -> Dict:
    """Host block -> device block ``idx`` in place (the swap-in half)."""
    for k, v in cache.items():
        v[:, int(idx)].copy_(torch.as_tensor(data[k]).to(v.dtype))
    return cache


def lm_decode_step_paged(cfg: ModelConfig, params, cache: Dict, batch: Dict):
    """One decode step over a paged cache.  batch {"token" (B,1),
    "block_tables" (B,M) int32, "seq_lens" (B,) int32, optionally
    "pages_per_fetch" (the kernel plan's, default 1), "lora" (per-row
    adapter slots, -1 for base rows, and the slabs) and "lora_block_out"
    (the plan's expand tile, default 256)}: every row sits at its own
    position.  Returns (cache, logits (B,V)); the cache is updated in
    place."""
    seq_lens = batch["seq_lens"].to(torch.int32)
    ppf = int(batch.get("pages_per_fetch", 1))
    tables = batch["block_tables"].to(torch.int32)
    lora = batch.get("lora")
    block_out = int(batch.get("lora_block_out", 256))
    x = embed_tokens(params["embed"], batch["token"])
    for i, lp in enumerate(params["layers"]):
        ll = lora_mod.layer_slice(lora, i, block_out)

        def attend(xn, lp=lp, i=i, ll=ll):
            o, _, _ = attn.attention_decode_block_paged(
                cfg, lp["attn"], xn, cache["k"][i], cache["v"][i], tables,
                seq_lens, pages_per_fetch=ppf, lora=ll)
            return o
        x = _block(cfg, lp, x, attend, lora=ll)
    return cache, _head(cfg, params, x)[:, 0, :]


def lm_prefill_chunk(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                     m_used: Optional[int] = None):
    """One prompt chunk of a single request into the paged cache.

    batch {"tokens" (1,C) (null-padded past the prompt), "block_table"
    (1,M), "start" — absolute position of the chunk's first token,
    "prompt_len" — the chunk's write limit, optionally "pages_per_fetch",
    "lora" (a one-element ids row, broadcast over the chunk) and
    "lora_block_out"}.  ``m_used`` restricts attention to the table's first
    blocks.  Returns (cache, logits (1,C,V)); the cache is updated in
    place."""
    start = int(batch["start"])
    table = batch["block_table"].to(torch.int32)
    tokens = batch["tokens"]
    c = tokens.shape[1]
    chunk_pos = torch.arange(start, start + c, dtype=torch.int32,
                             device=tokens.device)
    prompt_len = int(batch["prompt_len"])
    ppf = int(batch.get("pages_per_fetch", 1))
    lora = batch.get("lora")
    block_out = int(batch.get("lora_block_out", 256))
    x = embed_tokens(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        ll = lora_mod.layer_slice(lora, i, block_out)

        def attend(xn, lp=lp, i=i, ll=ll):
            o, _, _ = attn.attention_prefill_chunk_block(
                cfg, lp["attn"], xn, cache["k"][i], cache["v"][i], table,
                chunk_pos, prompt_len, m_used=m_used, pages_per_fetch=ppf,
                lora=ll)
            return o
        x = _block(cfg, lp, x, attend, lora=ll)
    return cache, _head(cfg, params, x)
