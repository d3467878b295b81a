"""Decoder-only transformer, dense, moe and vlm families (mirrors
``src/repro/models/transformer.py``).

The JAX package stacks layer weights and ``lax.scan``s over them; here
``params["layers"]`` is a list of per-layer dicts in forward order and the
scan is a Python loop.  An MoE arch with ``moe.every = k`` repeats
super-layers of k layers whose last is MoE and the rest dense (width
``moe.d_ff_dense``); ``every = 1`` makes every layer MoE.  Caches keep the
JAX layouts so they cross the bridge unchanged: the dense cache is
``(L, B, Smax, KV, hd)`` and the paged cache ``(L, N, bs, KV, hd)``, both
slot-major: the layer at forward position ``l = i*every + j`` (super-layer
i, kind j) uses cache row ``j*(L/every) + i`` (``cache_row``), which is row
``l`` when ``every`` is 1.  Every cache update is in place.

An MoE layer routes each token in f32 (``models/moe.py``): prefill, chunks
and the loss dispatch with a capacity (``apply_moe``), a decode step runs
what REPRO_MOE_DECODE names; ``forward_hidden`` returns the layers' summed
load-balance loss, which ``lm_loss`` adds at 0.01.  Expert capacity is
computed per call, so a chunked prefill can route or drop tokens
differently from one whole-prompt prefill of the same prompt (as in the
reference); dense archs are exact.

Training: ``lm_loss`` runs every layer's attention through the
flash-attention kernel (``impl="kernel"``), forward and backward, and every
norm through ``RMSNormFn``; ``forward_hidden(remat=True)`` recomputes each
layer in the backward (``torch.utils.checkpoint``), keeping what
``REPRO_REMAT_POLICY`` says.

The vlm family is a dense transformer behind a stub frontend: ``lm_loss``,
``lm_prefill`` and ``lm_decode_step`` take precomputed "embeds" (B,S,d)
with M-RoPE "positions" (3,B,S) in place of tokens, the embeds cast to the
parameters' dtype at entry (``_stub_embeds``).  The paged functions take
tokens only, and the serve engine refuses the vlm family, as the
reference's does.

Multi-LoRA: the paged functions read ``batch.get("lora")`` (the engine's
adapter descriptor, ``repro_torch.models.lora``, whose slab rows are in
forward order) and ``batch.get("lora_block_out")``; when the descriptor is
absent no LoRA code runs at all.  An MoE layer's FFN takes no LoRA.

Multi-device serving: ``make_paged_cache(n_model=n)`` gives a rank of an
n-rank serve mesh its own pool of KV/n heads, and the paged functions take
the engine's ``shard`` (``repro_torch.distributed.param_sharding.
ServeShard``), an explicit argument and never module state, which reaches
every weight use and the attention's head split.  A dense arch only: the
engine refuses the other families on a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import lora as lora_mod
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_mlp, embed_tokens, init_embed, init_mlp, logits_from_hidden,
    rms_norm, softmax_cross_entropy,
)
from repro_torch.perf import perf


def _every(cfg: ModelConfig) -> int:
    return cfg.moe.every if cfg.moe else 1


def _layer_kind(cfg: ModelConfig, layer_idx_in_super: int) -> str:
    if cfg.moe is None:
        return "dense"
    # every=k: the last layer of the super-layer is MoE, the rest dense
    return "moe" if layer_idx_in_super == cfg.moe.every - 1 else "dense"


def cache_row(cfg: ModelConfig, layer: int) -> int:
    """The cache row of the layer at forward position ``layer``: caches are
    slot-major, kind j's super-layers first, as the reference's
    ``lm_prefill`` stacks them."""
    every = _every(cfg)
    i, j = divmod(layer, every)
    return j * (cfg.n_layers // every) + i


def init_layer(cfg: ModelConfig, gen, kind: str, dtype, device) -> Dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    p = {"ln1": ones(), "ln2": ones(),
         "attn": attn.init_attention(cfg, gen, dtype, device)}
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(cfg, gen, dtype, device)
    else:
        d_ff = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense) \
            else cfg.d_ff
        p["mlp"] = init_mlp(cfg, gen, d_ff, dtype, device)
    return p


def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (default cuda), layer by layer in forward order."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    every = _every(cfg)
    return {
        "embed": init_embed(cfg, gen, dtype, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "layers": [init_layer(cfg, gen, _layer_kind(cfg, i % every), dtype,
                              dev)
                   for i in range(cfg.n_layers)],
    }


def _ffn(cfg: ModelConfig, lp, h: torch.Tensor, decode: bool,
         lora: Optional[Dict] = None, shard=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN: (y, its load-balance loss, or None for a dense
    FFN).  MoE experts are routed per token, so an MoE FFN takes no LoRA
    (the adapter store adapts attention only for MoE archs); both kinds
    take a sharded engine's ``shard``."""
    if "moe" in lp:
        if decode:
            fn = moe_lib.apply_moe_decode_dispatch \
                if perf().moe_decode == "dispatch" \
                else moe_lib.apply_moe_decode
            return fn(cfg, lp["moe"], h, shard), None
        return moe_lib.apply_moe(cfg, lp["moe"], h, shard)
    return apply_mlp(cfg, lp["mlp"], h, lora=lora, shard=shard), None


def _block(cfg: ModelConfig, lp, x: torch.Tensor, attend,
           lora: Optional[Dict] = None, decode: bool = False, shard=None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-norm layer -> (output, the FFN's load-balance loss or None):
    ``attend`` maps the normed input to the attention output (it owns the
    cache update); ``lora`` is the layer's adapter descriptor for a dense
    MLP, or None; ``decode`` picks an MoE layer's decode path; ``shard`` is
    a sharded serve engine's."""
    h = x + attend(rms_norm(x, lp["ln1"], cfg.norm_eps))
    y, aux = _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), decode,
                  lora, shard)
    return h + y, aux


def _head(cfg: ModelConfig, params, x: torch.Tensor,
          shard=None) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(cfg, params["embed"], h, shard)


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, lp, x: torch.Tensor, positions: torch.Tensor,
               impl: Optional[str]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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


def run_blocks(fn, blocks, x, remat: bool, *args):
    """``x = fn(block, x, *args)`` for each of ``blocks`` in order (a layer,
    or a hybrid segment); ``x`` is a tensor or a tuple of them (a carry such
    as (hidden, aux)).  With ``remat`` each call runs again in the backward
    (``torch.utils.checkpoint``), keeping what REPRO_REMAT_POLICY says, as
    the reference wraps its scan body in ``jax.checkpoint``."""
    context_fn = _remat_context_fn() if remat else None
    for blk in blocks:
        if remat:
            x = checkpoint(fn, blk, x, *args, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = fn(blk, x, *args)
    return x


def forward_hidden(cfg: ModelConfig, params, embeds: torch.Tensor,
                   positions: torch.Tensor, remat: bool = False,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeds (B,S,d) -> (final-normed hidden (B,S,d), the MoE layers'
    summed load-balance loss, an f32 scalar; 0 for a dense arch).
    ``remat`` recomputes each layer in the backward."""
    def layer(lp, carry):
        x, aux = _layer_fwd(cfg, lp, carry[0], positions, impl)
        return x, carry[1] if aux is None else carry[1] + aux

    zero = torch.zeros((), dtype=torch.float32, device=embeds.device)
    x, aux = run_blocks(layer, params["layers"], (embeds, zero), remat)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _stub_embeds(params, batch: Dict) -> torch.Tensor:
    """The VLM stub frontend's "embeds", in the parameters' dtype: an f32
    frontend feeding a bf16 model computes in bf16 (the reference would
    promote the whole stack to f32)."""
    return batch["embeds"].to(params["embed"]["embed"].dtype)


def _inputs(params, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(embeds (B,S,d), positions): the stub frontend's embeds and M-RoPE
    streams (3,B,S), or the tokens' embeddings at positions 0..S-1."""
    if "embeds" in batch:
        return _stub_embeds(params, batch), batch["positions"]
    tokens = batch["tokens"]
    b, s = tokens.shape
    embeds = embed_tokens(params["embed"], tokens)
    return embeds, torch.arange(s, device=embeds.device)[None, :].expand(b, s)


def lm_loss(cfg: ModelConfig, params, batch: Dict, remat: bool = True
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,S)
    (or the stub frontend's {"embeds", "positions", "labels"}) plus 0.01
    times the MoE load-balance loss, every attention through the
    flash-attention kernel."""
    embeds, positions = _inputs(params, batch)
    h, aux = forward_hidden(cfg, params, embeds, positions, remat=remat,
                            impl="kernel")
    logits = logits_from_hidden(cfg, params["embed"], h)
    return softmax_cross_entropy(logits, batch["labels"]) + 0.01 * aux


# ---------------------------------------------------------------------------
# Dense oracle: full prefill + decode over a (L, B, Smax, KV, hd) cache
# ---------------------------------------------------------------------------

def lm_prefill(cfg: ModelConfig, params, batch: Dict
               ) -> Tuple[Dict, torch.Tensor]:
    """batch {"tokens" (B,S)} or {"embeds" (B,S,d), "positions" (3,B,S)}
    -> (cache of capacity S, last-position logits (B,V))."""
    x, positions = _inputs(params, batch)
    b, s = x.shape[:2]
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
        x, _ = _block(cfg, lp, x, attend(lp))
    logits = _head(cfg, params, x[:, -1:, :])[:, 0, :]
    # stack in cache-row order (slot-major)
    order = sorted(range(cfg.n_layers), key=lambda l: cache_row(cfg, l))
    return {"k": torch.stack([ks[l] for l in order]),
            "v": torch.stack([vs[l] for l in order])}, logits


def make_decode_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype,
                      device=None) -> Dict:
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype, device=None, n_model: int = 1) -> Dict:
    """Block-pool KV cache shared by all in-flight requests; block 0 is the
    null block (see ``repro_torch.serve.paged_cache``).  A rank of an
    ``n_model``-rank serve mesh holds KV/n_model heads of every block, in
    tensors of its own (contiguous, as the paged kernel requires); the
    engine has checked that n_model divides the kv heads."""
    shape = (cfg.n_layers, num_blocks, block_size,
             cfg.n_kv_heads // n_model, cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def lm_decode_step(cfg: ModelConfig, params, cache: Dict, batch: Dict
                   ) -> Tuple[Dict, torch.Tensor]:
    """One decode step.  batch {"token" (B,1), "cur_len" int} or {"embeds"
    (B,1,d), "positions" (3,B,1), "cur_len"}: the new token's K/V are
    written at cur_len (in place); returns its logits (B,V)."""
    cur_len = int(batch["cur_len"])
    if "embeds" in batch:
        x, positions = _stub_embeds(params, batch), batch["positions"]
    else:
        x = embed_tokens(params["embed"], batch["token"])
        positions = torch.full((x.shape[0], 1), cur_len, dtype=torch.int32,
                               device=x.device)
    for i, lp in enumerate(params["layers"]):
        r = cache_row(cfg, i)

        def attend(xn, lp=lp, r=r):
            o, _, _ = attn.attention_decode_block(
                cfg, lp["attn"], xn, cache["k"][r], cache["v"][r], cur_len,
                positions)
            return o
        x, _ = _block(cfg, lp, x, attend, decode=True)
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


def lm_decode_step_paged(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                         shard=None):
    """One decode step over a paged cache.  batch {"token" (B,1),
    "block_tables" (B,M) int32, "seq_lens" (B,) int32, optionally
    "pages_per_fetch" (the kernel plan's, default 1), "lora" (per-row
    adapter slots, -1 for base rows, and the slabs) and "lora_block_out"
    (the plan's expand tile, default 256)}: every row sits at its own
    position.  ``shard``: a sharded serve engine's (this rank's heads in
    ``cache``).  Returns (cache, logits (B,V)); the cache is updated in
    place."""
    seq_lens = batch["seq_lens"].to(torch.int32)
    ppf = int(batch.get("pages_per_fetch", 1))
    tables = batch["block_tables"].to(torch.int32)
    lora = batch.get("lora")
    block_out = int(batch.get("lora_block_out", 256))
    x = embed_tokens(params["embed"], batch["token"], shard)
    for i, lp in enumerate(params["layers"]):
        ll = lora_mod.layer_slice(lora, i, block_out)
        r = cache_row(cfg, i)

        def attend(xn, lp=lp, r=r, ll=ll):
            o, _, _ = attn.attention_decode_block_paged(
                cfg, lp["attn"], xn, cache["k"][r], cache["v"][r], tables,
                seq_lens, pages_per_fetch=ppf, lora=ll, shard=shard)
            return o
        x, _ = _block(cfg, lp, x, attend, lora=ll, decode=True, shard=shard)
    return cache, _head(cfg, params, x, shard)[:, 0, :]


def lm_prefill_chunk(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                     m_used: Optional[int] = None, shard=None):
    """One prompt chunk of a single request into the paged cache.

    batch {"tokens" (1,C) (null-padded past the prompt), "block_table"
    (1,M), "start" — absolute position of the chunk's first token,
    "prompt_len" — the chunk's write limit, optionally "pages_per_fetch",
    "lora" (a one-element ids row, broadcast over the chunk) and
    "lora_block_out"}.  ``m_used`` restricts attention to the table's first
    blocks; ``shard`` is a sharded serve engine's.  Returns (cache, logits
    (1,C,V)); the cache is updated in place."""
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
    x = embed_tokens(params["embed"], tokens, shard)
    for i, lp in enumerate(params["layers"]):
        ll = lora_mod.layer_slice(lora, i, block_out)
        r = cache_row(cfg, i)

        def attend(xn, lp=lp, r=r, ll=ll):
            o, _, _ = attn.attention_prefill_chunk_block(
                cfg, lp["attn"], xn, cache["k"][r], cache["v"][r], table,
                chunk_pos, prompt_len, m_used=m_used, pages_per_fetch=ppf,
                lora=ll, shard=shard)
            return o
        x, _ = _block(cfg, lp, x, attend, lora=ll, shard=shard)
    return cache, _head(cfg, params, x, shard)
