"""Whisper-style encoder-decoder (mirrors ``src/repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the reference: the input is
precomputed frame embeddings (B, S_audio, d_model), cast to the parameters'
dtype at entry (``encode``).  Encoder: bidirectional attention blocks;
decoder: causal self-attention, cross-attention over the encoder output,
MLP.  Both add sinusoidal positions to their input (whisper-small has no
RoPE).  ``params["enc_layers"]`` and ``params["dec_layers"]`` are lists of
per-layer dicts in forward order, where the reference stacks and scans
them; ``run_blocks`` rematerialises each layer in the loss.

Every full-sequence attention (the encoder's, the decoder's causal
self-attention and its cross-attention, Sq tokens over Skv frames) runs
through the flash-attention kernel (``impl="kernel"``), in the loss and in
the prefill; a decode step attends its one token in plain PyTorch
(``decode_attention``, as the reference computes it).  The decode cache is
``{"k", "v", "xk", "xv": (L, B, Smax, KV, hd), "enc_len"}``: self-attention
K/V written in place at ``cur_len``, the encoder's K/V per layer, and the
true encoder length, to which the cross-attention is masked when the cache
is padded.

Training on a mesh: ``encdec_loss`` takes the step's ``shard`` (a
``repro_torch.distributed.sharding.TrainShard``), the frames and tokens
split on the batch.  Every attention and MLP, the encoder's and the
decoder's, uses the dense path's tensor parallelism (the rank's query and
kv heads, column- and row-parallel MLP); the cross-attention's K/V are
projected column-parallel on the kv heads from the encoder output, which
is replicated over "model" and enters each layer's projections through
its own *f* (``_enc_in``).  A layer's FSDP shards are gathered in one
bucket at its entry (REPRO_WEIGHT_AG=0) or each at its use (=1), the
embedding's once a step; a vocabulary that does not divide over "model"
(whisper's 51,865) leaves the embedding and the logits whole there.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed.param_sharding import tp_linear, tp_whole
from repro_torch.distributed.sharding import (attention_shard, gather_layer,
                                              in_tp, kv_held, resolve,
                                              to_cache_block, weight_use)
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, embed_tokens, generator, init_embed, init_mlp,
    lm_head_loss, logits_from_hidden, rms_norm, sinusoidal_positions,
)
from repro_torch.models.transformer import run_blocks


def _init_enc_layer(cfg: ModelConfig, gen, dtype, device) -> Dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    return {"ln1": ones(), "ln2": ones(),
            "attn": attn.init_attention(cfg, gen, dtype, device),
            "mlp": init_mlp(cfg, gen, cfg.d_ff, dtype, device)}


def _init_dec_layer(cfg: ModelConfig, gen, dtype, device) -> Dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    return {"ln1": ones(), "ln_x": ones(), "ln2": ones(),
            "self_attn": attn.init_attention(cfg, gen, dtype, device),
            "cross_attn": attn.init_attention(cfg, gen, dtype, device),
            "mlp": init_mlp(cfg, gen, cfg.d_ff, dtype, device)}


def init_encdec(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    on ``device`` (default cuda): the encoder's layers, the decoder's, then
    the embedding, as the reference splits its key."""
    dev = resolve_device(device, allow_meta=True)
    dtype = torch_dtype(cfg)
    gen = generator(seed, dev)
    enc = [_init_enc_layer(cfg, gen, dtype, dev)
           for _ in range(cfg.encdec.n_enc_layers)]
    dec = [_init_dec_layer(cfg, gen, dtype, dev) for _ in range(cfg.n_layers)]
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=dev)  # noqa: E731
    return {"embed": init_embed(cfg, gen, dtype, dev), "enc_norm": ones(),
            "final_norm": ones(), "enc_layers": enc, "dec_layers": dec}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _norm(cfg: ModelConfig, x: torch.Tensor, w, shard) -> torch.Tensor:
    return rms_norm(x, weight_use(w, None, shard=shard), cfg.norm_eps)


def _bucket(lp, shard):
    """A layer's weights with their FSDP shards gathered in one bucket
    (REPRO_WEIGHT_AG=0 on a mesh), else as they are."""
    if shard is not None and not shard.per_use:
        return gather_layer(lp, shard)
    return lp


def encode(cfg: ModelConfig, params, frames: torch.Tensor, remat: bool = False,
           shard=None) -> torch.Tensor:
    """frames (B,S,d) stub embeddings -> encoder output (B,S,d) in the
    parameters' dtype (the frames are cast to it first); ``shard`` a
    training step's on a mesh."""
    x = frames.to(params["enc_norm"].dtype)
    b, s, d = x.shape
    x = x + sinusoidal_positions(s, d, x.device).to(x.dtype)[None]
    positions = _positions(b, s, x.device)

    def layer(lp, x):
        lp = _bucket(lp, shard)
        h = x + attn.attention_block(
            cfg, lp["attn"], _norm(cfg, x, lp["ln1"], shard), positions,
            causal=False, impl="kernel", shard=shard)
        return h + apply_mlp(cfg, lp["mlp"], _norm(cfg, h, lp["ln2"], shard),
                             shard=shard)

    x = run_blocks(layer, params["enc_layers"], x, remat)
    return _norm(cfg, x, params["enc_norm"], shard)


def _enc_in(enc_out: torch.Tensor, shard) -> torch.Tensor:
    """The encoder output where a decoder layer's cross-attention reads
    it, one node a layer whose cotangent sums both projections' before it
    reaches ``enc_out`` (so one device and a 1x1 mesh add them in one
    order).  On a mesh's tensor parallelism ``enc_out`` is replicated over
    "model" and read by each rank's own kv heads, so this is *f*, summing
    the cotangent over the model ranks (without it the encoder's gradients
    are one rank's share)."""
    if in_tp(shard):
        return col.copy_to(enc_out, shard.mesh, "model")
    return enc_out.view_as(enc_out)


def _enc_kv(cfg: ModelConfig, p, enc_out: torch.Tensor, shard=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K/V (B,S_enc,KV,hd) from the encoder output
    (the rank's KV/n heads on a mesh's tensor parallelism: column-parallel
    projections of ``_enc_in``'s output)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    e = _enc_in(enc_out, shard)
    out = []
    for w in (p["wk"], p["wv"]):
        if in_tp(shard):
            t, j = resolve(w, shard, keep_model=True)
            assert j == 1, "the cross-attention's kv heads not split on model"
            y = e @ t
        else:
            y = tp_linear(e, w, shard)[0]
        out.append(y.reshape(b, s, -1, hd))
    return out[0], out[1]


def _attn_out(cfg: ModelConfig, p, o: torch.Tensor, shard) -> torch.Tensor:
    """o (B,S,H,hd) through ``wo`` (row-parallel over the rank's heads on
    a mesh), whole on its last dim."""
    b, s = o.shape[:2]
    out, local = tp_linear(o.reshape(b, s, -1), p["wo"], shard,
                           x_local=o.shape[2] < cfg.n_heads)
    return tp_whole(out, local, shard)


def _dec_layer(cfg: ModelConfig, lp, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor, kv: Optional[list] = None,
               shard=None) -> torch.Tensor:
    """One decoder layer over the whole sequence: causal self-attention,
    cross-attention (queries from the decoder, K/V from ``enc_out``, no
    mask), MLP.  ``kv``, when given, receives the layer's (k, v, xk, xv)
    for a decode cache; ``shard`` is a training step's on a mesh."""
    lp = _bucket(lp, shard)
    # the attention's own shard: whole on every model rank where the heads
    # do not split
    ashard = attention_shard(cfg, shard)
    q, k, v = attn.qkv_project(cfg, lp["self_attn"],
                               _norm(cfg, x, lp["ln1"], shard), positions,
                               shard=ashard)
    o = attn.multi_head_attention(q, k, v, causal=True, impl="kernel")
    h = x + _attn_out(cfg, lp["self_attn"], o, ashard)
    # the reference projects the decoder's k and v here too and drops them
    q, _, _ = attn.qkv_project(cfg, lp["cross_attn"],
                               _norm(cfg, h, lp["ln_x"], shard), positions,
                               shard=ashard)
    xk, xv = _enc_kv(cfg, lp["cross_attn"], enc_out, ashard)
    o = attn.multi_head_attention(q, xk, xv, causal=False, impl="kernel")
    h = h + _attn_out(cfg, lp["cross_attn"], o, ashard)
    if kv is not None:
        kv.append((k, v, xk, xv))
    return h + apply_mlp(cfg, lp["mlp"], _norm(cfg, h, lp["ln2"], shard),
                         shard=shard)


def _decoder_input(cfg: ModelConfig, params, tokens: torch.Tensor,
                   shard=None):
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens, shard)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)[None]
    return x, _positions(b, s, x.device)


def encdec_loss(cfg: ModelConfig, params, batch: Dict, remat: bool = True,
                shard=None) -> torch.Tensor:
    """Mean next-token cross-entropy of batch {"frames" (B,S_enc,d),
    "tokens", "labels" (B,S)}; with ``remat`` each encoder and decoder
    layer runs again in the backward; on a mesh (``shard``) the mean over
    this rank's rows, the cross-entropy vocab-parallel where the head
    splits over "model" (``layers.lm_head_loss``)."""
    params = {**params, "embed": gather_layer(params["embed"], shard)}
    enc_out = encode(cfg, params, batch["frames"], remat, shard)
    x, positions = _decoder_input(cfg, params, batch["tokens"], shard)
    x = run_blocks(lambda lp, x, e: _dec_layer(cfg, lp, x, e, positions,
                                               shard=shard),
                   params["dec_layers"], x, remat, enc_out)
    h = _norm(cfg, x, params["final_norm"], shard)
    return lm_head_loss(cfg, params["embed"], h, batch["labels"], shard)


def encdec_prefill(cfg: ModelConfig, params, batch: Dict, shard=None
                   ) -> Tuple[Dict, torch.Tensor]:
    """Encode the frames and prefill the decoder: batch {"frames", "tokens"
    (B,S)} -> (cache of capacity S for the self-attention and S_enc for the
    cross-attention, last-position logits (B,V)).  ``shard``: a prefill
    step's on a training mesh: the rank's batch rows and heads as
    ``encdec_loss`` computes them (whisper's 12 heads whole on every rank
    of a 16-way model axis), the four K/V leaves the rank's blocks of
    their ``cache_specs`` layout."""
    if shard is not None:
        params = {**params, "embed": gather_layer(params["embed"], shard)}
    enc_out = encode(cfg, params, batch["frames"], shard=shard)
    x, positions = _decoder_input(cfg, params, batch["tokens"], shard)
    kv: list = []
    for lp in params["dec_layers"]:
        x = _dec_layer(cfg, lp, x, enc_out, positions, kv=kv, shard=shard)
    h = _norm(cfg, x[:, -1:, :], params["final_norm"], shard)
    logits = logits_from_hidden(cfg, params["embed"], h, shard)[:, 0, :]
    if shard is not None:
        held = kv_held(cfg, shard)
        kv = [[to_cache_block(t, held, cfg.n_kv_heads, shard) for t in layer]
              for layer in kv]
    cache = {name: torch.stack([layer[i] for layer in kv])
             for i, name in enumerate(("k", "v", "xk", "xv"))}
    cache["enc_len"] = torch.tensor(enc_out.shape[1], dtype=torch.int32,
                                    device=enc_out.device)
    return cache, logits


def make_encdec_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype,
                      device=None) -> Dict:
    """An empty decode cache of capacity ``max_len`` for the decoder's
    tokens and for the encoder's frames alike."""
    dev = resolve_device(device, allow_meta=True)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    cache = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k in ("k", "v", "xk", "xv")}
    cache["enc_len"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def encdec_decode_step(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                       shard=None) -> Tuple[Dict, torch.Tensor]:
    """One decode step.  batch {"token" (B,1), "cur_len" int}: the token's
    self-attention K/V are written at cur_len (in place), its
    cross-attention reads the first ``cache["enc_len"]`` frames; returns
    (cache, logits (B,V)).  ``shard``: a decode step's on a training mesh:
    each decoder layer's weights gathered as ``encdec_loss`` gathers them,
    the four K/V leaves the rank's blocks, the self-attention through
    ``attention.attention_decode_block`` and the cross-attention's query
    (the rank's heads) through ``attention.mesh_decode_attention``."""
    cur_len = int(batch["cur_len"])
    if shard is not None:
        params = {**params, "embed": gather_layer(params["embed"], shard)}
    x = embed_tokens(params["embed"], batch["token"], shard)
    b = x.shape[0]
    # row cur_len of the table (its rows do not depend on its length)
    table = sinusoidal_positions(cur_len + 1, cfg.d_model, x.device)
    x = x + table[cur_len:cur_len + 1][None].to(x.dtype)
    positions = torch.full((b, 1), cur_len, dtype=torch.int32,
                           device=x.device)
    ashard = attention_shard(cfg, shard)
    for i, lp in enumerate(params["dec_layers"]):
        lp = _bucket(lp, shard)
        o, _, _ = attn.attention_decode_block(
            cfg, lp["self_attn"], _norm(cfg, x, lp["ln1"], shard),
            cache["k"][i], cache["v"][i], cur_len, positions, shard=shard,
            spec=None if shard is None else shard.cache["k"])
        h = x + o
        q, _, _ = attn.qkv_project(cfg, lp["cross_attn"],
                                   _norm(cfg, h, lp["ln_x"], shard),
                                   positions, shard=ashard)
        # masked to the true encoder length: the cache may be padded
        if shard is None:
            o = attn.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                      cache["enc_len"])
        else:
            o = attn.mesh_decode_attention(cfg, q, cache["xk"][i],
                                           cache["xv"][i], cache["enc_len"],
                                           shard, shard.cache["xk"])
        h = h + attn.decode_out(cfg, lp["cross_attn"], o, ashard)
        x = h + apply_mlp(cfg, lp["mlp"], _norm(cfg, h, lp["ln2"], shard),
                          shard=shard)
    h = _norm(cfg, x, params["final_norm"], shard)
    return cache, logits_from_hidden(cfg, params["embed"], h, shard)[:, 0, :]
