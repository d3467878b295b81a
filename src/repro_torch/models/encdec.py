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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, embed_tokens, init_embed, init_mlp, logits_from_hidden,
    rms_norm, sinusoidal_positions, softmax_cross_entropy,
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
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = [_init_enc_layer(cfg, gen, dtype, dev)
           for _ in range(cfg.encdec.n_enc_layers)]
    dec = [_init_dec_layer(cfg, gen, dtype, dev) for _ in range(cfg.n_layers)]
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=dev)  # noqa: E731
    return {"embed": init_embed(cfg, gen, dtype, dev), "enc_norm": ones(),
            "final_norm": ones(), "enc_layers": enc, "dec_layers": dec}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def encode(cfg: ModelConfig, params, frames: torch.Tensor, remat: bool = False
           ) -> torch.Tensor:
    """frames (B,S,d) stub embeddings -> encoder output (B,S,d) in the
    parameters' dtype (the frames are cast to it first)."""
    x = frames.to(params["enc_norm"].dtype)
    b, s, d = x.shape
    x = x + sinusoidal_positions(s, d, x.device).to(x.dtype)[None]
    positions = _positions(b, s, x.device)

    def layer(lp, x):
        h = x + attn.attention_block(
            cfg, lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
            causal=False, impl="kernel")
        return h + apply_mlp(cfg, lp["mlp"],
                             rms_norm(h, lp["ln2"], cfg.norm_eps))

    x = run_blocks(layer, params["enc_layers"], x, remat)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_kv(cfg: ModelConfig, p, enc_out: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K/V (B,S_enc,KV,hd) from the encoder output."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    return ((enc_out @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd),
            (enc_out @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd))


def _dec_layer(cfg: ModelConfig, lp, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor, kv: Optional[list] = None
               ) -> torch.Tensor:
    """One decoder layer over the whole sequence: causal self-attention,
    cross-attention (queries from the decoder, K/V from ``enc_out``, no
    mask), MLP.  ``kv``, when given, receives the layer's (k, v, xk, xv)
    for a decode cache."""
    b, s = x.shape[:2]
    q, k, v = attn.qkv_project(cfg, lp["self_attn"],
                               rms_norm(x, lp["ln1"], cfg.norm_eps), positions)
    o = attn.multi_head_attention(q, k, v, causal=True, impl="kernel")
    h = x + o.reshape(b, s, cfg.q_dim) @ lp["self_attn"]["wo"]
    # the reference projects the decoder's k and v here too and drops them
    q, _, _ = attn.qkv_project(cfg, lp["cross_attn"],
                               rms_norm(h, lp["ln_x"], cfg.norm_eps),
                               positions)
    xk, xv = _enc_kv(cfg, lp["cross_attn"], enc_out)
    o = attn.multi_head_attention(q, xk, xv, causal=False, impl="kernel")
    h = h + o.reshape(b, s, cfg.q_dim) @ lp["cross_attn"]["wo"]
    if kv is not None:
        kv.append((k, v, xk, xv))
    return h + apply_mlp(cfg, lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps))


def _decoder_input(cfg: ModelConfig, params, tokens: torch.Tensor):
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)[None]
    return x, _positions(b, s, x.device)


def encdec_loss(cfg: ModelConfig, params, batch: Dict, remat: bool = True
                ) -> torch.Tensor:
    """Mean next-token cross-entropy of batch {"frames" (B,S_enc,d),
    "tokens", "labels" (B,S)}; with ``remat`` each encoder and decoder
    layer runs again in the backward."""
    enc_out = encode(cfg, params, batch["frames"], remat)
    x, positions = _decoder_input(cfg, params, batch["tokens"])
    x = run_blocks(lambda lp, x, e: _dec_layer(cfg, lp, x, e, positions),
                   params["dec_layers"], x, remat, enc_out)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return softmax_cross_entropy(
        logits_from_hidden(cfg, params["embed"], h), batch["labels"])


def encdec_prefill(cfg: ModelConfig, params, batch: Dict
                   ) -> Tuple[Dict, torch.Tensor]:
    """Encode the frames and prefill the decoder: batch {"frames", "tokens"
    (B,S)} -> (cache of capacity S for the self-attention and S_enc for the
    cross-attention, last-position logits (B,V))."""
    enc_out = encode(cfg, params, batch["frames"])
    x, positions = _decoder_input(cfg, params, batch["tokens"])
    kv: list = []
    for lp in params["dec_layers"]:
        x = _dec_layer(cfg, lp, x, enc_out, positions, kv=kv)
    h = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params["embed"], h)[:, 0, :]
    cache = {name: torch.stack([layer[i] for layer in kv])
             for i, name in enumerate(("k", "v", "xk", "xv"))}
    cache["enc_len"] = torch.tensor(enc_out.shape[1], dtype=torch.int32,
                                    device=enc_out.device)
    return cache, logits


def make_encdec_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype,
                      device=None) -> Dict:
    """An empty decode cache of capacity ``max_len`` for the decoder's
    tokens and for the encoder's frames alike."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    cache = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k in ("k", "v", "xk", "xv")}
    cache["enc_len"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def encdec_decode_step(cfg: ModelConfig, params, cache: Dict, batch: Dict
                       ) -> Tuple[Dict, torch.Tensor]:
    """One decode step.  batch {"token" (B,1), "cur_len" int}: the token's
    self-attention K/V are written at cur_len (in place), its
    cross-attention reads the first ``cache["enc_len"]`` frames; returns
    (cache, logits (B,V))."""
    cur_len = int(batch["cur_len"])
    x = embed_tokens(params["embed"], batch["token"])
    b = x.shape[0]
    table = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.device)
    x = x + table[cur_len:cur_len + 1][None].to(x.dtype)
    positions = torch.full((b, 1), cur_len, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params["dec_layers"]):
        o, _, _ = attn.attention_decode_block(
            cfg, lp["self_attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], cur_len, positions)
        h = x + o
        q, _, _ = attn.qkv_project(cfg, lp["cross_attn"],
                                   rms_norm(h, lp["ln_x"], cfg.norm_eps),
                                   positions)
        # masked to the true encoder length: the cache may be padded
        o = attn.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                  cache["enc_len"])
        h = h + o.reshape(b, 1, cfg.q_dim) @ lp["cross_attn"]["wo"]
        x = h + apply_mlp(cfg, lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cache, logits_from_hidden(cfg, params["embed"], h)[:, 0, :]
