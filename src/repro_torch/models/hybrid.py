"""zamba2-style hybrid: a Mamba2 (SSD) backbone plus one weight-shared
attention block applied every ``attn_every`` layers (mirrors
``src/repro/models/hybrid.py``).

Training: ``hybrid_loss`` runs the shared block's attention through the
flash-attention kernel (``impl="kernel"``, forward and backward), every
norm, the Mamba2 gated norm among them, through ``RMSNormFn``, and the SSD
in torch einsums under autograd (the JAX package has no kernel for it);
with ``remat`` each segment runs again in the backward, as the reference
checkpoints its segment body.

Training on a mesh: ``hybrid_loss`` takes the step's ``shard`` (a
``repro_torch.distributed.sharding.TrainShard``).  Each Mamba2 layer
computes the rank's SSD heads under fsdp_tp (``mamba.mamba2_forward``);
the shared block runs the dense path's tensor parallelism (the rank's
query and kv heads, column- and row-parallel MLP), and under
REPRO_SEQ_PARALLEL=1 its MLP runs on the rank's sequence slice with its
weights gathered over "model" (the reference's ``apply_mlp`` branch; the
residual stream itself carries no sequence constraint in the hybrid).  A
segment's FSDP shards, the shared block's with them, are gathered in one
bucket at the segment's entry, inside its remat region (REPRO_WEIGHT_AG=0;
=1 gathers each at its use), so the shared weights are gathered once a
call site and autograd sums their gradient over the call sites.

``params["layers"]`` is a list of ``n_layers`` per-layer dicts
``{"ln", "mamba"}`` in forward order (segment s holds layers
``s*per .. s*per+per-1``), ``params["shared"]`` the shared block.  Caches
keep the JAX layouts: the dense one ``{"ssm": {"h": (n_seg, per, B, H, P,
N), "conv": (n_seg, per, B, K-1, di)}, "k"/"v": (n_seg, B, S, KV, hd)}``,
the paged one the same with ``B`` replaced by the slab's slot axis and the
KV by a block pool ``(n_seg, num_blocks, bs, KV, hd)``.  Every cache update
is in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain, gather_layer,
                                              weight_use)
from repro_torch.models import attention as attn
from repro_torch.models import mamba, ssm_lm, transformer
from repro_torch.models.layers import (
    apply_mlp, embed_tokens, generator, init_embed, init_mlp,
    lm_head_loss, logits_from_hidden, rms_norm,
)


def _n_segments(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every


def init_hybrid(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (default cuda)."""
    dev = resolve_device(device, allow_meta=True)
    dtype = torch_dtype(cfg)
    gen = generator(seed, dev)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=dev)  # noqa: E731
    layers = [{"ln": ones(), "mamba": mamba.init_mamba2(cfg, gen, dtype, dev)}
              for _ in range(_n_segments(cfg) * cfg.hybrid.attn_every)]
    shared = {"ln1": ones(), "ln2": ones(),
              "attn": attn.init_attention(cfg, gen, dtype, dev),
              "mlp": init_mlp(cfg, gen, cfg.hybrid.shared_d_ff or cfg.d_ff,
                              dtype, dev)}
    return {"embed": init_embed(cfg, gen, dtype, dev),
            "final_norm": ones(), "layers": layers, "shared": shared}


def _segment(cfg: ModelConfig, params, s: int):
    per = cfg.hybrid.attn_every
    return params["layers"][s * per:(s + 1) * per]


def _shared_tail(cfg: ModelConfig, shared, x: torch.Tensor, attend,
                 shard=None) -> torch.Tensor:
    """The shared block after a segment's Mamba2 layers: ``attend`` maps the
    normed input to the attention output (it owns any cache update);
    ``shard`` a training step's on a mesh."""
    def norm(t, w):
        return rms_norm(t, weight_use(w, None, shard=shard), cfg.norm_eps)
    h = x + attend(norm(x, shared["ln1"]))
    hn = norm(h, shared["ln2"])
    if shard is None or not shard.seq_parallel:
        return h + apply_mlp(cfg, shared["mlp"], hn, shard=shard)
    # sequence parallelism: the MLP on the rank's sequence slice
    part = constrain(hn, "batch", "seq_mp", None, shard=shard,
                     have=("batch", None, None))
    y = apply_mlp(cfg, shared["mlp"], part, shard=shard.seq_region())
    return h + constrain(y, "batch", None, None, shard=shard,
                         have=("batch", "seq_mp", None))


def _head(cfg: ModelConfig, params, x: torch.Tensor,
          shard=None) -> torch.Tensor:
    h = rms_norm(x, weight_use(params["final_norm"], None, shard=shard),
                 cfg.norm_eps)
    return logits_from_hidden(cfg, params["embed"], h, shard)


def _serve_segments(cfg: ModelConfig, params, shard):
    """(params with the embedding gathered, [(segment's Mamba2 layers, the
    shared block)] with a segment's FSDP shards and the shared block's
    gathered in one bucket as the train step's segment does) of a prefill
    or decode step; one device's weights as they are."""
    params, layer = transformer.serve_layers(params, shard)
    out = []
    for seg in range(_n_segments(cfg)):
        g = layer({"layers": _segment(cfg, params, seg),
                   "shared": params["shared"]})
        out.append((g["layers"], g["shared"]))
    return params, out


def _mamba2_layer(cfg: ModelConfig, lp, x: torch.Tensor, shard, state=None):
    """A Mamba2 layer's residual update and its state: the whole-sequence
    forward (``state`` None) or one decode step from ``state``."""
    xn = rms_norm(x, weight_use(lp["ln"], None, shard=shard), cfg.norm_eps)
    if state is None:
        y, st = mamba.mamba2_forward(cfg, lp["mamba"], xn, shard=shard)
    else:
        y, st = mamba.mamba2_decode_step(cfg, lp["mamba"], xn, state, shard)
    return x + y, st


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def _segment_fwd(cfg: ModelConfig, shared, seg_layers, x: torch.Tensor,
                 positions: torch.Tensor, shard=None) -> torch.Tensor:
    """One segment: its Mamba2 layers, then the shared block with its
    attention on the flash-attention kernel; ``shard`` a training step's
    on a mesh (the segment's and the shared block's FSDP shards gathered
    in one bucket here, unless REPRO_WEIGHT_AG=1)."""
    if shard is not None and not shard.per_use:
        g = gather_layer({"layers": seg_layers, "shared": shared}, shard)
        seg_layers, shared = g["layers"], g["shared"]
    for lp in seg_layers:
        ln = weight_use(lp["ln"], None, shard=shard)
        y, _ = mamba.mamba2_forward(cfg, lp["mamba"],
                                    rms_norm(x, ln, cfg.norm_eps),
                                    shard=shard)
        x = x + y
    return _shared_tail(cfg, shared, x, lambda xn: attn.attention_block(
        cfg, shared["attn"], xn, positions, causal=True, impl="kernel",
        shard=shard), shard)


def _fwd(cfg: ModelConfig, params, embeds: torch.Tensor, remat: bool,
         shard=None) -> torch.Tensor:
    """embeds (B,S,d) -> final-normed hidden (B,S,d); ``remat`` recomputes
    each segment in the backward."""
    b, s = embeds.shape[:2]
    positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
    segments = [_segment(cfg, params, i) for i in range(_n_segments(cfg))]
    x = transformer.run_blocks(
        lambda seg, x: _segment_fwd(cfg, params["shared"], seg, x, positions,
                                    shard),
        segments, embeds, remat)
    return rms_norm(x, weight_use(params["final_norm"], None, shard=shard),
                    cfg.norm_eps)


def hybrid_loss(cfg: ModelConfig, params, batch: Dict, remat: bool = True,
                shard=None) -> torch.Tensor:
    """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,S);
    on a mesh (``shard``) the mean over this rank's rows, the embedding's
    "data" shards gathered once for the lookup and the head, the
    cross-entropy vocab-parallel where the head splits over "model"
    (``layers.lm_head_loss``)."""
    params = {**params, "embed": gather_layer(params["embed"], shard)}
    h = _fwd(cfg, params,
             embed_tokens(params["embed"], batch["tokens"], shard), remat,
             shard)
    return lm_head_loss(cfg, params["embed"], h, batch["labels"], shard)


# ---------------------------------------------------------------------------
# Dense oracle
# ---------------------------------------------------------------------------

def hybrid_prefill(cfg: ModelConfig, params, batch: Dict, shard=None):
    """batch {"tokens" (B,S)} -> (cache of capacity S, last-position logits
    (B,V)): the Mamba2 states and the shared block's K/V of every
    segment.  ``shard``: a prefill step's on a training mesh: the rank's
    batch rows, SSD heads and attention heads, the cache its block of the
    ``cache_specs`` layout."""
    params, segments = _serve_segments(cfg, params, shard)
    x = embed_tokens(params["embed"], batch["tokens"], shard)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    hs, convs, kvs = [], [], []
    for seg_layers, shared in segments:
        seg_h, seg_conv = [], []
        for lp in seg_layers:
            x, st = _mamba2_layer(cfg, lp, x, shard)
            seg_h.append(st["h"])
            seg_conv.append(st["conv"])
        hs.append(torch.stack(seg_h))
        convs.append(torch.stack(seg_conv))
        x = _shared_tail(cfg, shared, x, lambda xn: attn.attention_block(
            cfg, shared["attn"], xn, positions, shard=shard, kv=kvs), shard)
    logits = _head(cfg, params, x[:, -1:, :], shard)[:, 0, :]
    ks, vs = transformer.cache_blocks(cfg, kvs, shard)
    cache = {"ssm": {"h": torch.stack(hs), "conv": torch.stack(convs)},
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return cache, logits


def make_hybrid_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                      dtype, device=None) -> Dict:
    return _make_cache(cfg, batch_size, (batch_size, max_len), dtype, device)


def _make_cache(cfg: ModelConfig, slots: int, kv_lead, dtype, device):
    dev = resolve_device(device, allow_meta=True)
    n_seg, per = _n_segments(cfg), cfg.hybrid.attn_every
    di = cfg.ssm.expand * cfg.d_model
    heads, p = di // cfg.ssm.head_dim, cfg.ssm.head_dim
    kv_shape = (n_seg, *kv_lead, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "ssm": {
            "h": torch.zeros((n_seg, per, slots, heads, p, cfg.ssm.d_state),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((n_seg, per, slots, cfg.ssm.d_conv - 1, di),
                                dtype=dtype, device=dev),
        },
        "k": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "v": torch.zeros(kv_shape, dtype=dtype, device=dev),
    }


def hybrid_decode_step(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                       shard=None):
    """One decode step.  batch {"token" (B,1), "cur_len" int}: K/V written at
    cur_len and the states stepped, all in place; returns (cache, logits
    (B,V)).  ``shard``: a decode step's on a training mesh (the cache the
    rank's blocks; at B 1 the shared block's positions over "data",
    ``attention.mesh_decode_attention``)."""
    cur_len = int(batch["cur_len"])
    params, segments = _serve_segments(cfg, params, shard)
    spec = None if shard is None else shard.cache["k"]
    x = embed_tokens(params["embed"], batch["token"], shard)
    positions = torch.full((x.shape[0], 1), cur_len, dtype=torch.int32,
                           device=x.device)
    ssm = cache["ssm"]
    for seg, (seg_layers, shared) in enumerate(segments):
        for j, lp in enumerate(seg_layers):
            x, st2 = _mamba2_layer(cfg, lp, x, shard,
                                   {k: v[seg, j] for k, v in ssm.items()})
            for k, v in ssm.items():
                v[seg, j].copy_(st2[k])

        def attend(xn, seg=seg, shared=shared):
            o, _, _ = attn.attention_decode_block(
                cfg, shared["attn"], xn, cache["k"][seg], cache["v"][seg],
                cur_len, positions, shard=shard, spec=spec)
            return o
        x = _shared_tail(cfg, shared, x, attend, shard)
    return cache, _head(cfg, params, x, shard)[:, 0, :]


# ---------------------------------------------------------------------------
# Paged serving: a KV block pool for the shared block's call sites beside a
# state slab for the Mamba2 backbone
# ---------------------------------------------------------------------------
# cache = {"k"/"v": (n_seg, num_blocks, block_size, KV, hd)  block axis 1,
#          "ssm": {"h":    (n_seg, per, state_slots, H, P, N) f32,
#                  "conv": (n_seg, per, state_slots, K-1, di)}  slot axis 2}
# The two address spaces never mix: the block data plane touches only the
# k/v leaves and the slot data plane only the ssm leaves, so KVStore and
# StateSlab each manage their half of one cache.  Block 0 and slot 0 are the
# null targets of padded rows.


def make_hybrid_paged_cache(cfg: ModelConfig, num_blocks: int,
                            block_size: int, state_slots: int, dtype,
                            device=None) -> Dict:
    return _make_cache(cfg, state_slots, (num_blocks, block_size), dtype,
                       device)


def _kv(cache: Dict) -> Dict:
    return {"k": cache["k"], "v": cache["v"]}


def paged_block_copy(cache: Dict, src, dst) -> Dict:
    """CoW data plane of the attention half (k/v leaves only)."""
    transformer.paged_block_copy(_kv(cache), src, dst)
    return cache


def paged_block_read(cache: Dict, idx) -> Dict:
    return transformer.paged_block_read(_kv(cache), idx)


def paged_block_write(cache: Dict, idx, data: Dict) -> Dict:
    transformer.paged_block_write(_kv(cache), idx, data)
    return cache


def state_slot_copy(cache: Dict, src, dst) -> Dict:
    """CoW / fork data plane of the scan half (ssm leaves only)."""
    ssm_lm.slab_copy(cache["ssm"], 2, src, dst)
    return cache


def state_slot_read(cache: Dict, idx) -> Dict:
    return ssm_lm.slab_read(cache["ssm"], 2, idx)


def state_slot_write(cache: Dict, idx, data: Dict) -> Dict:
    ssm_lm.slab_write(cache["ssm"], 2, idx, data)
    return cache


def hybrid_prefill_chunk(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                         m_used: Optional[int] = None):
    """One prompt chunk of a single request: the scan state threads across
    chunk boundaries through the slab while the shared block's K/V land in
    the block table, in one pass.

    batch {"tokens" (1,C), "block_table" (1,M), "state_slot", "start",
    "prompt_len", optionally "pages_per_fetch"}, conventions as in
    ``transformer.lm_prefill_chunk`` plus the slab slot; at ``start == 0``
    the slot's recycled state is read as zeros.  Returns (cache, logits
    (1,C,V)); the cache is updated in place."""
    slot = int(batch["state_slot"])
    start = int(batch["start"])
    prompt_len = int(batch["prompt_len"])
    valid_len = prompt_len - start
    ppf = int(batch.get("pages_per_fetch", 1))
    table = batch["block_table"].to(torch.int32)
    tokens = batch["tokens"]
    chunk_pos = torch.arange(start, start + tokens.shape[1],
                             dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params["embed"], tokens)
    shared, ssm = params["shared"], cache["ssm"]
    for seg in range(_n_segments(cfg)):
        for j, lp in enumerate(_segment(cfg, params, seg)):
            st = {k: v[seg, j, slot:slot + 1] for k, v in ssm.items()}
            if start == 0:
                st = {k: torch.zeros_like(v) for k, v in st.items()}
            y, st2 = mamba.mamba2_chunk(
                cfg, lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), st,
                valid_len)
            x = x + y
            for k, v in ssm.items():
                v[seg, j, slot].copy_(st2[k][0])

        def attend(xn, seg=seg):
            o, _, _ = attn.attention_prefill_chunk_block(
                cfg, shared["attn"], xn, cache["k"][seg], cache["v"][seg],
                table, chunk_pos, prompt_len, m_used=m_used,
                pages_per_fetch=ppf)
            return o
        x = _shared_tail(cfg, shared, x, attend)
    return cache, _head(cfg, params, x)


def hybrid_decode_step_paged(cfg: ModelConfig, params, cache: Dict,
                             batch: Dict):
    """One decode step over the mixed layout.  batch {"token" (B,1),
    "block_tables" (B,M), "seq_lens" (B,), "state_slots" (B,), optionally
    "pages_per_fetch"}: attention reads each row's own span from the block
    pool, the Mamba2 layers gather and scatter each row's slab slot (padded
    rows all use slot 0, never a request's state)."""
    tables = batch["block_tables"].to(torch.int32)
    seq_lens = batch["seq_lens"].to(torch.int32)
    slots = batch["state_slots"].long()
    ppf = int(batch.get("pages_per_fetch", 1))
    x = embed_tokens(params["embed"], batch["token"])
    shared, ssm = params["shared"], cache["ssm"]
    for seg in range(_n_segments(cfg)):
        for j, lp in enumerate(_segment(cfg, params, seg)):
            st = {k: v[seg, j][slots] for k, v in ssm.items()}
            y, st2 = mamba.mamba2_decode_step(
                cfg, lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), st)
            x = x + y
            for k, v in ssm.items():
                v[seg, j][slots] = st2[k].to(v.dtype)

        def attend(xn, seg=seg):
            o, _, _ = attn.attention_decode_block_paged(
                cfg, shared["attn"], xn, cache["k"][seg], cache["v"][seg],
                tables, seq_lens, pages_per_fetch=ppf)
            return o
        x = _shared_tail(cfg, shared, x, attend)
    return cache, _head(cfg, params, x)[:, 0, :]
