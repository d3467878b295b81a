"""falcon-mamba-style attention-free LM: a stack of Mamba1 blocks (mirrors
``src/repro/models/ssm_lm.py``).

Training: ``ssm_lm_loss`` runs every layer's selective scan through
``SSMScanFn`` (the K7 forward with its state checkpoints, and the K7
backward kernels) and every norm through ``RMSNormFn``; with ``remat`` each
layer runs again in the backward, as the reference checkpoints its scan
body.

Training on a mesh: ``ssm_lm_loss`` takes the step's ``shard`` (a
``repro_torch.distributed.sharding.TrainShard``; the weights are the
rank's ``TrainWeight`` shards) and threads it through every layer: a
layer's FSDP shards are gathered in one bucket at its entry, inside the
remat region (REPRO_WEIGHT_AG=0), or each at its use (=1), the
embedding's once a step, and under fsdp_tp each Mamba1 layer computes the
rank's d_inner channels (``mamba.mamba1_forward``).  The reference's
Mamba and ssm_lm constraints name no sequence axis, so under
REPRO_SEQ_PARALLEL=1 the family trains exactly as without it.

``params["layers"]`` is a list of per-layer dicts ``{"ln", "mamba"}``; the
JAX package's ``lax.scan`` over stacked layers is a Python loop.  The dense
cache and the paged state slab keep the JAX layouts, ``{"h": (L, B|slots,
d_inner, N) f32, "conv": (L, B|slots, K-1, d_inner)}``, and the paged
functions update the slab in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import gather_layer, weight_use
from repro_torch.models import mamba
from repro_torch.models.layers import (
    generator, embed_tokens, init_embed, lm_head_loss, logits_from_hidden,
    rms_norm,
)
from repro_torch.models.transformer import run_blocks, serve_layers


def init_ssm_lm(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (default cuda)."""
    dev = resolve_device(device, allow_meta=True)
    dtype = torch_dtype(cfg)
    gen = generator(seed, dev)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=dev)  # noqa: E731
    return {
        "embed": init_embed(cfg, gen, dtype, dev),
        "final_norm": ones(),
        "layers": [{"ln": ones(),
                    "mamba": mamba.init_mamba1(cfg, gen, dtype, dev)}
                   for _ in range(cfg.n_layers)],
    }


def _head(cfg: ModelConfig, params, x: torch.Tensor,
          shard=None) -> torch.Tensor:
    h = rms_norm(x, weight_use(params["final_norm"], None, shard=shard),
                 cfg.norm_eps)
    return logits_from_hidden(cfg, params["embed"], h, shard)


def _layer_fwd(cfg: ModelConfig, lp, x: torch.Tensor, shard=None
               ) -> torch.Tensor:
    ln = weight_use(lp["ln"], None, shard=shard)
    y, _ = mamba.mamba1_forward(cfg, lp["mamba"],
                                rms_norm(x, ln, cfg.norm_eps), shard=shard)
    return x + y


def _fwd(cfg: ModelConfig, params, embeds: torch.Tensor, remat: bool,
         shard=None) -> torch.Tensor:
    """embeds (B,S,d) -> final-normed hidden (B,S,d); ``remat`` recomputes
    each layer in the backward; ``shard`` a training step's on a mesh."""
    bucket = shard is not None and not shard.per_use

    def layer(lp, x):
        if bucket:
            lp = gather_layer(lp, shard)
        return _layer_fwd(cfg, lp, x, shard)
    x = run_blocks(layer, params["layers"], embeds, remat)
    return rms_norm(x, weight_use(params["final_norm"], None, shard=shard),
                    cfg.norm_eps)


def ssm_lm_loss(cfg: ModelConfig, params, batch: Dict, remat: bool = True,
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


def ssm_lm_prefill(cfg: ModelConfig, params, batch: Dict, shard=None
                   ) -> Tuple[Dict, torch.Tensor]:
    """batch {"tokens" (B,S)} -> (states {"h": (L,B,di,N), "conv":
    (L,B,K-1,di)}, last-position logits (B,V)).  ``shard``: a prefill
    step's on a training mesh: the rank's batch rows and d_inner channels,
    which are its block of the states under ``cache_specs``."""
    params, layer = serve_layers(params, shard)
    x = embed_tokens(params["embed"], batch["tokens"], shard)
    hs, convs = [], []
    for lp in params["layers"]:
        lp = layer(lp)
        ln = weight_use(lp["ln"], None, shard=shard)
        y, st = mamba.mamba1_forward(cfg, lp["mamba"],
                                     rms_norm(x, ln, cfg.norm_eps),
                                     shard=shard)
        x = x + y
        hs.append(st["h"])
        convs.append(st["conv"])
    logits = _head(cfg, params, x[:, -1:, :], shard)[:, 0, :]
    return {"h": torch.stack(hs), "conv": torch.stack(convs)}, logits


def make_ssm_cache(cfg: ModelConfig, batch_size: int, dtype,
                   device=None) -> Dict:
    dev = resolve_device(device, allow_meta=True)
    di = cfg.ssm.expand * cfg.d_model
    return {
        "h": torch.zeros((cfg.n_layers, batch_size, di, cfg.ssm.d_state),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.ssm.d_conv - 1,
                             di), dtype=dtype, device=dev),
    }


def ssm_lm_decode_step(cfg: ModelConfig, params, cache: Dict, batch: Dict,
                       shard=None):
    """One decode step over the dense state cache.  batch {"token" (B,1)}
    -> (new states, logits (B,V)).  ``shard``: a decode step's on a
    training mesh (the states the rank's blocks)."""
    params, layer = serve_layers(params, shard)
    x = embed_tokens(params["embed"], batch["token"], shard)
    hs, convs = [], []
    for i, lp in enumerate(params["layers"]):
        lp = layer(lp)
        st = {"h": cache["h"][i], "conv": cache["conv"][i]}
        ln = weight_use(lp["ln"], None, shard=shard)
        y, st2 = mamba.mamba1_decode_step(
            cfg, lp["mamba"], rms_norm(x, ln, cfg.norm_eps), st, shard)
        x = x + y
        hs.append(st2["h"])
        convs.append(st2["conv"].to(cache["conv"].dtype))
    logits = _head(cfg, params, x, shard)[:, 0, :]
    return {"h": torch.stack(hs), "conv": torch.stack(convs)}, logits


# ---------------------------------------------------------------------------
# Paged serving: the state slab (slot axis instead of batch axis)
# ---------------------------------------------------------------------------
# The paged "cache" of an attention-free LM is the dense one with the batch
# axis widened to ``state_slots``: slot s holds one request's O(1) state.
# Slot 0 is the null slot (padded decode rows).  There are no KV pages: the
# engine's block pool stays empty.


def make_ssm_paged_cache(cfg: ModelConfig, state_slots: int, dtype,
                         device=None) -> Dict:
    return make_ssm_cache(cfg, state_slots, dtype, device)


def slab_copy(leaves: Dict, axis: int, src, dst) -> None:
    """Copy slot ``src`` of every leaf into slot ``dst`` (slot on ``axis``),
    in place."""
    for v in leaves.values():
        v.select(axis, int(dst)).copy_(v.select(axis, int(src)))


def slab_read(leaves: Dict, axis: int, idx) -> Dict:
    """Slot ``idx`` of every leaf -> host tensors, pinned when the slab is
    on a CUDA device (the device -> host half of a state swap)."""
    out = {}
    for k, v in leaves.items():
        s = v.select(axis, int(idx))
        host = torch.empty(s.shape, dtype=s.dtype, pin_memory=s.is_cuda)
        host.copy_(s)
        out[k] = host
    return out


def slab_write(leaves: Dict, axis: int, idx, data: Dict) -> None:
    """Host state -> slot ``idx`` of every leaf, in place (the swap-in
    half)."""
    for k, v in leaves.items():
        v.select(axis, int(idx)).copy_(torch.as_tensor(data[k]).to(v.dtype))


def state_slot_copy(cache: Dict, src, dst) -> Dict:
    """Device-side copy of one request's recurrent state (all layers): the
    copy-on-write data plane of ``repro_torch.serve.kv_store.StateSlab``."""
    slab_copy(cache, 1, src, dst)
    return cache


def state_slot_read(cache: Dict, idx) -> Dict:
    return slab_read(cache, 1, idx)


def state_slot_write(cache: Dict, idx, data: Dict) -> Dict:
    slab_write(cache, 1, idx, data)
    return cache


def ssm_lm_prefill_chunk(cfg: ModelConfig, params, cache: Dict,
                         batch: Dict):
    """One prompt chunk of a single request into its state slot.

    batch {"tokens" (1,C) (null-padded past the prompt), "state_slot",
    "start", "prompt_len" — the chunk's write limit, as in
    ``transformer.lm_prefill_chunk``}.  At ``start == 0`` the slot's
    recycled state is read as zeros, so slots need no zeroing on alloc.
    Returns (cache, logits (1,C,V)); the slab is updated in place."""
    slot = int(batch["state_slot"])
    start = int(batch["start"])
    valid_len = int(batch["prompt_len"]) - start
    x = embed_tokens(params["embed"], batch["tokens"])
    for i, lp in enumerate(params["layers"]):
        st = {k: v[i, slot:slot + 1] for k, v in cache.items()}
        if start == 0:
            st = {k: torch.zeros_like(v) for k, v in st.items()}
        y, st2 = mamba.mamba1_chunk(cfg, lp["mamba"],
                                    rms_norm(x, lp["ln"], cfg.norm_eps), st,
                                    valid_len)
        x = x + y
        for k, v in cache.items():
            v[i, slot].copy_(st2[k][0])
    return cache, _head(cfg, params, x)


def ssm_lm_decode_step_paged(cfg: ModelConfig, params, cache: Dict,
                             batch: Dict):
    """One decode step over the state slab.  batch {"token" (B,1),
    "state_slots" (B,)}: rows gather their slot's state, step the
    recurrence and scatter it back; padded rows use slot 0 (their writes
    collide there in no fixed order, which is harmless only because slot 0
    is never a request's state)."""
    slots = batch["state_slots"].long()
    x = embed_tokens(params["embed"], batch["token"])
    for i, lp in enumerate(params["layers"]):
        st = {k: v[i][slots] for k, v in cache.items()}
        y, st2 = mamba.mamba1_decode_step(
            cfg, lp["mamba"], rms_norm(x, lp["ln"], cfg.norm_eps), st)
        x = x + y
        for k, v in cache.items():
            v[i][slots] = st2[k].to(v.dtype)
    return cache, _head(cfg, params, x)[:, 0, :]
