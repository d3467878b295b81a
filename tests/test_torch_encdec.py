"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-small
reduced to 2 + 2 layers, f32) against the JAX package's on bridged weights:
``encode``, ``encdec_loss`` and every gradient leaf, ``encdec_prefill``'s
cache and logits, decode steps over a padded cache whose ``enc_len`` is
under its capacity, decode against a fresh prefill, the audio bridge, three
train steps against the JAX step, the Trainer, the kernel launches a step
and a serve call imply, and the bf16 entry cast of the stub frames.

The frames (24) outnumber the tokens (8), so every cross-attention has
Sq != Skv.  Tolerances are ``_torch_parity``'s, relative to the
reference's largest value.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import LOGITS_TOL, MODULE_TOL, assert_close, reduced
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.train import optimizer as jopt
from repro_torch import bridge
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model, encdec
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)

ARCH = "whisper-small"
B, S_ENC, S_DEC = 2, 24, 8
DECODE_STEPS = 4
# the padded cache's capacity: above both the frames and the decoded tokens
CAPACITY = S_ENC + 8


@lru_cache(maxsize=None)
def _setup(dtype="float32"):
    jcfg, tcfg = reduced(ARCH)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((B, S_ENC, tcfg.d_model)) * 0.1) \
        .astype(np.float32)
    tokens = rng.integers(1, tcfg.vocab, (B, S_DEC + DECODE_STEPS)) \
        .astype(np.int32)
    return jcfg, tcfg, jparams, tparams, frames, tokens


def _labels(tokens):
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return labels


def _place(small: dict, big: dict) -> dict:
    """A prefill cache written into the front of a larger empty one (the
    reference's ``_embed_cache``): each array along the axis where the two
    differ; ``enc_len`` is taken from the prefill."""
    out = {}
    for k, s in small.items():
        s, b = np.asarray(s), np.array(big[k])
        if s.shape != b.shape:
            ax = next(i for i in range(s.ndim) if s.shape[i] != b.shape[i])
            b[(slice(None),) * ax + (slice(0, s.shape[ax]),)] = s
            s = b
        out[k] = s
    return out


def test_encode_matches_jax():
    jcfg, tcfg, jparams, tparams, frames, _ = _setup()
    want = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
    got = encdec.encode(tcfg, tparams, torch.from_numpy(frames))
    assert_close(got, np.asarray(want), MODULE_TOL, "encode")


@lru_cache(maxsize=None)
def _jax_value_and_grad():
    jcfg, tcfg, jparams, tparams, frames, tokens = _setup()
    batch = {"frames": frames, "tokens": tokens[:, :S_DEC],
             "labels": _labels(tokens[:, :S_DEC])}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jencdec.encdec_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=False)))(jparams)
    return batch, float(loss), bridge.params_from_numpy(
        jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", ["off", "dots", "nothing"])
def test_encdec_loss_and_grads_match_jax(remat, monkeypatch):
    """The loss and every gradient leaf (encoder, decoder, cross-attention
    K/V projections, the embedding) against ``jax.value_and_grad``."""
    _, tcfg, _, tparams, _, _ = _setup()
    batch, jloss, jgrads = _jax_value_and_grad()
    if remat != "off":
        monkeypatch.setenv("REPRO_REMAT_POLICY", remat)
    params = map_tree(lambda t: t.clone().requires_grad_(), tparams)
    loss = build_model(tcfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        remat=remat != "off")
    loss.backward()
    assert_close(loss.detach(), np.float32(jloss), MODULE_TOL, "loss")
    got, want = leaves(map_tree(lambda p: p.grad, params)), leaves(jgrads)
    assert len(got) == len(want) == len(leaves(tparams))
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w.numpy(), MODULE_TOL, f"grad leaf {i}")


def test_encdec_prefill_matches_jax():
    """The cache (self-attention K/V of capacity S, the encoder's K/V of
    S_enc frames, enc_len) and the last position's logits."""
    jcfg, tcfg, jparams, tparams, frames, tokens = _setup()
    batch = {"frames": frames, "tokens": tokens[:, :S_DEC]}
    jcache, jlogits = jencdec.encdec_prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cache, logits = make_prefill_step(tcfg, "cpu")(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_close(logits, np.asarray(jlogits), LOGITS_TOL, "logits")
    for k in ("k", "v", "xk", "xv"):
        assert_close(cache[k], np.asarray(jcache[k]), MODULE_TOL, k)
    assert cache["xk"].shape[2] == S_ENC and cache["k"].shape[2] == S_DEC
    assert int(cache["enc_len"]) == int(jcache["enc_len"]) == S_ENC


def test_decode_over_padded_cache_matches_jax():
    """Both prefill caches placed into caches of capacity 32 (enc_len 24
    under it, the cross-attention's padded frames masked), then four decode
    steps in each framework on the same tokens: logits every step."""
    jcfg, tcfg, jparams, tparams, frames, tokens = _setup()
    batch = {"frames": frames, "tokens": tokens[:, :S_DEC]}
    jcache, _ = jencdec.encdec_prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    empty = jax.tree.map(np.asarray, jencdec.make_encdec_cache(
        jcfg, B, CAPACITY, jnp.float32))
    jcache = {k: jnp.asarray(v) for k, v in _place(jcache, empty).items()}
    cache, _ = make_prefill_step(tcfg, "cpu")(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    big = encdec.make_encdec_cache(tcfg, B, CAPACITY, torch.float32, "cpu")
    cache = {k: torch.from_numpy(v) for k, v in _place(
        {k: v.numpy() for k, v in cache.items()},
        {k: v.numpy() for k, v in big.items()}).items()}
    assert int(cache["enc_len"]) == S_ENC < cache["xk"].shape[2]
    decode = make_decode_step(tcfg, "cpu")
    for i in range(DECODE_STEPS):
        pos = S_DEC + i
        tok = tokens[:, pos:pos + 1]
        jcache, jlogits = jencdec.encdec_decode_step(
            jcfg, jparams, jcache, {"token": jnp.asarray(tok),
                                    "cur_len": jnp.int32(pos)})
        cache, logits = decode(tparams, cache, {"token": torch.from_numpy(tok),
                                                "cur_len": pos})
        assert_close(logits, np.asarray(jlogits), LOGITS_TOL, f"step {i}")
    assert_close(cache["k"], np.asarray(jcache["k"]), MODULE_TOL, "k cache")


def test_decode_matches_prefill():
    """The port alone: prefill S tokens, decode token S over a padded cache;
    its logits equal a fresh prefill of S + 1 tokens (the reference's
    ``test_decode_matches_prefill`` at f32)."""
    _, tcfg, _, tparams, frames, tokens = _setup()
    fns = build_model(tcfg, "cpu")
    f = torch.from_numpy(frames)
    with torch.no_grad():
        cache, _ = fns.prefill(tparams, {"frames": f, "tokens":
                                         torch.from_numpy(tokens[:, :S_DEC])})
        _, want = fns.prefill(tparams, {
            "frames": f, "tokens": torch.from_numpy(tokens[:, :S_DEC + 1])})
        big = fns.make_cache(B, CAPACITY)
        cache = {k: torch.from_numpy(v) for k, v in _place(
            {k: v.numpy() for k, v in cache.items()},
            {k: v.numpy() for k, v in big.items()}).items()}
        _, got = fns.decode_step(tparams, cache, {
            "token": torch.from_numpy(tokens[:, S_DEC:S_DEC + 1]),
            "cur_len": S_DEC})
    assert_close(got, want.numpy(), LOGITS_TOL, "decode vs prefill")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_params_round_trip_bitwise(dtype):
    """``params_from_numpy`` unstacks ``enc_layers`` and ``dec_layers`` into
    per-layer lists; ``params_to_numpy(family="audio")`` stacks them back
    bit for bit."""
    _, tcfg, jparams, tparams, _, _ = _setup(dtype)
    assert len(tparams["enc_layers"]) == tcfg.encdec.n_enc_layers
    assert len(tparams["dec_layers"]) == tcfg.n_layers
    assert tparams["dec_layers"][1]["cross_attn"]["wk"].dtype == \
        getattr(torch, dtype)
    back = bridge.params_to_numpy(tparams, family="audio",
                                  bf16_dtype=ml_dtypes.bfloat16)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_audio_train_state_round_trip(state_dtype):
    """The train state crosses both ways, f32 moments and int8 ones (whole
    blocks of 16 a layer at the reduced widths)."""
    _, _, jparams, _, _, _ = _setup()
    jo = jopt.AdamW(jopt.AdamWConfig(state_dtype=state_dtype, quant_block=16)
                    if state_dtype == "int8" else jopt.AdamWConfig())
    jstate = jax.tree.map(np.asarray, {"params": jparams,
                                       "opt": jo.init(jparams)})
    tstate = bridge.train_state_from_numpy(jstate)
    m = tstate["opt"]["m"]["dec_layers"][1]["cross_attn"]["wv"]
    assert isinstance(m, topt.Quantized) == (state_dtype == "int8")
    back = bridge.train_state_to_numpy(tstate, family="audio")
    is_q = lambda x: isinstance(x, (jopt.Quantized, topt.Quantized))  # noqa
    flat = lambda t: [y for x in jax.tree.leaves(t, is_leaf=is_q)  # noqa
                      for y in ((x.q, x.scale) if is_q(x) else (x,))]
    assert len(flat(back)) == len(flat(jstate))
    for a, b in zip(flat(back), flat(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_three_train_steps_match_jax():
    """Loss and grad norm per step within LOGITS_TOL of the JAX step from
    the same bridged state, on the pipeline's audio batches (f32 frames)."""
    from repro.train.data import TokenPipeline as JaxTokenPipeline
    jcfg, tcfg, jparams, tparams, _, _ = _setup()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep, jo = jax_make_train_step(jcfg, jopt.AdamWConfig(**kw), remat=True)
    tstep, to = make_train_step(tcfg, topt.AdamWConfig(**kw), remat=True,
                                device="cpu")
    jstate = {"params": jparams, "opt": jo.init(jparams)}
    tstate = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    pipe = JaxTokenPipeline(jcfg.vocab, 16, 2, seed=3, family="audio",
                            d_model=jcfg.d_model)
    jstep = jax.jit(jstep)
    for step in range(3):
        b = pipe.batch_at(step)
        assert b["frames"].dtype == np.float32
        jp, jo_state, jm = jstep(jstate["params"], jstate["opt"],
                                 {k: jnp.asarray(v) for k, v in b.items()})
        jstate = {"params": jp, "opt": jo_state}
        tp, to_state, tm = tstep(tstate["params"], tstate["opt"],
                                 {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        tstate = {"params": tp, "opt": to_state}
        for key in ("loss", "grad_norm"):
            assert_close(tm[key], np.float32(jm[key]), LOGITS_TOL, key)


def test_trainer_runs_three_steps():
    """The Trainer on the pipeline's audio batches: three finite losses,
    falling under the CLI's schedule."""
    from repro_torch.launch.train import opt_config
    _, tcfg, _, _, _, _ = _setup()
    res = Trainer(tcfg, TrainerConfig(seq_len=32, global_batch=4, steps=3,
                                      log_every=1),
                  opt_config(1e-3, 3), device="cpu").train()
    losses = [e["loss"] for e in res["log"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def _counting(monkeypatch):
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import rmsnorm as k2
    calls = dict.fromkeys(("fa_fwd", "fa_bwd", "rn_fwd", "rn_bwd"), 0)

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    for mod, name, key in ((k3, "flash_attention_kernel", "fa_fwd"),
                           (k3, "flash_attention_bwd_kernel", "fa_bwd"),
                           (k2, "rmsnorm_kernel", "rn_fwd"),
                           (k2, "rmsnorm_pair_kernel", "rn_fwd"),
                           (k2, "rmsnorm_bwd_kernel", "rn_bwd"),
                           (k2, "rmsnorm_pair_bwd_kernel", "rn_bwd")):
        monkeypatch.setattr(mod, name, counting(getattr(mod, name), key))
    return calls


def launches(n_enc: int, n_dec: int) -> dict:
    """K3 and K2 launches of one remat train step, one prefill call and one
    decode step: K3 on each encoder layer's attention and each decoder
    layer's self- and cross-attention; K2 on two norms an encoder layer,
    three a decoder layer, and the encoder's and the decoder's final norms;
    the remat step runs each layer's forward twice."""
    attn, norms = n_enc + 2 * n_dec, 2 * n_enc + 3 * n_dec
    return {"train": {"fa_fwd": 2 * attn, "fa_bwd": attn,
                      "rn_fwd": 2 * norms + 2, "rn_bwd": norms + 2},
            "prefill": {"fa_fwd": attn, "fa_bwd": 0, "rn_fwd": norms + 2,
                        "rn_bwd": 0},
            "decode": {"fa_fwd": 0, "fa_bwd": 0, "rn_fwd": 3 * n_dec + 1,
                       "rn_bwd": 0}}


def test_launches_a_step_and_a_call(monkeypatch):
    """What chip_smoke asserts at full width (36 K3 / 62 K2 a prefill call,
    0 / 37 a decode step; 72 / 36 K3 and 122 / 62 K2 a train step), here at
    2 + 2 layers through the kernel wrappers the CPU reaches."""
    _, tcfg, _, tparams, frames, tokens = _setup()
    assert launches(12, 12)["prefill"] == {"fa_fwd": 36, "fa_bwd": 0,
                                           "rn_fwd": 62, "rn_bwd": 0}
    assert launches(12, 12)["decode"]["rn_fwd"] == 37
    want = launches(tcfg.encdec.n_enc_layers, tcfg.n_layers)
    calls = _counting(monkeypatch)
    step, opt = make_train_step(tcfg, topt.AdamWConfig(), remat=True,
                                device="cpu")
    params = map_tree(torch.clone, tparams)
    batch = {"frames": frames, "tokens": tokens[:, :S_DEC],
             "labels": _labels(tokens[:, :S_DEC])}
    step(params, opt.init(params), {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert calls == want["train"], calls
    for kind in ("prefill", "decode"):
        calls.update(dict.fromkeys(calls, 0))
        if kind == "prefill":
            cache, _ = make_prefill_step(tcfg, "cpu")(tparams, {
                "frames": torch.from_numpy(frames),
                "tokens": torch.from_numpy(tokens[:, :S_DEC])})
        else:
            cache = encdec.make_encdec_cache(tcfg, B, CAPACITY, torch.float32,
                                             "cpu")
            make_decode_step(tcfg, "cpu")(tparams, cache, {
                "token": torch.from_numpy(tokens[:, :1]), "cur_len": 0})
        assert calls == want[kind], (kind, calls)


def test_bf16_entry_cast_of_the_frames():
    """At bf16 the stub frames are cast to the weights' dtype at entry:
    f32 frames give the port's bf16-frame output bit for bit, and both are
    close to the reference fed bf16 frames (fed f32 ones, its decoder's
    scan refuses the promoted carry)."""
    jcfg, tcfg, jparams, tparams, frames, _ = _setup("bfloat16")
    f32 = encdec.encode(tcfg, tparams, torch.from_numpy(frames))
    bf16 = encdec.encode(tcfg, tparams,
                         torch.from_numpy(frames).to(torch.bfloat16))
    assert f32.dtype == torch.bfloat16 and torch.equal(f32, bf16)
    want = jencdec.encode(jcfg, jparams, jnp.asarray(frames, jnp.bfloat16))
    assert_close(f32.float(), np.asarray(want, np.float32), 5e-2,
                 "bf16 encode")


def test_train_state_reckoning_counts_the_encoder():
    """The train CLI reckons whisper's state from ``param_count``, which
    counts the encoder and the cross-attention: within 1% of the
    parameters ``init`` draws at the reduced widths (it leaves out the
    decoder's third norm and the two final norms); whisper-small's state
    fits a card with f32 moments."""
    from repro_torch.launch import train as cli
    _, tcfg, _, tparams, _, _ = _setup()
    drawn = sum(t.numel() for t in leaves(tparams))
    assert abs(tcfg.param_count() - drawn) <= 0.01 * drawn
    no_encoder = dataclasses.replace(tcfg, encdec=None).param_count()
    assert tcfg.param_count() - no_encoder == sum(
        t.numel() for t in leaves(tparams["enc_layers"])) + sum(
        t.numel() for lp in tparams["dec_layers"]
        for t in leaves(lp["cross_attn"]))
    from repro_torch.configs.base import get_config
    cli.check_state_fits(get_config(ARCH), "f32", 85_520_809_984)
