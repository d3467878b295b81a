"""The port's VLM stub frontend (qwen2-vl-72b reduced, f32) against the JAX
package: M-RoPE on distinct (t, h, w) streams, its sections and the
sinusoidal table, then ``lm_loss`` (loss and every gradient leaf),
``lm_prefill`` and ``lm_decode_step`` fed embeds and three position
streams, the bf16 entry cast of the embeds, the trainer on the pipeline's
VLM batches, and the paged engines' refusal of the vlm and audio families.

Identical streams reduce M-RoPE to RoPE (and the training pipeline's
batches are identical streams), so every comparison here runs on distinct
ones: an image of 4 x 4 patches (t fixed, h the row, w the column) then
text whose three streams continue together, as qwen2-vl places them.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LOGITS_TOL, MODULE_TOL, assert_close, reduced
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, layers
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
B, GRID, TEXT = 2, 4, 6
S = GRID * GRID + TEXT


def vlm_positions(b: int, grid: int, text: int, start: int = 0) -> np.ndarray:
    """(3, b, grid² + text) int32 M-RoPE streams of one image then text:
    the patches at t = start, h = start + row, w = start + column; the text
    from start + grid on, all three streams equal."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.zeros_like(rows), rows, cols]) + start
    txt = np.broadcast_to(start + grid + np.arange(text), (3, text))
    pos = np.concatenate([img, txt], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, b) + pos.shape[1:]))


@lru_cache(maxsize=None)
def _setup(dtype="float32"):
    jcfg, tcfg = reduced(ARCH)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    embeds = (rng.standard_normal((B, S + 2, tcfg.d_model)) * 0.5) \
        .astype(np.float32)
    labels = rng.integers(1, tcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, embeds, labels


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_mrope_matches_jax_on_distinct_streams(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, S, 3, hd)).astype(np.float32)
    pos = vlm_positions(B, GRID, TEXT, start=5)
    sec = layers.default_mrope_sections(hd)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sec)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sec)
    assert_close(got, np.asarray(want), MODULE_TOL, "mrope")


def test_distinct_streams_change_the_rotation():
    """The witness: three equal streams give plain RoPE bit for bit, the
    image's distinct streams do not (so the parity above is not RoPE's)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, S, 2, 32)).astype(np.float32))
    pos = torch.from_numpy(vlm_positions(B, GRID, TEXT))
    sec = layers.default_mrope_sections(32)
    plain = layers.apply_rope(x, pos[0], 1e6)
    same = layers.apply_rope(x, pos[0].expand(3, B, S), 1e6, sec)
    assert torch.equal(same, plain)
    distinct = layers.apply_rope(x, pos, 1e6, sec)
    image = slice(1, GRID * GRID)       # patch 0 sits at (0, 0, 0)
    assert float((distinct - plain)[:, image].abs().max()) > 0.1
    assert torch.equal(distinct[:, GRID * GRID:],
                       layers.apply_rope(x, pos[0], 1e6)[:, GRID * GRID:])
    with pytest.raises(ValueError, match="sections"):
        layers.apply_rope(x, pos, 1e6)


def test_mrope_sections_and_sinusoidal_positions_match_jax():
    for hd in range(16, 257, 8):
        sec = layers.default_mrope_sections(hd)
        assert sec == jlayers.default_mrope_sections(hd) and \
            sum(sec) == hd // 2, hd
    assert layers.default_mrope_sections(128) == (16, 24, 24)
    # an angle is position x frequency in f32: an ulp of difference in the
    # two frameworks' exp moves the angle, and its sine, by up to
    # seq x 2^-23, twice that with the product's own rounding
    for seq, dim in ((1, 8), (37, 64), (448, 768), (1500, 768)):
        got = layers.sinusoidal_positions(seq, dim)
        assert_close(got, np.asarray(jlayers.sinusoidal_positions(seq, dim)),
                     2 * seq * 2.0 ** -23, f"sinusoidal {seq}x{dim}")


def _batch(embeds, labels=None, s=S):
    b = {"embeds": embeds[:, :s],
         "positions": vlm_positions(B, GRID, s - GRID * GRID)}
    if labels is not None:
        b["labels"] = labels[:, :s]
    return b


@lru_cache(maxsize=None)
def _jax_value_and_grad():
    jcfg, _, jparams, _, embeds, labels = _setup()
    b = _batch(embeds, labels)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtransformer.lm_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in b.items()},
        remat=False)))(jparams)
    return b, float(loss), bridge.params_from_numpy(
        jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", ["off", "dots"])
def test_vlm_loss_and_grads_match_jax(remat, monkeypatch):
    _, tcfg, _, tparams, _, _ = _setup()
    b, jloss, jgrads = _jax_value_and_grad()
    if remat != "off":
        monkeypatch.setenv("REPRO_REMAT_POLICY", remat)
    params = map_tree(lambda t: t.clone().requires_grad_(), tparams)
    loss = build_model(tcfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()},
        remat=remat != "off")
    loss.backward()
    assert_close(loss.detach(), np.float32(jloss), MODULE_TOL, "loss")
    # the token embedding is unused by an embeds batch (the head is
    # untied): no gradient reaches it, as the reference's is all zeros
    assert params["embed"]["embed"].grad is None
    got = leaves(map_tree(lambda p: torch.zeros_like(p) if p.grad is None
                          else p.grad, params))
    want = leaves(jgrads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w.numpy(), MODULE_TOL, f"grad leaf {i}")


def test_vlm_prefill_and_decode_match_jax():
    """``lm_prefill`` on embeds and three streams (cache and logits), then
    two decode steps each fed one embedding row at its own M-RoPE position
    (which runs behind the cache index: the image's 16 patches span 4
    positions), against the reference over the same padded cache."""
    jcfg, tcfg, jparams, tparams, embeds, _ = _setup()
    b = _batch(embeds)
    jcache, jlogits = jtransformer.lm_prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()})
    cache, logits = make_prefill_step(tcfg, "cpu")(
        tparams, {k: torch.from_numpy(v) for k, v in b.items()})
    assert_close(logits, np.asarray(jlogits), LOGITS_TOL, "prefill logits")
    for k in ("k", "v"):
        assert_close(cache[k], np.asarray(jcache[k]), MODULE_TOL, k)
    big = np.zeros(cache["k"].shape[:2] + (S + 2,) + cache["k"].shape[3:],
                   np.float32)
    jc, tc = {}, {}
    for k in ("k", "v"):
        full = big.copy()
        full[:, :, :S] = cache[k].numpy()
        jc[k], tc[k] = jnp.asarray(full), torch.from_numpy(full.copy())
    decode = make_decode_step(tcfg, "cpu")
    for i in range(2):
        pos = vlm_positions(B, GRID, TEXT + 1 + i)[:, :, -1:]
        assert int(pos[0, 0, 0]) == GRID + TEXT + i < S + i
        step = {"embeds": embeds[:, S + i:S + i + 1], "positions": pos}
        jc, jl = jtransformer.lm_decode_step(jcfg, jparams, jc, {
            **{k: jnp.asarray(v) for k, v in step.items()},
            "cur_len": jnp.int32(S + i)})
        tc, tl = decode(tparams, tc, {**{k: torch.from_numpy(v)
                                         for k, v in step.items()},
                                      "cur_len": S + i})
        assert_close(tl, np.asarray(jl), LOGITS_TOL, f"decode step {i}")
    assert_close(tc["k"], np.asarray(jc["k"]), MODULE_TOL, "decoded k")


def test_vlm_decode_matches_prefill():
    """The port alone: a decode step's logits equal a fresh prefill's over
    the same embeds and streams."""
    _, tcfg, _, tparams, embeds, _ = _setup()
    fns = build_model(tcfg, "cpu")
    with torch.no_grad():
        cache, _ = fns.prefill(tparams, {k: torch.from_numpy(v)
                                         for k, v in _batch(embeds).items()})
        _, want = fns.prefill(tparams, {k: torch.from_numpy(v) for k, v in
                                        _batch(embeds, s=S + 1).items()})
        big = fns.make_cache(B, S + 2)
        for k in ("k", "v"):
            big[k][:, :, :S] = cache[k]
        _, got = fns.decode_step(tparams, big, {
            "embeds": torch.from_numpy(embeds[:, S:S + 1]),
            "positions": torch.from_numpy(
                vlm_positions(B, GRID, TEXT + 1)[:, :, -1:]),
            "cur_len": S})
    assert_close(got, want.numpy(), LOGITS_TOL, "decode vs prefill")


def test_bf16_entry_cast_of_the_embeds():
    """At bf16 the embeds are cast to the weights' dtype at entry: the
    port fed f32 embeds equals the port fed bf16 ones bit for bit (loss,
    prefill logits and cache, all bf16 but the loss), and both are close
    to the reference fed bf16 embeds (fed f32 ones, the reference runs the
    whole stack and its cache in f32)."""
    jcfg, tcfg, jparams, tparams, embeds, labels = _setup("bfloat16")
    b = _batch(embeds, labels)
    fns = build_model(tcfg, "cpu")
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb["embeds"] = tb["embeds"].to(dt)
        with torch.no_grad():
            loss = fns.loss(tparams, tb, remat=False)
            cache, logits = fns.prefill(tparams, {k: tb[k] for k in
                                                  ("embeds", "positions")})
        outs.append((loss, logits, cache["k"]))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert outs[0][1].dtype == outs[0][2].dtype == torch.bfloat16
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["embeds"] = jb["embeds"].astype(jnp.bfloat16)
    jloss = jtransformer.lm_loss(jcfg, jparams, jb, remat=False)
    jcache, jlogits = jtransformer.lm_prefill(
        jcfg, jparams, {k: jb[k] for k in ("embeds", "positions")})
    assert jcache["k"].dtype == jnp.bfloat16
    assert_close(outs[0][0], np.float32(jloss), 2e-2, "bf16 loss")
    assert_close(outs[0][1].float(), np.asarray(jlogits, np.float32), 5e-2,
                 "bf16 prefill logits")


def test_trainer_on_vlm_batches():
    """The Trainer on the pipeline's VLM batches (f32 embeds, three equal
    streams): finite losses, falling under the CLI's schedule."""
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _, tcfg, _, _, _, _ = _setup()
    res = Trainer(tcfg, TrainerConfig(seq_len=32, global_batch=4, steps=3,
                                      log_every=1),
                  opt_config(1e-3, 3), device="cpu").train()
    losses = [e["loss"] for e in res["log"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", [ARCH, "whisper-small"])
def test_paged_engines_refuse_vlm_and_audio(arch):
    """The reference's paged engine asserts on both families; the port's
    raises and names the step builders that serve them."""
    from repro.serve.engine import ServeEngine as JaxServeEngine
    from repro_torch.serve.engine import ServeEngine
    jcfg, tcfg = reduced(arch)
    with pytest.raises(AssertionError, match="token-frontend"):
        JaxServeEngine(jcfg, {}, plan_kernels=False)
    params = build_model(tcfg, "cpu").init(0)
    with pytest.raises(ValueError, match="make_prefill_step"):
        ServeEngine(tcfg, params, plan_kernels=False)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_adamw_update_in_slices_keeps_the_bits(state_dtype, monkeypatch):
    """qwen2-vl-72b's 1.25-billion-value embeddings are updated in slices
    (``optimizer.UPDATE_CHUNK``): leaves of 3,000 and 700 values (neither a
    multiple of the 256-value block) updated in slices of 512 give the
    weights and moments of one whole-leaf update bit for bit, over three
    steps."""
    from repro_torch.train import optimizer as topt
    rng = np.random.default_rng(7)
    shapes = {"a": (30, 100), "b": (700,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(3)]
    opt = topt.AdamW(topt.AdamWConfig(lr=1e-2, warmup_steps=1,
                                      state_dtype=state_dtype))
    runs = []
    for chunk in (topt.UPDATE_CHUNK, 512):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        ps = map_tree(torch.clone, params)
        state = opt.init(ps)
        for g in grads:
            opt.update(g, state, ps)
        moments = [y for x in leaves(state["m"]) + leaves(state["v"])
                   for y in ((x.q, x.scale) if state_dtype == "int8"
                             else (x,))]
        runs.append(leaves(ps) + moments)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
