"""The port's training slice against the JAX package: AdamW (f32 and int8
moments), the token pipeline, checkpoints, the loss of each family the port
trains and its gradients (``lm_loss``: every attention through
``FlashAttentionFn``; ``ssm_lm_loss``: every selective scan through
``SSMScanFn``; ``hybrid_loss``: the shared block's attention through
``FlashAttentionFn`` at head_dim 80's layout; every norm through
``RMSNormFn``; on the CPU their plain versions), train steps, the trainer's
checkpoint/restart replay for each family, the train CLI and the
train-state bridge.

The same numpy-seeded weights, batches and states go through both
frameworks on reduced f32 configs; tolerances are ``_torch_parity``'s,
relative to the reference's largest value.
"""
import os
import subprocess
import sys
import tempfile
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LOGITS_TOL, MODULE_TOL, assert_close, bridged_params
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train.data import TokenPipeline as JaxTokenPipeline
from repro_torch import bridge
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import (list_checkpoints,
                                          restore_checkpoint, restore_latest,
                                          save_checkpoint)
from repro_torch.train.data import TokenPipeline
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the second dense arch of the loss parity (squared-ReLU MLP, no qk-norm),
# then the stateful families (Mamba1 on K7; Mamba2 and the shared block)
LOSS_ARCHS = ("qwen3-0.6b", "nemotron-4-15b", "falcon-mamba-7b",
              "zamba2-2.7b")
STATEFUL_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
OPT_TOL = 1e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1e-30,
                                                 float(np.abs(want).max()))


# -- optimizer ---------------------------------------------------------------

def test_cosine_lr_matches_jax():
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jc, tc = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    for step in range(0, 120, 3):
        want = float(jopt.cosine_lr(jc, jnp.asarray(step, jnp.int32)))
        got = float(topt.cosine_lr(tc, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * abs(want), (step, got, want)


def test_quantize_matches_jax():
    """Payload bitwise, scales within one ulp; ties of round go to even in
    both (a block whose values sit on .5 steps)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1000,)) * 3).astype(np.float32)
    ties = (np.arange(256, dtype=np.float32) - 127.5)       # max 127.5
    for arr in (x, ties, x.reshape(10, 100)):
        jq = jopt.quantize(jnp.asarray(arr), 256)
        tq = topt.quantize(torch.from_numpy(arr), 256)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_max_ulp(tq.scale.numpy(),
                                        np.asarray(jq.scale), maxulp=1)
        assert (tq.shape, tq.pad) == (tuple(jq.shape), jq.pad)
        np.testing.assert_allclose(topt.dequantize(tq).numpy(),
                                   np.asarray(jopt.dequantize(jq)),
                                   rtol=1e-6, atol=1e-6)


def _port_moment(x):
    if isinstance(x, jopt.Quantized):
        return topt.Quantized(torch.from_numpy(np.array(x.q)),
                              torch.from_numpy(np.array(x.scale)),
                              tuple(x.shape), x.pad)
    return torch.from_numpy(np.array(x))


def _dequant(x):
    if isinstance(x, topt.Quantized):
        return topt.dequantize(x).numpy()
    if isinstance(x, jopt.Quantized):
        return np.asarray(jopt.dequantize(x))
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_adamw_update_matches_jax(state_dtype):
    """Two updates from one state (the JAX state after the first is handed
    to both sides for the second, so the int8 path dequantizes a non-zero
    moment): params, moments and metrics within 1e-6 relative."""
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, state_dtype=state_dtype,
              grad_clip=0.5)
    jo, to = jopt.AdamW(jopt.AdamWConfig(**kw)), topt.AdamW(
        topt.AdamWConfig(**kw))
    params = {"w": rng.normal(size=(300,)).astype(np.float32),
              "b": {"c": rng.normal(size=(4, 64)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jo.init(jp)
    for it in range(2):
        grads = {"w": rng.normal(size=(300,)).astype(np.float32),
                 "b": {"c": rng.normal(size=(4, 64)).astype(np.float32)}}
        tp = map_tree(lambda a: torch.from_numpy(np.array(a)), params)
        tstate = {"step": torch.tensor(int(jstate["step"]), dtype=torch.int32),
                  "m": jax.tree.map(_port_moment, jstate["m"],
                                    is_leaf=lambda x: isinstance(
                                        x, jopt.Quantized)),
                  "v": jax.tree.map(_port_moment, jstate["v"],
                                    is_leaf=lambda x: isinstance(
                                        x, jopt.Quantized))}
        jnew, jstate, jm = jo.update(jax.tree.map(jnp.asarray, grads),
                                     jstate, jp)
        tnew, tstate, tm = to.update(
            map_tree(torch.from_numpy, grads), tstate, tp)
        for key in ("lr", "grad_norm"):
            assert _rel(float(tm[key]), float(jm[key])) <= OPT_TOL, key
        assert int(tstate["step"]) == int(jstate["step"]) == it + 1
        for got, want in zip(leaves(tnew), jax.tree.leaves(jnew)):
            assert _rel(got.numpy(), np.asarray(want)) <= OPT_TOL
        is_q = lambda x: isinstance(x, jopt.Quantized)  # noqa: E731
        for key in ("m", "v"):
            for got, want in zip(leaves(tstate[key]),
                                 jax.tree.leaves(jstate[key], is_leaf=is_q)):
                assert _rel(_dequant(got), _dequant(want)) <= OPT_TOL, key
        jp, params = jnew, jax.tree.map(np.asarray, jnew)


def test_adamw_reduces_quadratic_loss():
    opt = topt.AdamW(topt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                                      weight_decay=0.0))
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(60):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_grad_clip():
    opt = topt.AdamW(topt.AdamWConfig(lr=1e-3, grad_clip=1.0))
    params = {"w": torch.zeros(4)}
    _, _, metrics = opt.update({"w": torch.full((4,), 1e6)},
                               opt.init(params), params)
    assert float(metrics["grad_norm"]) > 1.0  # reported pre-clip


def _out_of_place_update(cfg, grads, state, params):
    """The AdamW update written out of place (every new leaf a new tensor,
    the op order of ``AdamW.update``): the yardstick of the in-place one."""
    step = state["step"] + 1
    lr = topt.cosine_lr(cfg, step)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in leaves(grads)))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    out = []
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        if cfg.state_dtype == "int8":
            m, v = topt.dequantize(m), topt.dequantize(v)
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        pf = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        new_p = (pf - lr * delta).to(p.dtype)
        if cfg.state_dtype == "int8":
            m = topt.quantize(m, cfg.quant_block)
            v = topt.quantize(v, cfg.quant_block)
        out.append((new_p, m, v))
    return out, step


def _storage(x):
    """The data pointers of a weight or moment (an int8 moment's payload
    and scales)."""
    if isinstance(x, topt.Quantized):
        return (x.q.data_ptr(), x.scale.data_ptr())
    return (x.data_ptr(),)


def _bits(x):
    if isinstance(x, topt.Quantized):
        return [x.q, x.scale]
    return [x]


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_adamw_update_is_in_place_with_the_out_of_place_bits(state_dtype):
    """The update writes every weight, m and v into its own storage (the
    reference donates its train state; the port holds one state at a
    time), and its values are bit for bit those of the same update
    computed out of place, over two updates (the second from non-zero
    moments) with bf16 and f32 weights."""
    rng = np.random.default_rng(3)
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                           state_dtype=state_dtype, grad_clip=0.5)
    opt = topt.AdamW(cfg)
    params = {"w": torch.from_numpy(rng.normal(size=(300,)).astype(
                  np.float32)).to(torch.bfloat16),
              "b": {"c": torch.from_numpy(rng.normal(size=(4, 64)).astype(
                  np.float32))}}
    state = opt.init(params)
    for _ in range(2):
        grads = map_tree(lambda p: torch.from_numpy(rng.normal(
            size=tuple(p.shape)).astype(np.float32)).to(p.dtype), params)
        want, want_step = _out_of_place_update(
            cfg, grads, map_tree(lambda x: x, state), params)
        before = [_storage(x) for tree in (params, state["m"], state["v"])
                  for x in leaves(tree)]
        step_ptr = state["step"].data_ptr()
        new_params, new_state, _ = opt.update(grads, state, params)
        assert new_params is params and new_state is state
        after = [_storage(x) for tree in (params, state["m"], state["v"])
                 for x in leaves(tree)]
        assert after == before and state["step"].data_ptr() == step_ptr
        assert int(state["step"]) == int(want_step)
        got = zip(leaves(params), leaves(state["m"]), leaves(state["v"]))
        for g, w in zip(got, want):
            for gx, wx in zip(g, w):
                assert all(torch.equal(a, b)
                           for a, b in zip(_bits(gx), _bits(wx)))


def test_int8_quant_roundtrip_and_state_runs():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,)) * 3
                         ).to(torch.float32)
    err = float((topt.dequantize(topt.quantize(x, 256)) - x).abs().max())
    assert err < float(x.abs().max()) / 100
    opt = topt.AdamW(topt.AdamWConfig(lr=0.05, state_dtype="int8",
                                      warmup_steps=1))
    params = {"w": torch.tensor([4.0, -4.0])}
    state = opt.init(params)
    for _ in range(40):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 2.0
    assert state["m"]["w"].q.dtype == torch.int8


# -- data ----------------------------------------------------------------------

def test_batches_are_bitwise_the_jax_pipelines():
    jp = JaxTokenPipeline(vocab=1000, seq_len=64, global_batch=3, seed=7)
    tp = TokenPipeline(vocab=1000, seq_len=64, global_batch=3, seed=7)
    for step in range(4):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_prefetch_thread_yields_steps_in_order():
    tp = TokenPipeline(vocab=100, seq_len=16, global_batch=2, seed=1)
    tp.start(start_step=5)
    try:
        it = iter(tp)
        for want_step in (5, 6, 7):
            step, batch = next(it)
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          tp.batch_at(step)["tokens"])
    finally:
        tp.stop()


# -- checkpoint ------------------------------------------------------------------

def test_checkpoint_atomic_roundtrip_and_bf16_exact():
    bf = torch.randn(5, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": bf}, "l": [torch.ones(2, dtype=torch.int32)]}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 10, tree)
        save_checkpoint(d, 20, map_tree(lambda x: x * 2, tree))
        assert [s for s, _ in list_checkpoints(d)] == [10, 20]
        assert not [p for p in os.listdir(d) if p.startswith(".tmp_")]
        restored, mf = restore_latest(d, tree)
        assert mf["step"] == 20 and mf["complete"]
        assert torch.equal(restored["a"], tree["a"] * 2)
        assert restored["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(restored["b"]["c"], bf * 2)
        assert torch.equal(restored["l"][0], torch.full((2,), 2,
                                                        dtype=torch.int32))
        # an int8 moment is two leaves (payload, scales) on disk
        q = topt.quantize(torch.randn(300), 256)
        save_checkpoint(d, 30, {"m": q})
        back, mf = restore_checkpoint(list_checkpoints(d)[-1][1], {"m": q})
        assert mf["n_leaves"] == 2
        assert torch.equal(back["m"].q, q.q) and torch.equal(back["m"].scale,
                                                               q.scale)


def test_checkpoint_gc():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, {"a": torch.zeros(2)}, keep=2)
        assert [s for s, _ in list_checkpoints(d)] == [4, 5]


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.zeros(2, 2)})
        with pytest.raises(ValueError):
            restore_latest(d, {"a": torch.zeros(3, 3)})


# -- loss and gradients ------------------------------------------------------------

def _batch(jcfg, seq=32, batch=2, step=0):
    return JaxTokenPipeline(jcfg.vocab, seq, batch, seed=3).batch_at(step)


@lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    jcfg, tcfg, jparams, tparams = bridged_params(arch)
    b = _batch(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p: jax_build_model(jcfg).loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}, remat=False)))
    loss, grads = fn(jparams)
    return tcfg, tparams, b, float(loss), bridge.params_from_numpy(
        jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", ["off", "dots", "nothing"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_grads_match_jax(arch, remat, monkeypatch):
    tcfg, tparams, b, jloss, jgrads = _jax_value_and_grad(arch)
    if remat != "off":
        monkeypatch.setenv("REPRO_REMAT_POLICY", remat)
    params = map_tree(lambda t: t.clone().requires_grad_(), tparams)
    loss = build_model(tcfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()},
        remat=remat != "off")
    loss.backward()
    assert_close(loss.detach(), np.float32(jloss), MODULE_TOL, "loss")
    got, want = leaves(map_tree(lambda p: p.grad, params)), leaves(jgrads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w.numpy(), MODULE_TOL, f"grad leaf {i}")


def test_hybrid_loss_over_two_segments_matches_jax(monkeypatch):
    """Two segments of the reduced hybrid (4 Mamba2 layers, the shared
    block called twice, its gradient summed over both calls), remat on:
    the loss and every gradient leaf against ``jax.value_and_grad``."""
    import dataclasses
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    jcfg = dataclasses.replace(jax_reduced_config(
        jax_get_config("zamba2-2.7b")), n_layers=4)
    tcfg = dataclasses.replace(reduced_config(get_config("zamba2-2.7b")),
                               n_layers=4)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    b = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_build_model(jcfg).loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}, remat=True))(jparams)
    params = map_tree(lambda t: t.requires_grad_(), bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    loss = build_model(tcfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()}, remat=True)
    loss.backward()
    assert_close(loss.detach(), np.float32(jloss), MODULE_TOL, "loss")
    want = leaves(bridge.params_from_numpy(jax.tree.map(np.asarray, jgrads)))
    got = leaves(map_tree(lambda p: p.grad, params))
    assert len(got) == len(want) and len(params["layers"]) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w.numpy(), MODULE_TOL, f"grad leaf {i}")


def test_three_train_steps_match_jax():
    """Loss and grad norm per step within LOGITS_TOL of the JAX step from
    the same bridged state; params within 2 lr a step.  In AdamW's first
    steps an element whose gradient is near zero moves by about +-lr
    whatever its size (m / sqrt(v) is about its sign), so where f32
    reassociation flips that sign the two sides part by a whole step."""
    jcfg, tcfg, jparams, tparams = bridged_params("qwen3-0.6b")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep, jo = jax_make_train_step(jcfg, jopt.AdamWConfig(**kw), remat=True)
    tstep, to = make_train_step(tcfg, topt.AdamWConfig(**kw), remat=True,
                                device="cpu")
    jstate = {"params": jparams, "opt": jo.init(jparams)}
    tstate = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jstep)
    for step in range(3):
        b = _batch(jcfg, step=step)
        jp, jopt_state, jm = jstep(jstate["params"], jstate["opt"],
                                   {k: jnp.asarray(v) for k, v in b.items()})
        jstate = {"params": jp, "opt": jopt_state}
        tp, topt_state, tm = tstep(tstate["params"], tstate["opt"],
                                   {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        tstate = {"params": tp, "opt": topt_state}
        for key in ("loss", "grad_norm"):
            assert_close(tm[key], np.float32(jm[key]), LOGITS_TOL, key)
    want = bridge.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    for g, w in zip(leaves(tstate["params"]), leaves(want)):
        assert float((g - w).abs().max()) <= 2 * kw["lr"] * 3
    assert not any(p.requires_grad or p.grad is not None
                   for p in leaves(tstate["params"]))


def test_train_step_launches_through_the_functions(monkeypatch):
    """One step calls FlashAttentionFn once a layer forward and once again in
    the rematerialised recompute, its backward once a layer, and K2 once a
    norm launch: three a layer (ln1, ln2 and the q/k pair in one launch)
    forward and again in the recompute, plus the final norm; its backward
    once for each of those 3n + 1."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import rmsnorm as k2
    calls = {"fa_fwd": 0, "fa_bwd": 0, "rn_fwd": 0, "rn_bwd": 0}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(k3, "flash_attention_kernel",
                        counting(k3.flash_attention_kernel, "fa_fwd"))
    monkeypatch.setattr(k3, "flash_attention_bwd_kernel",
                        counting(k3.flash_attention_bwd_kernel, "fa_bwd"))
    for name, key in (("rmsnorm_kernel", "rn_fwd"),
                      ("rmsnorm_pair_kernel", "rn_fwd"),
                      ("rmsnorm_bwd_kernel", "rn_bwd"),
                      ("rmsnorm_pair_bwd_kernel", "rn_bwd")):
        monkeypatch.setattr(k2, name, counting(getattr(k2, name), key))
    tcfg = reduced_config(get_config("qwen3-0.6b"))
    step, opt = make_train_step(tcfg, topt.AdamWConfig(), remat=True,
                                device="cpu")
    params = build_model(tcfg, "cpu").init(0)
    b = TokenPipeline(tcfg.vocab, 16, 2).batch_at(0)
    step(params, opt.init(params), {k: torch.from_numpy(v)
                                    for k, v in b.items()})
    n = tcfg.n_layers
    assert calls == {"fa_fwd": 2 * n, "fa_bwd": n, "rn_fwd": 6 * n + 1,
                     "rn_bwd": 3 * n + 1}, calls


def _counting_launches(monkeypatch):
    """Count the kernel wrappers that the Functions and ``ops`` look up in
    their modules: K3 forward and backward, K2 forward (single and pair)
    and backward, K7's fused forward with checkpoints and its fused backward
    (what SSMScanFusedFn launches)."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import rmsnorm as k2
    from repro_torch.kernels import ssm_scan as k7
    calls = dict.fromkeys(("fa_fwd", "fa_bwd", "rn_fwd", "rn_bwd", "k7_fwd",
                           "k7_bwd"), 0)

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    for mod, name, key in (
            (k3, "flash_attention_kernel", "fa_fwd"),
            (k3, "flash_attention_bwd_kernel", "fa_bwd"),
            (k2, "rmsnorm_kernel", "rn_fwd"),
            (k2, "rmsnorm_pair_kernel", "rn_fwd"),
            (k2, "rmsnorm_bwd_kernel", "rn_bwd"),
            (k2, "rmsnorm_pair_bwd_kernel", "rn_bwd"),
            (k7, "ssm_scan_fused_ckpt_kernel", "k7_fwd"),
            (k7, "ssm_scan_fused_bwd_kernel", "k7_bwd")):
        monkeypatch.setattr(mod, name, counting(getattr(mod, name), key))
    return calls


@pytest.mark.parametrize("arch", STATEFUL_ARCHS)
def test_stateful_train_step_launches_through_the_functions(arch,
                                                             monkeypatch):
    """One remat step of each stateful family: ssm runs SSMScanFusedFn's
    forward once a layer and again in the recompute, its backward once a
    layer, K2 on each layer's norm the same way plus the final norm, and no
    K3 and no unfused K7 entry (no (B,T,D,N) a or b is made); the hybrid runs K3 once a segment (and again in the recompute, its
    backward once), K2 on each Mamba2 layer's two norms (ln, the gated
    norm) and the shared block's two a segment, and no K7."""
    from repro_torch.kernels import ssm_scan as k7
    calls = _counting_launches(monkeypatch)
    monkeypatch.setattr(k7, "ssm_scan_fused_kernel", lambda *a: pytest.fail(
        "the loss called the fused scan kernel outside SSMScanFusedFn"))
    for name in ("ssm_scan_kernel", "ssm_scan_ckpt_kernel",
                 "ssm_scan_bwd_kernel"):
        monkeypatch.setattr(k7, name, lambda *a, name=name: pytest.fail(
            f"the loss called the unfused {name}"))
    tcfg = reduced_config(get_config(arch))
    step, opt = make_train_step(tcfg, topt.AdamWConfig(), remat=True,
                                device="cpu")
    params = build_model(tcfg, "cpu").init(0)
    b = TokenPipeline(tcfg.vocab, 16, 2).batch_at(0)
    step(params, opt.init(params), {k: torch.from_numpy(v)
                                    for k, v in b.items()})
    n = tcfg.n_layers
    if tcfg.family == "ssm":
        want = {"fa_fwd": 0, "fa_bwd": 0, "rn_fwd": 2 * n + 1,
                "rn_bwd": n + 1, "k7_fwd": 2 * n, "k7_bwd": n}
    else:
        segs = n // tcfg.hybrid.attn_every
        norms = 2 * n + 2 * segs
        want = {"fa_fwd": 2 * segs, "fa_bwd": segs, "rn_fwd": 2 * norms + 1,
                "rn_bwd": norms + 1, "k7_fwd": 0, "k7_bwd": 0}
    assert calls == want, calls


# -- trainer -----------------------------------------------------------------------

def _tcfg(**kw):
    return TrainerConfig(**{"seq_len": 32, "global_batch": 2, **kw})


def test_trainer_loss_decreases():
    cfg = reduced_config(get_config("qwen3-0.6b"))
    res = Trainer(cfg, _tcfg(seq_len=64, global_batch=4, steps=15,
                             log_every=1), device="cpu").train()
    losses = [e["loss"] for e in res["log"]]
    assert len(losses) == 15 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch", STATEFUL_ARCHS)
def test_stateful_trainer_loss_decreases(arch):
    """15 steps under the CLI's schedule (one warm-up step, then a cosine
    from 1e-3): the default config's 100 warm-up steps keep the rate
    under 5e-5 for all of them."""
    from repro_torch.launch.train import opt_config
    cfg = reduced_config(get_config(arch))
    res = Trainer(cfg, _tcfg(seq_len=64, global_batch=4, steps=15,
                             log_every=1), opt_config(1e-3, 15),
                  device="cpu").train()
    losses = [e["loss"] for e in res["log"]]
    assert len(losses) == 15 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def _restart_replays_bitwise(arch, opt_state):
    cfg = reduced_config(get_config(arch))
    ocfg = topt.AdamWConfig(warmup_steps=2, total_steps=12,
                            state_dtype=opt_state)
    with tempfile.TemporaryDirectory() as d:
        res = Trainer(cfg, _tcfg(steps=12, checkpoint_every=4, log_every=1,
                                 workdir=d), ocfg, device="cpu").train(
            fail_at=9)
        assert res["final_step"] == 12
        assert [s for s, _ in list_checkpoints(d)][-1] == 12
    clean = Trainer(cfg, _tcfg(steps=12, checkpoint_every=100, log_every=1),
                    ocfg, device="cpu").train()
    assert res["log"][-1]["step"] == clean["log"][-1]["step"] == 11
    assert res["log"][-1]["loss"] == clean["log"][-1]["loss"]
    for a, b in zip(leaves(res["state"]["params"]),
                    leaves(clean["state"]["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt_state", ["f32", "int8"])
def test_trainer_recovers_from_failure_bitwise(opt_state):
    """A failure at step 9 restores step 8 and replays: the final loss is
    the clean run's, bit for bit (the reference bounds the gap at 5e-3)."""
    _restart_replays_bitwise("qwen3-0.6b", opt_state)


@pytest.mark.parametrize("arch", STATEFUL_ARCHS)
def test_stateful_trainer_recovers_from_failure_bitwise(arch):
    """The same replay for the ssm family (int8 moments, as its full width
    trains) and the hybrid (f32 moments)."""
    _restart_replays_bitwise(arch, "int8" if arch == "falcon-mamba-7b"
                             else "f32")


def test_trainer_refuses_a_mesh_and_unported_families():
    """A 1x1 ``TrainMesh`` is accepted (mesh training is ported, ROADMAP
    A10b); the families whose mesh training waits for ROADMAP A10d raise
    on it, naming A10d."""
    from repro_torch.launch.mesh import make_train_mesh, process_group
    with tempfile.TemporaryDirectory() as d, \
            process_group(0, 1, "gloo", os.path.join(d, "store")):
        mesh = make_train_mesh(1, 1)
        tr = Trainer(reduced_config(get_config("qwen3-0.6b")), _tcfg(),
                     mesh=mesh, device="cpu")
        assert tr.mesh is mesh
        for arch in ("falcon-mamba-7b", "zamba2-2.7b", "whisper-small"):
            with pytest.raises(NotImplementedError, match="A10d"):
                Trainer(reduced_config(get_config(arch)), _tcfg(),
                        mesh=mesh, device="cpu")


def _train_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_train_cli_runs():
    out = _train_cli("--device", "cpu", "--smoke", "--steps", "3",
                     "--seq-len", "32", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "done at step 3" in out.stdout


@pytest.mark.parametrize("arch", STATEFUL_ARCHS)
def test_train_cli_runs_stateful(arch):
    out = _train_cli("--arch", arch, "--device", "cpu", "--smoke",
                     "--steps", "3", "--seq-len", "32", "--batch", "2")
    assert out.returncode == 0, out.stderr
    assert "done at step 3" in out.stdout


def test_train_state_that_cannot_fit_raises_and_names_int8():
    """falcon-mamba-7b's weights, gradients and f32 moments reckon 87.3 GB,
    more than an 80 GB card holds (85.5e9 bytes): the CLI raises before
    allocating and names --opt-state int8, whose 43.9 GB fit; it does not
    switch on its own."""
    from repro_torch.launch import train as cli
    cfg = get_config("falcon-mamba-7b")
    card = 85_520_809_984
    assert round(cli.state_bytes(cfg, "f32") / 1e9, 1) == 87.3
    with pytest.raises(ValueError, match="--opt-state int8") as info:
        cli.check_state_fits(cfg, "f32", card)
    assert "87.3 GB" in str(info.value)
    cli.check_state_fits(cfg, "int8", card)
    cli.check_state_fits(get_config("zamba2-2.7b"), "f32", card)


# -- bridge ------------------------------------------------------------------------

def test_train_state_roundtrip_f32():
    jcfg, tcfg, jparams, _ = bridged_params("qwen3-0.6b")
    jo = jopt.AdamW(jopt.AdamWConfig())
    jstate = jax.tree.map(np.asarray, {"params": jparams,
                                       "opt": jo.init(jparams)})
    tstate = bridge.train_state_from_numpy(jstate)
    assert int(tstate["opt"]["step"]) == 0
    back = bridge.train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _aligned_cfg(jax_side):
    """The reduced qwen3 widened so every layer's slice of every moment is
    whole int8 blocks of 256."""
    import dataclasses
    base = jax_reduced_config(jax_get_config("qwen3-0.6b")) if jax_side \
        else reduced_config(get_config("qwen3-0.6b"))
    return dataclasses.replace(base, d_model=256, head_dim=256, d_ff=256)


def test_train_state_roundtrip_int8():
    """int8 moments cross exactly (payload and scales) when each layer's
    slice is whole blocks, both ways; where a block straddles two layers
    the bridge raises."""
    jcfg = _aligned_cfg(True)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    moment = lambda p, k: jopt.quantize(jnp.sin(  # noqa: E731
        k * jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape), 256)
    jostate = {"step": jnp.asarray(3, jnp.int32),
               "m": jax.tree.map(lambda p: moment(p, 0.1), jparams),
               "v": jax.tree.map(lambda p: moment(p, 0.7), jparams)}
    jstate = jax.tree.map(np.asarray, {"params": jparams, "opt": jostate})
    tstate = bridge.train_state_from_numpy(jstate)
    m0 = tstate["opt"]["m"]["layers"][1]["attn"]["wq"]
    assert isinstance(m0, topt.Quantized) and m0.q.dtype == torch.int8
    back = bridge.train_state_to_numpy(tstate)
    is_q = lambda x: isinstance(x, (jopt.Quantized, topt.Quantized))  # noqa
    flat = lambda t: [y for x in jax.tree.leaves(t, is_leaf=is_q)  # noqa
                      for y in ((x.q, x.scale) if is_q(x) else (x,))]
    for a, b in zip(flat(back), flat(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reduced widths put two layers' norms into one block
    jcfg2, _, jp2, _ = bridged_params("qwen3-0.6b")
    jo2 = jopt.AdamW(jopt.AdamWConfig(state_dtype="int8"))
    with pytest.raises(ValueError, match="straddle"):
        bridge.train_state_from_numpy(jax.tree.map(
            np.asarray, {"params": jp2, "opt": jo2.init(jp2)}))


# -- fault tolerance ---------------------------------------------------------------

def test_straggler_detector_flags_a_slow_step():
    from repro_torch.distributed.fault_tolerance import StragglerDetector
    d = StragglerDetector(threshold=3.0)
    assert not any(d.record(i, 1.0) for i in range(10))
    assert d.record(10, 10.0)
    assert [(e.step, e.duration, e.median) for e in d.events] == \
        [(10, 10.0, 1.0)]


def test_fault_tolerant_loop_replays_train_steps_from_a_checkpoint():
    """``FaultTolerantLoop`` over the port's train step and checkpoints: a
    step that fails once restores the latest checkpoint and replays, ending
    on the clean loop's parameters bit for bit; a failure that persists is
    raised after ``max_retries``."""
    from repro_torch.distributed.fault_tolerance import FaultTolerantLoop
    cfg = reduced_config(get_config("qwen3-0.6b"))
    step_fn, opt = make_train_step(cfg, topt.AdamWConfig(warmup_steps=1),
                                   device="cpu")
    pipe = TokenPipeline(cfg.vocab, 16, 2, seed=2)

    def batch_fn(step):
        return {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}

    def run(d, crash_at):
        def step(state, i, batch):
            if i in crash_at:
                crash_at.remove(i)
                raise RuntimeError("node lost")
            p, o, _ = step_fn(state["params"], state["opt"], batch)
            return {"params": p, "opt": o}

        def restore(state):
            r = restore_latest(d, state)
            return None if r is None else (r[0], r[1]["step"])
        params = build_model(cfg, "cpu").init(0)
        loop = FaultTolerantLoop(step, lambda s, i: save_checkpoint(d, i, s),
                                 restore)
        state, n = loop.run({"params": params, "opt": opt.init(params)}, 0,
                            6, checkpoint_every=2, batch_fn=batch_fn)
        return state, n, loop
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        failed, n, loop = run(d1, [5])
        clean, _, _ = run(d2, [])
    assert n == 6 and (loop.failures, loop.restores) == (1, 1)
    for a, b in zip(leaves(failed["params"]), leaves(clean["params"])):
        assert torch.equal(a, b)

    def always(state, i, batch):
        raise RuntimeError("permanent")
    with pytest.raises(RuntimeError, match="permanent"):
        FaultTolerantLoop(always, lambda s, i: None, lambda s: None,
                          max_retries=2).run(None, 0, 3)
