"""The port's MoE family against the JAX package on the CPU: the router,
capacity dispatch, the expert FFN and both decode paths of
``models/moe.py``; the transformer's MoE branches (layer kinds, the
slot-major cache rows, the load-balance term of ``lm_loss``) through the
dense oracle, the paged functions and the loss's gradients; the bridge and
the train-state bridge; the engine and the trainer on reduced olmoe-1b-7b.

Two reduced archs: olmoe-1b-7b (every layer MoE, top-2 of 4 experts) and
llama4-maverick-400b-a17b at 4 layers (a dense layer of width d_ff_dense,
then an MoE layer, top-1 with a shared expert, twice: n_super = 2, so the
slot-major cache rows differ from the forward order).  Same seeded weights
(the reference's ``init`` through ``bridge``) and numpy inputs on both
sides; tolerances are ``_torch_parity``'s, relative to the reference's
largest value, and routing indices and dispatch buffers are equal.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)

# arch -> layers of its reduced config here
MOE_ARCHS = {"olmoe-1b-7b": 2, "llama4-maverick-400b-a17b": 4}
# capacity_factor at which no token drops at these lengths (capacity >=
# tokens needs factor >= n_experts), as tests/test_models_smoke.py uses
NO_DROP = 16.0


def _cfgs(arch, factor=None):
    jcfg, tcfg = reduced(arch)
    kw = {"n_layers": MOE_ARCHS[arch]}
    out = []
    for c in (jcfg, tcfg):
        moe = c.moe if factor is None \
            else dataclasses.replace(c.moe, capacity_factor=factor)
        out.append(dataclasses.replace(c, moe=moe, **kw))
    return out


@lru_cache(maxsize=None)
def _bridged(arch, seed=0, factor=None):
    """(JAX cfg, port cfg, JAX params, port params) on the same weights,
    built once per arguments (every caller only reads them)."""
    jcfg, tcfg = _cfgs(arch, factor)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _moe_params(arch, seed=0, factor=None):
    """One MoE layer's weights from the reference's ``init_moe``, f32."""
    jcfg, tcfg = _cfgs(arch, factor)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)

    def port(tree):
        if isinstance(tree, dict):
            return {k: port(v) for k, v in tree.items()}
        return bridge.tensor_from_numpy(np.asarray(tree))
    return jcfg, tcfg, jp, port(jp)


def _x(cfg, b, s, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, cfg.d_model)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_route_matches_jax(arch):
    """Softmax, top-k (renormalised when k > 1), the aux loss from the first
    choice: gates and aux within tolerance, the indices equal."""
    jcfg, tcfg, jp, tp = _moe_params(arch)
    x = _x(jcfg, 3, 11)
    jg, ji, ja = jmoe._route(jcfg, jp, jnp.asarray(x))
    tg, ti, ta = tmoe._route(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_close(tg, jg, MODULE_TOL, "gates")
    assert_close(ta, ja, MODULE_TOL, "aux")
    assert tg.dtype == ta.dtype == torch.float32


def test_route_runs_in_f32_in_a_bf16_model():
    """A bf16 activation is routed in f32 against the f32 router: the same
    indices and gates as routing its f32 copy."""
    _, tcfg, _, tp = _moe_params("olmoe-1b-7b")
    x = torch.from_numpy(_x(tcfg, 2, 7)).to(torch.bfloat16)
    g, i, a = tmoe._route(tcfg, tp, x)
    g32, i32, a32 = tmoe._route(tcfg, tp, x.float())
    assert torch.equal(i, i32) and torch.equal(g, g32) and torch.equal(a, a32)
    assert g.dtype == torch.float32


@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_route_gates_follow_the_selected_experts(arch, monkeypatch):
    """``_select`` only picks: with its picks replaced (each token's experts
    in reverse order of probability), ``_route`` returns those indices,
    their probabilities as gates (renormalised when k > 1) and the aux
    loss of the replaced first choice, computed as the JAX ``_route``
    computes them from the same picks."""
    jcfg, tcfg, jp, tp = _moe_params(arch)
    x = _x(jcfg, 2, 9)
    real = tmoe._select
    monkeypatch.setattr(tmoe, "_select", lambda probs, k: real(
        probs, probs.shape[-1]).flip(-1)[..., :k])
    g, i, a = tmoe._route(tcfg, tp, torch.from_numpy(x))
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    want_i = np.argsort(np.asarray(probs), axis=-1, kind="stable")[
        ..., :tcfg.moe.top_k]
    np.testing.assert_array_equal(i.numpy(), want_i)
    want_g = np.take_along_axis(np.asarray(probs), want_i, -1)
    if tcfg.moe.top_k > 1:
        want_g = want_g / want_g.sum(-1, keepdims=True)
    first = jax.nn.one_hot(want_i[..., 0], tcfg.moe.n_experts)
    want_a = tcfg.moe.n_experts * jnp.sum(
        first.mean(axis=(0, 1)) * probs.mean(axis=(0, 1)))
    assert_close(g, want_g, MODULE_TOL, "gates")
    assert_close(a, want_a, MODULE_TOL, "aux")


def test_dispatch_one_matches_jax():
    """At a capacity that drops (12 tokens, 4 experts, capacity 2): the
    buffer, the destinations and the keep mask are equal."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 8)).astype(np.float32)
    idx = rng.integers(0, 4, size=(2, 12)).astype(np.int32)
    jb, jd, jk = jmoe._dispatch_one(jnp.asarray(x), jnp.asarray(idx), 4, 2)
    tb, td, tk = tmoe._dispatch_one(torch.from_numpy(x),
                                    torch.from_numpy(idx), 4, 2)
    assert not np.asarray(jk).all(), "the case must drop tokens"
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("factor", [None, NO_DROP], ids=["native", "no-drop"])
@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_apply_moe_matches_jax(arch, factor):
    """The prefill/train MoE (per-slot dispatch, the expert FFN, the
    gathered and gated sum, the shared expert) and its aux loss, at the
    arch's native capacity factor (tokens drop) and at one where none
    does."""
    jcfg, tcfg, jp, tp = _moe_params(arch, seed=2, factor=factor)
    x = _x(jcfg, 2, 13, seed=4)
    jy, ja = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, ta = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    assert_close(ty, jy, MODULE_TOL, "y")
    assert_close(ta, ja, MODULE_TOL, "aux")


@pytest.mark.parametrize("mode", ["gather", "dispatch"])
@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_apply_moe_decode_matches_jax(arch, mode):
    """Both decode paths against the reference's, at the native factor (the
    dispatch path's capacity drops some of 6 tokens)."""
    jcfg, tcfg, jp, tp = _moe_params(arch, seed=3)
    x = _x(jcfg, 6, 1, seed=5, scale=0.3)
    jfn = {"gather": jmoe.apply_moe_decode,
           "dispatch": jmoe.apply_moe_decode_dispatch}[mode]
    tfn = {"gather": tmoe.apply_moe_decode,
           "dispatch": tmoe.apply_moe_decode_dispatch}[mode]
    assert_close(tfn(tcfg, tp, torch.from_numpy(x)),
                 jfn(jcfg, jp, jnp.asarray(x)), MODULE_TOL, mode)


def test_moe_decode_dispatch_matches_gather():
    """Both decode paths compute the same result where capacity drops
    nothing (the port of tests/test_perf_knobs.py's)."""
    _, tcfg, _, tp = _moe_params("olmoe-1b-7b", factor=64.0)
    x = torch.from_numpy(_x(tcfg, 4, 1, seed=1, scale=0.1))
    torch.testing.assert_close(tmoe.apply_moe_decode_dispatch(tcfg, tp, x),
                               tmoe.apply_moe_decode(tcfg, tp, x),
                               rtol=2e-4, atol=2e-4)


def test_apply_moe_backward_reaches_x_and_every_weight():
    """The scatter is out of place into zeros: autograd reaches x, the
    router (through the gates and the aux loss) and the expert stacks."""
    _, tcfg, _, tp = _moe_params("llama4-maverick-400b-a17b", seed=1)
    tp = map_tree(lambda t: t.requires_grad_(), tp)
    x = torch.from_numpy(_x(tcfg, 2, 5)).requires_grad_()
    y, aux = tmoe.apply_moe(tcfg, tp, x)
    (y.square().sum() + aux).backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    for p in leaves(tp):
        assert p.grad is not None and p.grad.abs().sum() > 0


def test_expert_stacks_drawn_in_slices():
    """The port's own init: f32 router, (E,d,f)/(E,f,d) stacks in the
    model's dtype, each expert's slice a separate truncated-normal draw
    within [-2, 2] of its scale."""
    _, tcfg = _cfgs("llama4-maverick-400b-a17b")
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(cfg, gen, torch.bfloat16, "cpu")
    m = cfg.moe
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (cfg.d_model, m.n_experts)
    assert p["wi_gate"].shape == (m.n_experts, cfg.d_model, m.d_ff_expert)
    assert p["wo"].shape == (m.n_experts, m.d_ff_expert, cfg.d_model)
    assert p["wi_up"].dtype == torch.bfloat16 and "shared" in p
    bound = 2.0 / np.sqrt(cfg.d_model) * 1.01
    assert float(p["wi_gate"].float().abs().max()) <= bound
    assert not torch.equal(p["wi_gate"][0], p["wi_gate"][1])


# ---------------------------------------------------------------------------
# models/transformer.py
# ---------------------------------------------------------------------------

def test_layer_kinds_and_slot_major_cache_rows():
    """llama4 at 4 layers: forward order dense, moe, dense, moe (the
    dense FFN at d_ff_dense); cache rows slot-major, [0, 2, 1, 3]; the
    port's own init and the bridged JAX init give the same layout."""
    jcfg, tcfg, _, params = _bridged("llama4-maverick-400b-a17b")
    kinds = ["moe" if "moe" in lp else "dense" for lp in params["layers"]]
    assert kinds == ["dense", "moe", "dense", "moe"]
    assert [ttf.cache_row(tcfg, i) for i in range(4)] == [0, 2, 1, 3]
    assert params["layers"][0]["mlp"]["wi_gate"].shape[1] \
        == tcfg.moe.d_ff_dense
    own = build_model(tcfg, "cpu").init(0)
    for a, b in zip(own["layers"], params["layers"]):
        assert sorted(a) == sorted(b)
        assert [t.shape for t in leaves(a)] == [t.shape for t in leaves(b)]
    ocfg = _cfgs("olmoe-1b-7b")[1]
    assert [ttf.cache_row(ocfg, i) for i in range(2)] == [0, 1]


PROMPT = [3, 5, 7, 11, 13, 17, 19, 23, 29]
FORCED = [31, 37, 41, 43]


@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_dense_oracle_logits_and_caches_match_jax(arch):
    """lm_prefill (whole prompt, native factor) and teacher-forced
    lm_decode_step (the gather path): logits per step, and the dense
    caches, slot-major, equal through the bridge."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    s = len(PROMPT)
    cap = s + len(FORCED)
    jc, jl = jtf.lm_prefill(jcfg, jparams,
                            {"tokens": jnp.asarray([PROMPT], jnp.int32)})
    tc, tl = ttf.lm_prefill(tcfg, tparams, {"tokens": torch.tensor([PROMPT])})
    assert_close(tl, jl, LOGITS_TOL, "prefill logits")
    for k in ("k", "v"):
        assert_close(tc[k], jc[k], MODULE_TOL, f"prefill {k} cache")
    jcache = jtf.make_decode_cache(jcfg, 1, cap, jnp.float32)
    jcache = {k: v.at[:, :, :s].set(jc[k]) for k, v in jcache.items()}
    tcache = ttf.make_decode_cache(tcfg, 1, cap, torch.float32, "cpu")
    for k in tcache:
        tcache[k][:, :, :s] = tc[k]
    for i, tok in enumerate(FORCED):
        jcache, jl = jtf.lm_decode_step(
            jcfg, jparams, jcache, {"token": jnp.asarray([[tok]], jnp.int32),
                                    "cur_len": jnp.int32(s + i)})
        tcache, tl = ttf.lm_decode_step(
            tcfg, tparams, tcache, {"token": torch.tensor([[tok]]),
                                    "cur_len": s + i})
        assert_close(tl, jl, LOGITS_TOL, f"decode step {i}")
    for k in ("k", "v"):
        assert_close(tcache[k], np.asarray(jcache[k]), MODULE_TOL,
                     f"decoded {k} cache")


@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_paged_logits_and_caches_match_jax(arch):
    """lm_prefill_chunk (3-token chunks: capacity per chunk, native factor)
    and teacher-forced lm_decode_step_paged with a dead second row (the
    default decode path, gather): logits per call and the paged caches
    afterwards (null block excluded), equal through the bridge."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    bs, n, c = 4, 8, 3
    table = np.asarray([[4, 2, 6, 0]], np.int32)
    jcache = jtf.make_paged_cache(jcfg, n, bs, jnp.float32)
    tcache = ttf.make_paged_cache(tcfg, n, bs, torch.float32, "cpu")
    plen = len(PROMPT)
    for start in range(0, plen, c):
        end = min(plen, start + c)
        chunk = PROMPT[start:end] + [0] * (c - (end - start))
        m_used = -(-end // bs)
        jcache, jl = jtf.lm_prefill_chunk(
            jcfg, jparams, jcache,
            {"tokens": jnp.asarray([chunk], jnp.int32),
             "block_table": jnp.asarray(table), "start": jnp.int32(start),
             "prompt_len": jnp.int32(end)}, m_used=m_used)
        tcache, tl = ttf.lm_prefill_chunk(
            tcfg, tparams, tcache,
            {"tokens": torch.tensor([chunk]),
             "block_table": torch.from_numpy(table), "start": start,
             "prompt_len": end}, m_used=m_used)
        real = end - start
        assert_close(tl[:, :real], np.asarray(jl)[:, :real], LOGITS_TOL,
                     f"chunk at {start}")
    tables = np.concatenate([table, np.zeros_like(table)])
    for i, tok in enumerate(FORCED):
        batch = {"token": np.asarray([[tok], [0]], np.int32),
                 "block_tables": tables,
                 "seq_lens": np.asarray([plen + i, 0], np.int32)}
        jcache, jl = jtf.lm_decode_step_paged(
            jcfg, jparams, jcache,
            {k: jnp.asarray(v) for k, v in batch.items()})
        tcache, tl = ttf.lm_decode_step_paged(
            tcfg, tparams, tcache,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_close(tl[:1], np.asarray(jl)[:1], LOGITS_TOL, f"decode {i}")
    back = bridge.paged_cache_to_numpy(tcache)
    for k in ("k", "v"):
        assert_close(back[k][:, 1:], np.asarray(jcache[k])[:, 1:],
                     MODULE_TOL, f"paged {k} cache")


@lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    """The reference's loss, its gradients and its summed aux (remat off)
    on a seeded batch, computed once per arch."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    rng = np.random.default_rng(9)
    toks = rng.integers(1, jcfg.vocab, size=(2, 17)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_build_model(jcfg).loss(
            p, {k: jnp.asarray(v) for k, v in b.items()},
            remat=False)))(jparams)
    _, jaux = jtf.forward_hidden(
        jcfg, jparams, jparams["embed"]["embed"][jnp.asarray(b["tokens"])],
        jnp.broadcast_to(jnp.arange(16)[None], (2, 16)))
    return tcfg, tparams, b, float(jloss), float(jaux), \
        bridge.params_from_numpy(jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("remat", ["off", "dots", "nothing"])
@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_lm_loss_and_grads_match_jax(arch, remat, monkeypatch):
    """``lm_loss`` (cross-entropy plus 0.01 times the summed aux, carried
    through the rematerialised layers) and every gradient leaf, the
    routers' included, against ``jax.value_and_grad`` of the reference's
    loss (remat off there)."""
    tcfg, tparams, b, jloss, jaux, jgrads = _jax_value_and_grad(arch)
    if remat != "off":
        monkeypatch.setenv("REPRO_REMAT_POLICY", remat)
    params = map_tree(lambda t: t.clone().requires_grad_(), tparams)
    emb = params["embed"]["embed"][torch.from_numpy(b["tokens"]).long()]
    _, taux = ttf.forward_hidden(tcfg, params, emb.detach(), torch.arange(
        16)[None].expand(2, 16))
    assert_close(taux.detach(), np.float32(jaux), MODULE_TOL, "aux")
    assert float(taux.detach()) > 0
    loss = build_model(tcfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()},
        remat=remat != "off")
    loss.backward()
    assert_close(loss.detach(), np.float32(jloss), MODULE_TOL, "loss")
    want = leaves(jgrads)
    got = leaves(map_tree(lambda p: p.grad, params))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w.numpy(), MODULE_TOL, f"grad leaf {i}")


def test_paged_lora_on_moe_adapts_attention_only_and_matches_jax():
    """llama4 at 4 layers with a tenant's descriptor: the adapter store
    holds the four attention projections only, its slab rows are in
    forward order on both sides, and a prompt chunk and a decode step
    under the tenant give the JAX functions' logits."""
    from repro.serve.adapters import AdapterStore as JAdapterStore
    from repro_torch.serve.adapters import AdapterStore
    jcfg, tcfg, jparams, tparams = _bridged("llama4-maverick-400b-a17b")
    jst, tst = JAdapterStore(jcfg), AdapterStore(tcfg, device="cpu")
    slot = [st.load("tenant-a", rank=4) for st in (jst, tst)][1]
    assert sorted(tst.projs) == ["k", "o", "q", "v"]
    jl = {"ids": jnp.asarray([slot], jnp.int32), "slabs": jst.slabs()}
    tl = {"ids": torch.tensor([slot], dtype=torch.int32),
          "slabs": tst.slabs()}
    bs, c = 4, 6
    table = np.asarray([[1, 2, 3, 0]], np.int32)
    jcache = jtf.make_paged_cache(jcfg, 5, bs, jnp.float32)
    tcache = ttf.make_paged_cache(tcfg, 5, bs, torch.float32, "cpu")
    jcache, jlog = jtf.lm_prefill_chunk(
        jcfg, jparams, jcache, {"tokens": jnp.asarray([PROMPT[:c]], jnp.int32),
                                "block_table": jnp.asarray(table),
                                "start": jnp.int32(0),
                                "prompt_len": jnp.int32(c), "lora": jl},
        m_used=2)
    tcache, tlog = ttf.lm_prefill_chunk(
        tcfg, tparams, tcache, {"tokens": torch.tensor([PROMPT[:c]]),
                                "block_table": torch.from_numpy(table),
                                "start": 0, "prompt_len": c, "lora": tl,
                                "lora_block_out": 16}, m_used=2)
    assert_close(tlog, np.asarray(jlog), LOGITS_TOL, "chunk")
    batch = {"token": np.asarray([[PROMPT[c]]], np.int32),
             "block_tables": table, "seq_lens": np.asarray([c], np.int32)}
    _, jlog = jtf.lm_decode_step_paged(
        jcfg, jparams, jcache,
        dict({k: jnp.asarray(v) for k, v in batch.items()}, lora=jl))
    _, tlog = ttf.lm_decode_step_paged(
        tcfg, tparams, tcache,
        dict({k: torch.from_numpy(v) for k, v in batch.items()}, lora=tl,
             lora_block_out=16))
    assert_close(tlog, np.asarray(jlog), LOGITS_TOL, "decode")


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_moe_params_round_trip_bitwise(arch):
    """``params_to_numpy(family="moe", every=cfg.moe.every)`` gives back
    the reference's tuple of (L/every, ...) stacks, expert stacks
    (L/every, E, d, f) included, bit for bit."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    back = bridge.params_to_numpy(tparams, every=tcfg.moe.every,
                                  family="moe")
    want = jax.tree.map(np.asarray, jparams)
    assert len(back["layers"]) == tcfg.moe.every
    flat_b, tree_b = jax.tree.flatten(back)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_b == tree_w
    for a, b in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_moe_train_state_round_trip(state_dtype):
    """A reference train state of llama4 (4 layers, d_model widened to 256
    so every layer's slice of every moment is whole int8 blocks of 256;
    expert moments (2, E, d, f) a kind) crosses to the port and back bit
    for bit, f32 and int8 moments (payload and scales); at the reduced
    width, where a norm's blocks straddle layers, int8 moments raise."""
    from repro.train import optimizer as jopt
    from repro_torch.train.optimizer import Quantized
    jcfg, tcfg = (dataclasses.replace(c, d_model=256)
                  for c in _cfgs("llama4-maverick-400b-a17b"))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))

    def moment(p, k):
        x = jnp.sin(k * jnp.arange(p.size, dtype=jnp.float32)).reshape(
            p.shape)
        return jopt.quantize(x, 256) if state_dtype == "int8" else x
    host = jax.tree.map(np.asarray, {"params": jparams, "opt": {
        "step": jnp.asarray(3, jnp.int32),
        "m": jax.tree.map(lambda p: moment(p, 0.1), jparams),
        "v": jax.tree.map(lambda p: moment(p, 0.7), jparams)}})
    port = bridge.train_state_from_numpy(host)
    assert len(port["params"]["layers"]) == 4
    m = port["opt"]["m"]["layers"][3]["moe"]["wi_gate"]
    assert isinstance(m, Quantized) == (state_dtype == "int8")
    back = bridge.train_state_to_numpy(port, every=tcfg.moe.every)
    is_q = lambda x: isinstance(x, (jopt.Quantized, Quantized))  # noqa
    flat = lambda t: [y for x in jax.tree.leaves(t, is_leaf=is_q)  # noqa
                      for y in ((x.q, x.scale) if is_q(x) else (x,))]
    assert len(flat(back)) == len(flat(host))
    for a, b in zip(flat(back), flat(host)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if state_dtype == "int8":
        jcfg2, _, jp2, _ = _bridged("llama4-maverick-400b-a17b")
        jo2 = jopt.AdamW(jopt.AdamWConfig(state_dtype="int8"))
        with pytest.raises(ValueError, match="straddle"):
            bridge.train_state_from_numpy(jax.tree.map(
                np.asarray, {"params": jp2, "opt": jo2.init(jp2)}))


# ---------------------------------------------------------------------------
# engine, trainer, CLIs
# ---------------------------------------------------------------------------

MAX_LEN, BLOCK_SIZE = 48, 8


def _requests(cfg, sampled=False, n=3, max_new=5):
    from repro_torch.serve.engine import Request, SamplingParams
    rng = np.random.default_rng(7)
    reqs = []
    for i, plen in enumerate([3, 9, 17, 12][:n]):
        sp = SamplingParams(temperature=0.8, top_k=40, seed=100 + i) \
            if sampled else SamplingParams()
        reqs.append(Request(rid=i, prompt=rng.integers(
            1, cfg.vocab, size=plen).tolist(), max_new=max_new, sampling=sp))
    return reqs


def _engine(cfg, params, **kw):
    from repro_torch.serve.engine import ServeEngine
    kw = dict(dict(max_batch=2, max_len=MAX_LEN, block_size=BLOCK_SIZE,
                   fault_injector=False, prefill_chunk_tokens=4), **kw)
    return ServeEngine(cfg, params, **kw)


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.step():
        assert eng.check_invariants() == []
    assert all(r.done and not r.rejected for r in reqs)
    return [list(r.out) for r in reqs]


def test_moe_greedy_tokens_equal_the_jax_engine():
    """olmoe at its native capacity factor (chunks drop tokens as the
    reference's do): the port's engine and the JAX engine, on the same
    bridged weights and chunk size, emit the same greedy tokens and
    prefill the same number of prompt tokens."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    jcfg, tcfg, jparams, tparams = _bridged("olmoe-1b-7b")
    eng = _engine(tcfg, tparams)
    reqs = _requests(tcfg, n=4, max_new=6)
    _serve(eng, reqs)
    jeng = JServeEngine(jcfg, jparams, plan_kernels=False, mesh=False,
                        fault_injector=False, max_batch=2, max_len=MAX_LEN,
                        block_size=BLOCK_SIZE, prefill_chunk_tokens=4)
    jreqs = [JRequest(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
             for r in reqs]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert eng.metrics().prefill_tokens == jeng.metrics().prefill_tokens


def _oracle(cfg, params, req):
    from repro_torch.serve.engine import ServeEngine
    fns = build_model(cfg, "cpu")
    cache, logits = fns.prefill(params, {"tokens": torch.tensor([req.prompt])})
    big = fns.make_cache(1, MAX_LEN)
    for k in ("k", "v"):
        big[k][:, :, :len(req.prompt)] = cache[k]
    out = [ServeEngine._sample(logits[0].numpy(), req.sampling, 0)]
    for i in range(req.max_new - 1):
        big, lg = fns.decode_step(params, big, {
            "token": torch.tensor([[out[-1]]]),
            "cur_len": len(req.prompt) + i})
        out.append(ServeEngine._sample(lg[0].numpy(), req.sampling,
                                       len(out)))
    return out


@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_moe_preemption_by_swap_resumes(arch):
    """At a no-drop factor, a request preempted mid-generation parks its KV
    blocks on the host tier and resumes token-identical to the dense
    oracle (llama4: slot-major rows swapped and restored)."""
    _, tcfg, _, tparams = _bridged(arch, factor=NO_DROP)
    eng = _engine(tcfg, tparams, max_batch=3)
    reqs = _requests(tcfg, sampled=True)
    for r in reqs:
        eng.submit(r)
    forced = None
    while eng.step():
        assert eng.check_invariants() == []
        mid = [s for s in eng.slots if s is not None and len(s.req.out) >= 2]
        if forced is None and mid:
            victim = max(mid, key=lambda s: len(s.req.out))
            eng._requeue(victim)
            forced = victim.req.rid
            assert eng.check_invariants() == []
    assert forced is not None
    m = eng.metrics()
    assert m.preemptions >= 1 and m.swap_out_blocks >= 1 \
        and m.swap_in_blocks >= 1
    for r in reqs:
        assert r.out == _oracle(tcfg, tparams, r), r.rid
    eng.release_prefix_cache()
    assert eng.pool.num_used == 0 and eng.store.host.num_used == 0


def test_moe_adapter_requests_adapt_attention_only():
    """An olmoe engine serves tenants: a dispatch with an adapter row calls
    the fused delta op once per attention projection and layer (4 x L;
    no MLP LoRA on an MoE layer), a real tenant changes the tokens and a
    rank-0 tenant gives the base tokens bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    _, tcfg, _, tparams = _bridged("olmoe-1b-7b", factor=NO_DROP)
    prompt = [3, 5, 7, 11, 13, 17, 19, 23]
    [base] = _serve(_engine(tcfg, tparams),
                    [Request(rid=0, prompt=list(prompt), max_new=6)])
    eng = _engine(tcfg, tparams)
    eng.load_adapter("tenant-a", rank=4, alpha=64.0)
    eng.load_adapter("null-tenant", rank=0)
    assert sorted(eng.adapters.projs) == ["k", "o", "q", "v"]
    calls, dispatches = [0], [0]
    real = ops.lora_delta

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    fns = eng.fns

    def decode(p, c, b):
        dispatches[0] += "lora" in b
        return fns.decode_paged(p, c, b)
    eng.fns = dataclasses.replace(fns, decode_paged=decode)
    ops.lora_delta = counted
    try:
        [adapted] = _serve(eng, [Request(rid=1, prompt=list(prompt),
                                         max_new=6, adapter_id="tenant-a")])
        decode_calls = calls[0]
        [null] = _serve(eng, [Request(rid=2, prompt=list(prompt), max_new=6,
                                      adapter_id="null-tenant")])
    finally:
        ops.lora_delta = real
    prefills = -(-len(prompt) // eng.prefill_chunk_tokens)
    assert decode_calls == 4 * tcfg.n_layers * (dispatches[0] // 2 + prefills)
    assert adapted != base
    assert null == base


def test_moe_trainer_three_steps():
    """Reduced olmoe through the ``Trainer`` (the port of
    tests/test_integration.py's non-dense family run): 3 steps, finite
    loss."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduced_config(get_config("olmoe-1b-7b"))
    res = Trainer(cfg, TrainerConfig(seq_len=16, global_batch=2, steps=3,
                                     log_every=1), device="cpu").train()
    assert res["final_step"] == 3
    assert all(np.isfinite(e["loss"]) for e in res["log"])


def test_moe_cli_train_and_serve_on_cpu(capsys):
    """``launch.train`` and ``launch.serve`` with ``--arch olmoe-1b-7b
    --smoke --device cpu``."""
    from repro_torch.launch import serve, train
    res = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "16", "--batch", "2"])
    assert res["final_step"] == 2
    eng = serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "4"])
    assert eng.metrics().requests_finished == 3
    assert eng.check_invariants() == []
    assert "device cpu" in capsys.readouterr().out


def test_olmoe_full_width_state_reckoning():
    """The train CLI's reckoning at full width: 6.92 B parameters, f32
    moments 83.0 GB (within an 85.0 GB card, with about 2 GB to spare),
    int8 moments 41.7 GB."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import check_state_fits, state_bytes
    cfg = get_config("olmoe-1b-7b")
    assert round(cfg.param_count() / 1e9, 2) == 6.92
    assert round(state_bytes(cfg, "f32") / 1e9, 1) == 83.0
    assert round(state_bytes(cfg, "int8") / 1e9, 1) == 41.7
    check_state_fits(cfg, "f32", int(85.0e9))
    with pytest.raises(ValueError, match="int8"):
        check_state_fits(cfg, "f32", int(80.0e9))
