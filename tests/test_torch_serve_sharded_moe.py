"""MoE on the port's serve mesh, on the CPU: ``gloo`` ranks from
``launch.mesh.spawn_ranks`` serve reduced olmoe-1b-7b at worlds 1, 2 and 4
and reduced llama4-maverick-400b-a17b (dense and MoE layers, a shared
expert) at worlds 1 and 2.  One rank group a (arch, world) runs every check
(``tests/_torch_mesh_ranks.py::sharded_moe_world``); the tests read its
results.

The KV pool sharded on kv-heads, and tensor-parallel expert stacks in
identity mode (``wi_gate``/``wi_up`` column-parallel on ``d_ff_expert``,
``wo`` row-parallel, the router replicated), give the port's single-device
engine's tokens and the JAX engine's greedy tokens on the same bridged
weights, under REPRO_MOE_DECODE=gather and dispatch.  Reduce-scatter
prefill logits are fp32-close where no routing choice flipped (the flips
are counted apart).  A ``step`` fault seeded alike on every rank
quarantines the same request on every rank, as one device does under the
same fault; a fault on one rank only raises on every rank."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from benchmarks.bench_serve import _workload
from repro.configs.base import get_config, reduced_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.launch.mesh import spawn_ranks

torch.set_num_threads(1)

FAULT = "step:after=5"
CASES = [("olmoe-1b-7b", 1), ("olmoe-1b-7b", 2), ("olmoe-1b-7b", 4),
         ("llama4-maverick-400b-a17b", 1), ("llama4-maverick-400b-a17b", 2)]
# a short collective timeout: the one-rank fault must raise, not hang
COLLECTIVE_S = 60.0


def _jax_tokens(jcfg, jparams, reqs, decode):
    os.environ["REPRO_MOE_DECODE"] = decode
    try:
        jeng = JServeEngine(jcfg, jparams, max_batch=4, max_len=64,
                            block_size=8, plan_kernels=False, mesh=False,
                            fault_injector=False)
        for r in reqs:
            jeng.submit(r)
        jeng.run_until_done()
    finally:
        os.environ.pop("REPRO_MOE_DECODE", None)
    return {r.rid: list(r.out) for r in reqs}


@pytest.fixture(scope="module")
def setups():
    """Per arch: the JAX weights (numpy), the reference's workload made
    greedy (8 requests, every third sharing a prefix) as records, and the
    JAX engine's tokens under each decode path."""
    out = {}
    for arch in sorted({a for a, _ in CASES}):
        jcfg = reduced_config(get_config(arch))
        jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        records = [(r.rid, list(r.prompt), r.max_new, 0.0, 0, 0)
                   for r in _workload(jcfg, 8)]
        jax_tokens = {decode: _jax_tokens(jcfg, jparams, [
            dataclasses.replace(r, sampling=dataclasses.replace(
                r.sampling, temperature=0.0, top_k=0))
            for r in _workload(jcfg, 8)], decode)
            for decode in ("gather", "dispatch")}
        toks = np.random.default_rng(7).integers(
            1, jcfg.vocab, size=16).tolist()
        out[arch] = (jax.tree.map(np.asarray, jparams), records, jax_tokens,
                     toks)
    return out


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def world(request, setups):
    arch, n = request.param
    np_params, records, jax_tokens, toks = setups[arch]
    outs = spawn_ranks(ranks.sharded_moe_world, n,
                       args=(arch, np_params, records, toks, FAULT),
                       collective_timeout_s=COLLECTIVE_S)
    return arch, n, outs, jax_tokens


def test_moe_mesh_tokens_match_plain_and_jax(world):
    """KV-only and TP-identity engines: every rank's greedy tokens equal
    the single-device engine's and the JAX engine's, request by request,
    under REPRO_MOE_DECODE=gather and dispatch."""
    arch, n, outs, jax_tokens = world
    for decode in ("gather", "dispatch"):
        plain = outs[0][f"plain_{decode}"]
        assert plain == jax_tokens[decode], decode
        for out in outs:
            for mode in ("kv", "tp"):
                r = out[f"{mode}_{decode}"]
                assert r["tokens"] == plain, (out["rank"], mode, decode)
                assert r["invariants"] == []


def test_moe_mesh_shards_heads_and_experts(world):
    """Each rank's slab holds KV/n heads; TP stores a rank's 1/n of every
    expert stack (wi_gate/wi_up on d_ff_expert, wo on its rows) and of the
    attention, the router whole; a rank's param bytes fall to about 1/n of
    the whole, all of them at world 1 and without TP."""
    arch, n, outs, _ = world
    cfg = reduced_config(get_config(arch))
    f = cfg.moe.d_ff_expert
    e, d = cfg.moe.n_experts, cfg.d_model
    for out in outs:
        kv, tp = out["kv_gather"], out["tp_gather"]
        assert kv["slab"][-2] == cfg.n_kv_heads // n
        per, total = tp["bytes"]
        assert kv["bytes"] == (total, total)
        lo, hi = {1: (1.0, 1.0), 2: (0.5, 0.56), 4: (0.25, 0.31)}[n]
        assert lo <= per / total <= hi, per / total
        if n > 1:
            assert tp["experts"] == {"router": None,
                                     "wi_gate": (2, (e, d, f // n)),
                                     "wi_up": (2, (e, d, f // n)),
                                     "wo": (1, (e, f // n, d))}


def test_moe_reduce_scatter_logits_are_fp32_close(world):
    """Reduce-scatter prefill logits (two chunks, the second attending the
    first's pages) within rtol 1e-4 / atol 1e-5 of the replicated forward
    at every position before the first token whose expert set flipped in
    any layer (routing is discontinuous; the flips are counted); identity
    mode bitwise the replicated forward, with no flip."""
    arch, n, outs, _ = world
    for out in outs:
        lg = out["logits"]
        assert out["flips_id"] == ([], 0)
        assert np.array_equal(lg["id"], lg["ref"])
        flipped, count = out["flips_rs"]
        first = flipped[0] if flipped else lg["ref"].shape[-2] * 2
        ref = lg["ref"].reshape(-1, lg["ref"].shape[-1])
        rs = lg["rs"].reshape(-1, lg["rs"].shape[-1])
        assert first >= 8 or not flipped, flipped
        np.testing.assert_allclose(rs[:first], ref[:first], rtol=1e-4,
                                   atol=1e-5)
        assert count <= 2, out["flips_rs"]
        assert np.array_equal(lg["rs"], outs[0]["logits"]["rs"])


def test_moe_step_fault_quarantines_alike_on_every_rank(world):
    """``step:after=5`` seeded alike on every rank: every rank quarantines
    the same request, counts one crash, and serves the rest with the tokens
    one device gives under the same fault (KV-only and TP)."""
    arch, n, outs, _ = world
    want = outs[0]["fault_plain"]
    assert len(want["errored"]) == 1 and want["invariants"] == []
    for out in outs:
        for mode in ("fault_kv", "fault_tp"):
            r = out[mode]
            assert r["errored"] == want["errored"], (out["rank"], mode)
            assert r["tokens"] == want["tokens"], (out["rank"], mode)
            assert r["crashes"] == 1 and not r["degraded"]
            assert r["invariants"] == []


ONE_RANK_TIMEOUT_S = 5.0


def test_moe_fault_on_one_rank_raises_on_every_rank(setups):
    """The fault on rank 1 of 2 only cannot be isolated: rank 1 crashes at
    dispatch entry and waits in the step's closing gather, rank 0 in the
    model call's first collective (the head all-gather of a KV-only
    engine); each times out (a group of its own, with a 5 s collective
    timeout), rank 0's timeout is its crash, and every rank ends with an
    error within a few timeouts; no rank quarantines a request."""
    np_params, records, _, _ = setups["olmoe-1b-7b"]
    outs = spawn_ranks(ranks.one_rank_fault, 2,
                       args=("olmoe-1b-7b", np_params, records, FAULT),
                       collective_timeout_s=ONE_RANK_TIMEOUT_S)
    for out in outs:
        assert out["raised"] is not None, out
        assert out["errored"] == [], out
        assert out["seconds"] < 8 * ONE_RANK_TIMEOUT_S + 30, out
