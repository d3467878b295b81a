"""Rule-driven tensor-parallel weight sharding of the port (mirrors
``tests/test_param_sharding.py`` test for test):

  * the rule machinery over every transformer arch of the zoo: total (every
    leaf claimed by one rule) and precise (norms and routers replicated,
    matmul weights on cost-model layouts), with the reference's rule lists
    (name, patterns, trailing, source) and every leaf's spec equal to the
    reference's on its own abstract params;
  * the SBP search's emitted layout (canonical column/row, fallback when
    indivisible), under the reference's device constants;
  * a 1-rank mesh TP engine in this process (a ``gloo`` group of one);
  * 4 ``gloo`` ranks (``spawn_ranks``): identity mode token-identical to
    the plain engine, a rank's bytes at [0.25, 0.30] of the whole,
    reduce-scatter logits fp32-close."""
import dataclasses
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from _torch_parity import reference_hardware
from benchmarks.bench_serve import _workload
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.distributed import param_sharding as r_ps
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.core.distribution import choose_tp_layout
from repro_torch.distributed.param_sharding import (ShardRule,
                                                    choose_tp_rules,
                                                    tp_param_specs,
                                                    validate_tp_divisibility)
from repro_torch.launch.mesh import (make_serve_mesh, process_group,
                                     spawn_ranks)
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(1)

ZOO_TRANSFORMERS = ["qwen3-0.6b", "nemotron-4-15b", "phi3-mini-3.8b",
                    "stablelm-3b", "olmoe-1b-7b",
                    "llama4-maverick-400b-a17b", "qwen2-vl-72b"]

REPLICATED_LEAVES = ("ln1", "ln2", "q_norm", "k_norm", "final_norm", "router")
REF = reference_hardware()


def _port_params(arch):
    cfg = reduced_config(get_config(arch))
    return cfg, build_model(cfg, "cpu").init(0)


def _flat(tree, path=()):
    """{"a/b/c": leaf} of nested dicts and lists (a spec, a tuple, is a
    leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


# ---------------------------------------------------------------------------
# Rule totality and precision across the model zoo (shapes only, no mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO_TRANSFORMERS)
def test_rules_cover_every_transformer_config(arch):
    """No unmatched leaf, no over-match on the port's params; the rules and
    the reference's abstract params' specs equal the reference's."""
    cfg, params = _port_params(arch)
    specs, report = tp_param_specs(cfg, params, 4)  # raises if non-total
    leaves = _flat(params)
    assert len(report) == len(leaves)
    for path, rule in report.items():
        last = path.rsplit("/", 1)[-1]
        if last in REPLICATED_LEAVES:
            assert rule.trailing == (), \
                f"{path} over-matched a sharding rule ({rule.name})"
            assert rule.source.startswith("structural"), (path, rule)
        if "/attn/" in path and last in ("wq", "wk", "wv"):
            assert rule.name == "attn_qkv" and rule.source.startswith("sbp:")
        if "/attn/" in path and last == "wo":
            assert rule.name == "attn_out" and rule.source.startswith("sbp:")
    for spec in _flat(specs).values():
        assert sum(1 for e in spec if e == "model") <= 1, spec

    jcfg = jax_reduced_config(jax_get_config(arch))
    want = r_ps.choose_tp_rules(jcfg, 4)
    got = choose_tp_rules(cfg, 4, hw=REF)
    assert [(r.name, r.patterns, r.trailing, r.source) for r in got] == \
        [(r.name, r.patterns, r.trailing, r.source) for r in want]
    abstract = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    rspecs, rreport = r_ps.tp_param_specs(jcfg, abstract, 4, rules=want)
    pspecs, preport = tp_param_specs(cfg, abstract, 4, rules=got)
    rflat = {"/".join(r_ps._path_keys(path)): tuple(spec)
             for path, spec in jax.tree_util.tree_flatten_with_path(
                 rspecs, is_leaf=lambda x: isinstance(
                     x, jax.sharding.PartitionSpec))[0]}
    assert _flat(pspecs) == rflat
    assert {p: r.name for p, r in preport.items()} == \
        {p: r.name for p, r in rreport.items()}


def test_unmatched_leaf_raises():
    """A custom rule list without the catch-all fails on the first
    unclaimed param."""
    cfg, params = _port_params("qwen3-0.6b")
    only_attn = [ShardRule("attn_qkv", ("attn", "w[qkv]"),
                           (None, "model"), "sbp:column")]
    with pytest.raises(ValueError, match="no sharding rule matched"):
        tp_param_specs(cfg, params, 4, rules=only_attn)


def test_rule_window_is_contiguous():
    """The matcher anchors on a contiguous key window: the shared-expert
    MLP under ``moe/shared`` hits the mlp rules, never the expert
    tables'."""
    cfg, params = _port_params("llama4-maverick-400b-a17b")
    _, report = tp_param_specs(cfg, params, 4)
    expert_in = [r.name for p, r in report.items()
                 if "/moe/" in p and "/shared/" not in p and "wi" in p]
    assert expert_in and set(expert_in) == {"moe_expert_in"}
    shared = [r.name for p, r in report.items() if "/shared/" in p]
    assert shared and all(n.startswith("mlp") for n in shared), shared
    routers = [r.name for p, r in report.items() if p.endswith("router")]
    assert routers and set(routers) == {"moe_router"}


def test_divisibility_validation():
    cfg = reduced_config(get_config("qwen3-0.6b"))   # GQA: kv=2
    with pytest.raises(ValueError, match="n_kv_heads"):
        validate_tp_divisibility(cfg, 4)
    validate_tp_divisibility(cfg, 1)                 # width 1 is always fine
    validate_tp_divisibility(
        dataclasses.replace(cfg, n_kv_heads=4), 4)   # widened: fine
    with pytest.raises(ValueError, match="d_ff"):
        validate_tp_divisibility(
            dataclasses.replace(cfg, n_kv_heads=4, d_ff=130), 4)


# ---------------------------------------------------------------------------
# The SBP cost-model choice itself (regression on the emitted layout)
# ---------------------------------------------------------------------------

def test_sbp_search_emits_megatron_layout():
    """Given the per-block weight-memory cap and input-traffic costs, the
    search finds column in-projections and row out-projections (one
    collective a block), under the reference's constants and the H100's."""
    for hw in (REF, None):
        kw = {} if hw is None else {"hw": hw}
        plan = choose_tp_layout(d_model=64, q_dim=64, d_ff=128, vocab=256,
                                n_model=4, **kw)
        kinds = {name: c.kind for name, c in plan.choices.items()}
        assert kinds == {"wq": "column", "wo": "row",
                         "wi": "column", "wdown": "row",
                         "wu": "column"}
        assert not plan.fallback
        assert plan.cost > 0
        # sum of per-device peaks over the three blocks: ~1/4 of the weights
        assert plan.peak_memory == 14336


def test_sbp_search_falls_back_when_indivisible():
    plan = choose_tp_layout(d_model=64, q_dim=64, d_ff=100, vocab=256,
                            n_model=3, hw=REF)
    assert set(plan.fallback) == {"attn", "mlp", "head"}
    assert all(c.kind == "replicated" for c in plan.choices.values())


def test_rules_carry_sbp_provenance():
    """choose_tp_rules translates the search result 1:1, and the tied
    embedding takes the head choice transposed onto its (vocab, d)."""
    cfg = reduced_config(get_config("qwen3-0.6b"))
    assert cfg.tie_embeddings
    by_name = {r.name: r for r in choose_tp_rules(cfg, 4)}
    assert by_name["attn_qkv"].source == "sbp:column"
    assert by_name["attn_qkv"].trailing == (None, "model")
    assert by_name["attn_out"].source == "sbp:row"
    assert by_name["attn_out"].trailing == ("model", None)
    assert by_name["mlp_in"].trailing == (None, "model")
    assert by_name["mlp_out"].trailing == ("model", None)
    # head chose column on the logical (d, vocab) -> vocab-sharded table
    assert by_name["embed_tied"].source == "sbp:column"
    assert by_name["embed_tied"].trailing == ("model", None)
    assert by_name["replicated_rest"].patterns == (".*",)


# ---------------------------------------------------------------------------
# 1-rank mesh: a gloo group of one in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg, params = _port_params("qwen3-0.6b")
    with tempfile.TemporaryDirectory() as tmp:
        with process_group(0, 1, "gloo", os.path.join(tmp, "store")):
            yield cfg, params


def _run(cfg, params, mesh, n=12, **eng_kw):
    eng = ServeEngine(cfg, params, max_batch=4, max_len=64, block_size=8,
                      plan_kernels=False, mesh=mesh, fault_injector=False,
                      **eng_kw)
    reqs = [Request(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
            for r in _workload(cfg, n)]
    for r in reqs:
        eng.submit(r)
    finished = eng.run_until_done()
    eng.close()
    assert len(finished) == n
    return [tuple(r.out) for r in reqs], eng


def test_one_device_tp_engine_matches_plain(setup):
    """tp=True on a 1-rank mesh runs the whole TP path (rule choice, the
    rank's slices, the use sites) degenerately: the same tokens, the
    per-rank bytes equal to the total."""
    cfg, params = setup
    plain, _ = _run(cfg, params, mesh=False)
    tp, eng = _run(cfg, params, mesh=make_serve_mesh(1), tp=True)
    assert tp == plain
    assert eng.tp and eng.tp_report is not None
    assert eng.tp_report["layers/0/attn/wq"].name == "attn_qkv"
    m = eng.metrics()
    assert m.tp_devices == 1
    assert m.param_bytes_per_device == m.param_bytes_replicated > 0


def test_tp_off_by_default(setup, monkeypatch):
    cfg, params = setup
    monkeypatch.delenv("REPRO_SERVE_TP", raising=False)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=4,
                      plan_kernels=False, mesh=make_serve_mesh(1))
    assert not eng.tp and eng.tp_report is None
    assert eng.metrics().tp_devices == 1


def test_serve_tp_knob(setup, monkeypatch):
    """REPRO_SERVE_TP=1 turns a mesh engine tensor-parallel; mesh=False
    stays single-device under it (the port refuses it only when no mesh
    was asked for at all, ``tests/test_torch_knobs.py``)."""
    cfg, params = setup
    monkeypatch.setenv("REPRO_SERVE_TP", "1")
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=4,
                      plan_kernels=False, mesh=make_serve_mesh(1))
    assert eng.tp and eng.tp_report is not None
    meshless = ServeEngine(cfg, params, max_batch=2, max_len=32,
                           block_size=4, plan_kernels=False, mesh=False)
    assert not meshless.tp


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pod():
    # the qwen3 smoke config's GQA kv=2 can't split 4 ways; widen to MHA 4/4
    cfg = dataclasses.replace(jax_reduced_config(jax_get_config(
        "qwen3-0.6b")), n_kv_heads=4)
    np_params = jax.tree.map(np.asarray, jax_build_model(cfg).init(
        jax.random.PRNGKey(0)))
    records = [(r.rid, list(r.prompt), r.max_new, 0.0, 0, 0)
               for r in _workload(cfg, 12)]
    toks = np.random.default_rng(7).integers(1, cfg.vocab, size=12).tolist()
    return spawn_ranks(ranks.pod_tp, 4, args=(np_params, {"n_kv_heads": 4},
                                              records, toks))


def test_pod_tp_identity_and_memory(pod):
    """Identity mode on 4 ranks is token-identical to the single-device
    engine, and each rank stores [0.25, 0.30] of the params (the norms
    stay replicated); the weights are stored column / row."""
    for out in pod:
        assert out["tp"] == pod[0]["plain"]
        assert out["invariants"] == []
        tp_devices, mesh_devices, per, total = out["metrics"]
        assert tp_devices == mesh_devices == 4
        assert 0.25 <= per / total <= 0.30, \
            f"per-rank bytes {per / total:.1%} of replicated"
        assert out["layout"]["wq"] == (1, (64, 16))
        assert out["layout"]["wo"] == (0, (16, 64))


def test_pod_tp_rejects_indivisible_config(pod):
    for out in pod:
        assert out["indivisible"].startswith("ValueError") \
            and "n_kv_heads" in out["indivisible"]


def test_pod_reduce_scatter_mode_is_fp32_close(pod):
    """REPRO_TP_REDUCE_SCATTER: prefill logits through the stored
    column/row layout (partial sums, one all_reduce each) within fp32
    tolerance of the replicated forward; identity mode exactly equal."""
    for out in pod:
        np.testing.assert_allclose(out["rs"], out["ref"], rtol=1e-4,
                                   atol=1e-5)
        assert np.array_equal(out["id"], out["ref"])
