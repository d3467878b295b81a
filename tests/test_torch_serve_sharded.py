"""Multi-device serving of the port on the CPU: ``gloo`` ranks from
``launch.mesh.spawn_ranks``, at worlds 1, 2 and 4, on reduced qwen3-0.6b
widened to 4/4 heads (the reference's ``pod_setup``: its GQA kv=2 cannot
split 4 ways).  One rank group a world runs every check
(``tests/_torch_mesh_ranks.py``); the tests read its results.

The contracts of ``tests/test_serve_sharded.py`` and the pod tests of
``tests/test_param_sharding.py``: the engine with its KV pool sharded on
kv-heads, and with tensor-parallel weights in identity mode, gives the
tokens of the port's single-device engine and of the JAX single-device
engine on the same bridged weights; reduce-scatter mode is fp32-close;
swap preemption resumes bitwise; the ranks stay in step under deadlines
and rank-0-only submissions, and a planted divergence raises on every
rank instead of hanging."""
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

WIDE = {"n_kv_heads": 4}


@pytest.fixture(scope="module")
def setup():
    """The widened config's JAX weights (numpy), the reference's
    12-request workload (every third sampled, every third sharing a
    9-token prefix) as records, and the JAX engine's tokens."""
    jcfg = dataclasses.replace(reduced_config(get_config("qwen3-0.6b")),
                               **WIDE)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    reqs = _workload(jcfg, 12)
    records = [(r.rid, list(r.prompt), r.max_new, r.sampling.temperature,
                r.sampling.top_k, r.sampling.seed) for r in reqs]
    jeng = JServeEngine(jcfg, jparams, max_batch=4, max_len=64, block_size=8,
                        plan_kernels=False, mesh=False, fault_injector=False)
    for r in reqs:
        jeng.submit(r)
    jeng.run_until_done()
    jax_tokens = {r.rid: list(r.out) for r in reqs}
    toks = np.random.default_rng(7).integers(1, jcfg.vocab, size=16).tolist()
    return jax.tree.map(np.asarray, jparams), records, jax_tokens, toks


@pytest.fixture(scope="module", params=[1, 2, 4])
def world(request, setup):
    np_params, records, jax_tokens, toks = setup
    outs = spawn_ranks(ranks.sharded_world, request.param,
                       args=(np_params, WIDE, records, toks))
    return request.param, outs, jax_tokens


def test_sharded_engine_tokens_match_plain_and_jax(world):
    """KV-sharded and TP-identity engines: every rank's tokens equal the
    port's single-device engine's and the JAX engine's, request by
    request (greedy and sampled)."""
    n, outs, jax_tokens = world
    plain = outs[0]["plain"]
    assert plain == jax_tokens
    for out in outs:
        assert out["kv"]["tokens"] == plain, f"rank {out['rank']} kv"
        assert out["tp"]["tokens"] == plain, f"rank {out['rank']} tp"
        assert out["rs"]["tokens"] == outs[0]["rs"]["tokens"]


def test_sharded_pool_holds_its_heads_and_shares_prefixes(world):
    """Each rank's slab is (L, N, bs, KV/n, hd), contiguous; prefix
    sharing survives sharding; the invariants hold after every step on
    every rank and the pool drains."""
    n, outs, _ = world
    for out in outs:
        for mode in ("kv", "tp", "rs"):
            r = out[mode]
            assert r["slab"] == (2, 33, 8, 4 // n, 16), r["slab"]
            assert r["contiguous"] and r["invariants"] == []
            assert r["re_prefill_avoided"] > 0
            assert r["released"] > 0 and r["pool_used"] == 0
            assert r["mesh_devices"] == n
        assert out["kv"]["tp_devices"] == 1
        assert out["tp"]["tp_devices"] == n
        assert not out["tp"]["reduce_scatter"] and out["rs"]["reduce_scatter"]


def test_tp_stores_a_rank_share_of_the_weights(world):
    """Column-parallel q/k/v, row-parallel wo; the replicated norms keep a
    rank's bytes at [0.25, 0.30] of the whole at world 4 (the reference's
    bound), about half at world 2, all of it at world 1."""
    n, outs, _ = world
    for out in outs:
        per, total = out["tp"]["bytes"]
        assert out["kv"]["bytes"] == (total, total)
        ratio = per / total
        bounds = {1: (1.0, 1.0), 2: (0.5, 0.55), 4: (0.25, 0.30)}[n]
        assert bounds[0] <= ratio <= bounds[1], ratio
        if n > 1:
            assert out["tp"]["layout"] == {"wq": 1, "wk": 1, "wv": 1,
                                           "wo": 0, "q_norm": None,
                                           "k_norm": None}


def test_reduce_scatter_prefill_logits_are_fp32_close(world):
    """Two prefill chunks (the second attending the first's pages) on the
    rank's stored layout: reduce-scatter within rtol 1e-4 / atol 1e-5 of
    the replicated forward, identity mode equal to it."""
    n, outs, _ = world
    for out in outs:
        lg = out["logits"]
        np.testing.assert_allclose(lg["rs"], lg["ref"], rtol=1e-4, atol=1e-5)
        assert np.array_equal(lg["id"], lg["ref"])
        assert np.array_equal(lg["rs"], outs[0]["logits"]["rs"])


def test_swap_preemption_resumes_bitwise(world):
    """Optimistic overcommit on the sharded pool: each rank parks its head
    slice on its own host tier and restores it; the tokens equal each
    request served alone on one device."""
    n, outs, _ = world
    for out in outs:
        for mode in ("swap_kv", "swap_tp"):
            r = out[mode]
            assert r["preemptions"] >= 1 and r["swap"][0] > 0
            assert r["swap"][0] == r["swap"][1]
            assert r["invariants"] == []
            assert r["tokens"] == outs[0]["solo"], (out["rank"], mode)


def test_deadlines_and_rank0_submissions_stay_in_step(world):
    """REPRO_SERVE_DEADLINE_MS set on rank 0 only, two submissions and a
    cancel between steps on rank 0, a stall past the deadline: every rank
    ends every request the same way, by rank 0's clock."""
    n, outs, _ = world
    reasons = outs[0]["deadline"]["reasons"]
    assert set(reasons) == {0, 1, 2, 3, 4, 5, 100, 101}
    assert reasons[101] == "cancelled"
    assert "length" in reasons.values() and "expired" in reasons.values()
    for out in outs:
        assert out["deadline"]["reasons"] == reasons
        assert out["deadline"]["invariants"] == []


def test_mesh_refusals(world):
    """Adapters, the ssm, hybrid and moe families are refused on a mesh;
    only rank 0 submits; a mesh that does not divide the kv heads is
    rejected naming n_kv_heads."""
    n, outs, _ = world
    for out in outs:
        ref = out["refusals"]
        assert ref["load_adapter"].startswith("NotImplementedError")
        for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
            assert ref[arch].startswith("NotImplementedError: sharded "
                                        "serving of the ssm/hybrid"), ref
        assert ref["olmoe-1b-7b"].startswith("NotImplementedError") \
            and "A10c" in ref["olmoe-1b-7b"]
        if out["rank"] == 0:
            assert ref["submit_adapter"].startswith("NotImplementedError")
        else:
            assert ref["submit_follower"].startswith("RuntimeError")
        if n == 1:
            assert ref["kv3"] == ref["kv2"] == "built"
        else:
            assert ref["kv3"].startswith("ValueError") \
                and "n_kv_heads=3" in ref["kv3"]
            assert (ref["kv2"] == "built") == (n == 2)


def test_serve_knobs_on_a_mesh(world):
    """REPRO_SERVE_MESH auto / N / 0, REPRO_SERVE_TP and
    REPRO_TP_REDUCE_SCATTER build the engine they name: (model-axis width,
    tp, reduce-scatter)."""
    n, outs, _ = world
    for out in outs:
        k = out["knobs"]
        assert k["REPRO_SERVE_MESH=auto"] == (n, False, False)
        assert k[f"REPRO_SERVE_MESH={n}"] == (n, False, False)
        assert k[f"REPRO_SERVE_MESH={n + 1}"].startswith("ValueError")
        assert k["REPRO_SERVE_MESH=0"] == (0, False, None)
        assert k["REPRO_SERVE_MESH=auto REPRO_SERVE_TP=1"] == (n, True, False)
        assert k["REPRO_SERVE_MESH=auto REPRO_SERVE_TP=1 "
                 "REPRO_TP_REDUCE_SCATTER=1"] == (n, True, True)


def test_planted_divergence_raises_on_every_rank(world):
    """Rank 1 samples another token: the step's plan digests differ and
    every rank raises MeshDivergence at that step, none hangs.  A 1-rank
    mesh has no second rank to plant it on."""
    n, outs, _ = world
    if n == 1:
        assert "diverged" not in outs[0]
        return
    for out in outs:
        assert out["diverged"] is not None \
            and "diverged" in out["diverged"], out["diverged"]
        assert out["diverged"].split(":")[1] == outs[0]["diverged"] \
            .split(":")[1]


def test_serve_cli_mesh_and_tp_on_cpu(capsys):
    """``launch/serve.py --device cpu --smoke --mesh 2 --tp 2``: two gloo
    ranks, equal tokens on both, a rank's half of the weights printed."""
    from repro_torch.launch import serve
    outs = serve.main(["--smoke", "--device", "cpu", "--mesh", "2", "--tp",
                       "2", "--requests", "3", "--max-new", "4",
                       "--block-size", "4"])
    assert len(outs) == 2 and outs[0]["tokens"] == outs[1]["tokens"]
    assert len(outs[0]["tokens"]) == 3
    m = outs[0]["metrics"]
    assert m["mesh_devices"] == m["tp_devices"] == 2
    text = capsys.readouterr().out
    assert "2 ranks over gloo on cpu" in text and "tensor parallel x2" in text
    with pytest.raises(SystemExit, match="one device"):
        serve.main(["--smoke", "--device", "cpu", "--arch",
                    "falcon-mamba-7b", "--mesh", "2"])


def test_spawn_ranks_reports_a_dead_rank_and_leaves_no_process():
    """A rank that ends without a result fails ``spawn_ranks`` with its
    exit code, and the process that spawned the ranks leaves nothing
    running when it exits: no rank, no fork server, no resource tracker
    (``tools/session_leftovers.py`` lists what its session left)."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    script = (
        "import _torch_mesh_ranks as ranks\n"
        "from repro_torch.launch.mesh import spawn_ranks\n"
        "try:\n"
        "    spawn_ranks(ranks.dies, 2)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "tests"), str(root / "src"), str(root)]))
    run = subprocess.run(
        [sys.executable, "-m", "tools.session_leftovers", "--",
         sys.executable, "-c", script], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert "raised: rank 1 exited with code 3 and no result" in run.stdout, \
        (run.stdout, run.stderr)
    last = run.stdout.strip().splitlines()[-1]
    assert last.startswith("session_leftovers: rc=0 left="), last
    assert json.loads(last.split("left=", 1)[1]) == [], last
    assert run.returncode == 0, run.stdout
