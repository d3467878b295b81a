"""The port's examples (``examples/*_torch.py``, ROADMAP A15) on the CPU at
``--device cpu --smoke``, held to the JAX package where the reference
example computes something: the quickstart's packed program against its
logical term, its recompile a cache hit, and its loss equal to the JAX
``fns.loss`` on the reference's weights (bridged) and tokens; serve_lm's
greedy requests token for token the JAX engine's on those weights; train_lm's
loss falling, and its run with a failure ending on the uninterrupted run's
loss bit for bit; compile_inspect with and without ``--pipeline-only``; and
every example refusing ``cuda`` on a host without a card."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import SamplingParams as JaxSamplingParams
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs.base import get_config, reduced_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import compile_inspect_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_lm_torch  # noqa: E402
import train_lm_torch  # noqa: E402

torch.set_num_threads(1)

SMOKE = ["--device", "cpu", "--smoke"]


def _jax_qwen():
    """The reduced qwen3-0.6b's JAX functions and seed-0 weights, and the
    weights bridged to the port."""
    jcfg = jax_reduced_config(jax_get_config("qwen3-0.6b"))
    fns = jax_build_model(jcfg)
    params = fns.init(jax.random.PRNGKey(0))
    return jcfg, fns, params, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params))


def test_quickstart_matches_its_logical_term_and_the_jax_loss():
    """The packed Fig. 3 program within 1e-4 of its logical term's largest
    value, the recompile a cache hit, Auto Distribution's cap respected,
    and the loss of the reduced qwen3-0.6b finite; on the reference's
    weights and tokens that loss is the JAX ``fns.loss``'s within 1e-5."""
    out = quickstart_torch.main(SMOKE)
    pipe = out["pipeline"]
    assert pipe["rel_err"] < 1e-4, pipe
    assert pipe["cache_hit"] and pipe["pack_ops"] > 0 and pipe["unpack_ops"]
    assert pipe["matmul_launches"] == 0          # the CPU's plain version
    assert out["distribute"]["capped_peak"] <= 25_000_000 \
        < out["distribute"]["free_peak"]
    assert out["schedule"]["latency"] <= out["schedule"]["baseline_latency"]
    assert np.isfinite(out["train_step"]["loss"])
    _, fns, params, tparams = _jax_qwen()
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                              reduced_config(get_config("qwen3-0.6b")).vocab)
    want = float(fns.loss(params, {"tokens": toks, "labels": toks},
                          remat=False))
    got = quickstart_torch.demo_train_step(
        torch.device("cpu"), True, params=tparams,
        tokens=torch.from_numpy(np.array(toks)))["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_serve_lm_greedy_tokens_equal_the_jax_engine():
    """The eight requests on the reference's weights: every one finishes
    with its 12 tokens, the KV invariants hold, and the greedy ones are the
    JAX engine's tokens on the same prompts."""
    jcfg, _, params, tparams = _jax_qwen()
    cfg = reduced_config(get_config("qwen3-0.6b"))
    out = serve_lm_torch.serve(cfg, tparams)
    assert sorted(out["outputs"]) == list(range(8))
    assert all(len(t) == 12 for t in out["outputs"].values())
    assert out["kv_violations"] == []
    assert out["greedy"] == [0, 2, 4, 6]
    eng = JaxServeEngine(jcfg, params, max_batch=4, max_len=64, block_size=8)
    for r in serve_lm_torch.requests(cfg.vocab):
        sp = r.sampling
        eng.submit(JaxRequest(rid=r.rid, prompt=list(r.prompt),
                              max_new=r.max_new,
                              sampling=JaxSamplingParams(
                                  temperature=sp.temperature,
                                  top_k=sp.top_k, seed=sp.seed)))
    want = {r.rid: list(r.out) for r in eng.run_until_done()}
    for rid in out["greedy"]:
        assert out["prompts"][rid] == list(
            serve_lm_torch.requests(cfg.vocab)[rid].prompt)
        assert out["outputs"][rid] == want[rid], rid


def test_train_lm_loss_falls_and_the_restart_replays_bitwise(tmp_path):
    """15 steps checkpointed every 4, a failure at step 10: the run
    restores step 8, replays, and ends on the loss of 15 uninterrupted
    steps bit for bit, below its first."""
    cfg = reduced_config(get_config("qwen3-0.6b"))
    got = train_lm_torch.train(cfg, 15, "cpu", str(tmp_path / "fail"),
                               checkpoint_every=4)
    want = train_lm_torch.train(cfg, 15, "cpu", str(tmp_path / "clean"),
                                fail=False, checkpoint_every=4)
    assert (got["fail_at"], got["restored_step"]) == (10, 8)
    assert got["final_step"] == want["final_step"] == 15
    assert got["last"] == want["last"]
    assert got["last"] < got["first"]


@pytest.mark.parametrize("pipeline_only", [True, False])
def test_compile_inspect_reports_and_counts_a_cell(pipeline_only, tmp_path):
    """The attention block's report with its program equal to the logical
    term's within 1e-4; without ``--pipeline-only`` qwen3-0.6b's
    ``decode_32k`` cell on pod1 counted on meta in this process, its file
    written to ``--out``."""
    argv = SMOKE + ["--out", str(tmp_path)] \
        + (["--pipeline-only"] if pipeline_only else [])
    out = compile_inspect_torch.main(argv)
    assert out["pipeline"]["rel_err"] < 1e-4
    assert "modeled:" in out["pipeline"]["summary"]
    if pipeline_only:
        assert "dryrun" not in out and not list(tmp_path.iterdir())
        return
    cell = out["dryrun"]
    assert cell["status"] == "ok" and cell["kind"] == "decode"
    assert cell["devices"] == 256 and cell["fits"]
    assert (tmp_path / "qwen3-0.6b__decode_32k__pod1.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("example", [quickstart_torch, serve_lm_torch,
                                     train_lm_torch, compile_inspect_torch],
                         ids=lambda m: m.__name__)
def test_an_example_without_a_card_refuses_cuda(example, tmp_path):
    """``--device cuda`` (the default) on a host without a card raises, as
    ``device.resolve_device`` does, before anything runs."""
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        example.main(["--workdir", str(tmp_path)]
                     if example is train_lm_torch else [])
