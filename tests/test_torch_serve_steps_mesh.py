"""The prefill and decode steps on a training mesh
(``launch.steps.make_prefill_step(mesh=)`` / ``make_decode_step(mesh=)``,
ROADMAP A13b) on gloo ranks on the CPU, for every family: a prompt
prefilled and four tokens decoded after it, held to the port's single
device (bit for bit on a 1x1 mesh; within 1e-4 on 2x1, 1x2, 2x2, on 1x4,
where the reduced configs' kv heads do not split and the cache is
sequence-parallel over "model", and at batch 1 on 2x1 and 2x2, the
sequence over "data" as in ``long_500k``), the dense and ssm families'
2x2 runs held to the JAX package's one-device ``make_prefill_step`` and
``make_decode_step`` on the same weights, and the dry run's virtual mesh
issuing the ranks' collectives."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_ranks as sr
from repro.configs import base as jbase
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dry_train_mesh, spawn_ranks

torch.set_num_threads(1)

FAMILY_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "qwen2-vl-72b",
                "falcon-mamba-7b", "zamba2-2.7b", "whisper-small")
TOL = 1e-4


def _jobs(meshes, batch=4, tag=""):
    return [sr.Job(f"{arch}_{d}x{m}{tag}", arch=arch, mesh=(d, m),
                   batch=batch)
            for d, m in meshes for arch in FAMILY_ARCHS]


ONE = _jobs([(1, 1)])
TWO = _jobs([(2, 1), (1, 2)]) + _jobs([(2, 1)], batch=1, tag="_b1")
# olmoe's decode by capacity dispatch (REPRO_MOE_DECODE=dispatch): the
# group is the global batch's, gathered over "data"
FOUR = _jobs([(2, 2), (1, 4)]) + _jobs([(2, 2)], batch=1, tag="_b1") + [
    sr.Job("olmoe-1b-7b_2x2_dispatch", arch="olmoe-1b-7b", mesh=(2, 2),
           env=(("REPRO_MOE_DECODE", "dispatch"),))]
JAX_ARCHS = ("qwen3-0.6b", "falcon-mamba-7b")


def _jax_init(arch):
    """The JAX package's reduced weights of ``arch`` (seed 0) as numpy."""
    jcfg = jbase.reduced_config(jbase.get_config(arch))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _jax_jobs():
    return [sr.Job(f"jax_{arch}_2x2", arch=arch, mesh=(2, 2),
                   init=_jax_init(arch)) for arch in JAX_ARCHS]


@pytest.fixture(scope="module")
def gloo_runs():
    """rank 0's results of every job: one spawn a world size."""
    out = {}
    for world, jobs in ((1, ONE), (2, TWO), (4, FOUR + _jax_jobs())):
        out.update(spawn_ranks(sr.serve_world, world, args=(jobs,))[0])
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _compare(got, want, tol, what):
    """Every logits row set and every cache leaf within ``tol`` of its
    largest value (0 for bitwise)."""
    pairs = [("prefill logits", got["prefill_logits"],
              want["prefill_logits"])]
    pairs += [(f"decode step {i}", a, b) for i, (a, b) in enumerate(
        zip(got["decode_logits"], want["decode_logits"]))]
    for c in ("prefill_cache", "cache"):
        assert set(got[c]) == set(want[c]), (what, c)
        pairs += [(f"{c} {k}", got[c][k], want[c][k]) for k in want[c]]
    assert len(got["decode_logits"]) == len(want["decode_logits"])
    for name, a, b in pairs:
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if tol == 0:
            assert np.array_equal(a, b), (what, name)
        else:
            err = _rel(a, b)
            assert err <= tol, (what, name, err)


@pytest.mark.parametrize("job", ONE, ids=lambda j: j.name)
def test_a_one_rank_mesh_is_one_device_bit_for_bit(job, gloo_runs):
    _compare(gloo_runs[job.name], sr.run_one(job), 0, job.name)


@pytest.mark.parametrize("job", TWO + FOUR, ids=lambda j: j.name)
def test_mesh_steps_match_one_device(job, gloo_runs):
    """Logits of the prefill and of each decode step, the prefill's cache
    and the cache after the last step (each gathered whole from the
    ranks' blocks) within 1e-4 of one device's."""
    _compare(gloo_runs[job.name], sr.run_one(job), TOL, job.name)


def test_the_layouts_cover_both_sequence_parallel_branches():
    """The jobs reach each ``cache_specs`` branch of the K/V leaves: kv
    heads over "model", the sequence over "model" (1x4: 2 kv heads over 4
    ranks) and over "data" (batch 1)."""
    from repro_torch.distributed import sharding
    from repro_torch.models.model_zoo import abstract_cache
    seen = set()
    for job in TWO + FOUR:
        cfg = sr.job_cfg(job)
        if cfg.family == "ssm":
            continue
        mesh = dry_train_mesh({"data": job.mesh[0], "model": job.mesh[1]})
        spec = sharding.cache_specs(
            cfg, abstract_cache(cfg, job.batch, job.cap), mesh)["k"]
        seen.add(spec[-3:-1])
    assert {(None, "model"), ("model", None), ("data", "model")} <= seen, \
        seen


def _jax_run(arch, job):
    """The JAX package's one-device prefill and decode steps on the job's
    inputs: the same values ``run_one`` gives."""
    jcfg = jbase.reduced_config(jbase.get_config(arch))
    params = jax.tree.map(jnp.asarray, job.init)
    inp = sr.inputs(sr.job_cfg(job), job)
    cache, logits = jax_make_prefill_step(jcfg)(
        params, {"tokens": jnp.asarray(inp["tokens"])})
    out = {"prefill_logits": np.asarray(logits),
           "prefill_cache": {k: np.asarray(v) for k, v in cache.items()}}
    big = jax_build_model(jcfg).make_cache(job.batch, job.cap)
    big = {k: v.at[tuple(slice(0, n) for n in cache[k].shape)].set(cache[k])
           for k, v in big.items()}
    decode = jax_make_decode_step(jcfg)
    steps = []
    for i in range(job.steps):
        batch = {"token": jnp.asarray(inp["forced"][i])}
        if jcfg.family != "ssm":
            batch["cur_len"] = jnp.int32(job.prompt + i)
        big, logits = decode(params, big, batch)
        steps.append(np.asarray(logits))
    out["decode_logits"] = steps
    out["cache"] = {k: np.asarray(v) for k, v in big.items()}
    return out


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_the_mesh_steps_match_the_jax_package(arch, gloo_runs):
    """The port's prefill and decode steps on a 2x2 mesh against the JAX
    package's on one device (its own mesh runs fail under this jax), on
    the JAX package's weights bridged: within 1e-4."""
    job = next(j for j in _jax_jobs() if j.arch == arch)
    _compare(gloo_runs[job.name], _jax_run(arch, job), TOL, job.name)


@pytest.mark.parametrize("job", TWO + FOUR, ids=lambda j: j.name)
def test_the_virtual_mesh_issues_the_gloo_ranks_collectives(job,
                                                           gloo_runs):
    """A prefill at the job's batch and prompt and a decode step over its
    cache's capacity, counted by the dry run on a ``DryTrainMesh`` of the
    job's shape on meta, issue rank 0's collectives (calls and bytes, by
    kind) in its prefill and its first decode step."""
    cfg = sr.job_cfg(job)
    want = gloo_runs[job.name]["issued"]
    with sr.knobs(job.env):
        _count_both(cfg, job, want)


def _count_both(cfg, job, want):
    for kind, count, spec in (
            ("prefill", dryrun.count_prefill_step,
             ShapeSpec("p", job.prompt, job.batch, "prefill")),
            ("decode", dryrun.count_decode_step,
             ShapeSpec("d", job.cap, job.batch, "decode"))):
        mesh = dry_train_mesh({"data": job.mesh[0], "model": job.mesh[1]})
        count(cfg, spec, mesh)
        got = mesh.issued
        for k, v in want[kind].items():
            assert got[k][:2] == v[:2], (job.name, kind, k, got, want)


def test_check_mesh_serves_refuses_what_does_not_split(monkeypatch):
    """A split the family cannot make is refused before anything is
    allocated, as ``check_mesh_trains`` refuses it; so is a train shape,
    and REPRO_TRAIN_SHARDING=dp."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import check_mesh_serves
    cfg = sr.job_cfg(sr.Job("x", arch="zamba2-2.7b"))
    bad = dataclasses.replace(cfg, d_model=72)
    with pytest.raises(ValueError, match="do not split over a model axis"):
        check_mesh_serves(bad, dry_train_mesh({"data": 1, "model": 4}),
                          SHAPES["decode_32k"])
    check_mesh_serves(cfg, dry_train_mesh({"data": 1, "model": 4}),
                      SHAPES["decode_32k"])
    with pytest.raises(ValueError, match="not a prefill or decode"):
        check_mesh_serves(cfg, dry_train_mesh({"data": 1, "model": 1}),
                          SHAPES["train_4k"])
    monkeypatch.setenv("REPRO_TRAIN_SHARDING", "dp")
    with pytest.raises(ValueError, match="fsdp_tp"):
        check_mesh_serves(cfg, dry_train_mesh({"data": 1, "model": 1}),
                          SHAPES["prefill_32k"])
