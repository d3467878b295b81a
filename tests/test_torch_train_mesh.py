"""Training on a mesh (ROADMAP A10b) on the CPU: ``Trainer(mesh=)`` on
gloo ranks from ``launch.mesh.spawn_ranks``, one rank group a world (1, 2
and 4; the bodies in ``tests/_torch_train_ranks.py``), on reduced f32
configs, against the port's single-device ``Trainer`` and the JAX
package's.

The reference's own mesh step fails under jax 0.9 (ROADMAP C0), so a mesh
run is held to single-device runs from the same weights: every step's loss
and gradient norm within ``LOSS_TOL`` relative and every leaf after the
last step within ``LEAF_TOL`` of its largest value (AdamW divides by
sqrt(v): a gradient near zero amplifies a reordered sum); 1x1, and
REPRO_WEIGHT_AG=1 against 0, bit for bit.  The norm is the one gate that
sees a gradient of the wrong scale: AdamW with global-norm clipping makes
the same update whatever constant scale the gradients carry.  Also
checked: the losses within ``LOGITS_TOL`` of the JAX Trainer's on
the bridged weights; the differentiable collectives against their
single-rank compositions, a rank's bytes, expert parallelism with the
global load-balance term, the VLM's batch split, a replicated batch, a
restart, checkpoints moving between meshes (``elastic_remesh``), the
refusals that wait for ROADMAP A10d and the launcher's ``--mesh``."""
import os
import subprocess
import sys
import tempfile
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_train_ranks as ranks
from _torch_parity import LOGITS_TOL
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import elastic_remesh
from repro_torch.launch.mesh import (MeshShape, make_train_mesh,
                                     process_group, spawn_ranks)
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4
LEAF_TOL = 1e-3
MODES = {"fsdp_tp": (), "weight_ag": (("REPRO_WEIGHT_AG", "1"),),
         "dp": (("REPRO_TRAIN_SHARDING", "dp"),),
         "seq_parallel": (("REPRO_SEQ_PARALLEL", "1"),)}
MESHES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2)]}


def _name(kind, mesh):
    return f"{kind}_{mesh[0]}x{mesh[1]}"


@lru_cache(maxsize=None)
def jax_weights():
    """The JAX package's seed-0 weights of reduced qwen3-0.6b (numpy)."""
    jcfg = jax_reduced_config(jax_get_config("qwen3-0.6b"))
    return jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))


def qwen_jobs(world):
    """qwen3-0.6b in every mode on each mesh of ``world`` ranks, from the
    JAX package's weights."""
    return [ranks.Job(_name(kind, m), mesh=m, env=env, init=jax_weights())
            for m in MESHES[world] for kind, env in MODES.items()]


@lru_cache(maxsize=None)
def _plain(arch, batch, steps, jax_init):
    job = ranks.Job("plain", arch=arch, batch=batch, steps=steps,
                    init=jax_weights() if jax_init else None)
    return ranks.run(job)


def plain(job):
    """The job on one device: the port's single-device ``Trainer``."""
    return _plain(job.arch, job.batch, job.steps, job.init is not None)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Checkpoint directories: one device's 2 steps (for a 2x1 restore),
    a 2x2 mesh's 2 steps (for the 1x2 restore), a 2x1 restart's."""
    d = {k: str(tmp_path_factory.mktemp(k))
         for k in ("single", "elastic", "restart")}
    ranks.run(ranks.Job("single", steps=2, workdir=d["single"]),
              whole=False)
    return d


@pytest.fixture(scope="module")
def world1():
    return spawn_ranks(ranks.train_world, 1, args=(qwen_jobs(1),))


@pytest.fixture(scope="module")
def world4(dirs):
    jobs = qwen_jobs(4) + [
        ranks.Job("moe_2x2", arch="olmoe-1b-7b", mesh=(2, 2)),
        ranks.Job("elastic_2x2", mesh=(2, 2), steps=2,
                  workdir=dirs["elastic"])]
    return spawn_ranks(ranks.train_world, 4, args=(jobs,))


@pytest.fixture(scope="module")
def world2(dirs, world4):
    jobs = qwen_jobs(2) + [
        ranks.Job("batch3_2x1", mesh=(2, 1), batch=3),
        ranks.Job("dp_summed_2x1", mesh=(2, 1), plant="dp_summed",
                  env=MODES["dp"]),
        ranks.Job("replicated_summed_2x1", mesh=(2, 1), batch=3,
                  plant="replicated_summed"),
        ranks.Job("moe_1x2", arch="olmoe-1b-7b", mesh=(1, 2)),
        ranks.Job("vlm_2x1", arch="qwen2-vl-72b", mesh=(2, 1)),
        ranks.Job("clean4_2x1", mesh=(2, 1), steps=4),
        ranks.Job("restart_2x1", mesh=(2, 1), steps=4, checkpoint_every=2,
                  fail_at=3, workdir=dirs["restart"]),
        ranks.Job("from_single_2x1", mesh=(2, 1), steps=4,
                  workdir=dirs["single"]),
        ranks.Job("elastic_1x2", mesh=(1, 2), steps=4,
                  workdir=dirs["elastic"])]
    return spawn_ranks(ranks.train_world, 2, args=(jobs, True)), jobs


def _close(got, want, what):
    for key in ("losses", "grad_norms"):
        assert len(got[key]) == len(want[key]), (what, key)
        for a, b in zip(got[key], want[key]):
            assert abs(a - b) <= LOSS_TOL * abs(b), (what, key, got[key],
                                                     want[key])
    assert len(got["params"]) == len(want["params"])
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                               1e-30)
        assert err <= LEAF_TOL, (what, i, err)


def _bitwise(got, want, what):
    for key in ("losses", "grad_norms"):
        assert got[key] == want[key], (what, key, got[key], want[key])
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        assert np.array_equal(a, b), (what, i)


@lru_cache(maxsize=None)
def jax_losses():
    """The JAX package's single-device Trainer: 3 steps of reduced qwen3
    from its seed-0 weights, the jobs' optimizer."""
    jcfg = jax_reduced_config(jax_get_config("qwen3-0.6b"))
    tcfg = JaxTrainerConfig(seq_len=32, global_batch=4, steps=3,
                            log_every=1)
    res = JaxTrainer(jcfg, tcfg, jopt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10)).train()
    return [e["loss"] for e in res["log"]]


def _qwen_runs(outs, world):
    for job in qwen_jobs(world):
        yield job, outs[0][job.name]


def test_one_rank_mesh_is_the_single_device_bit_for_bit(world1):
    """1x1 under fsdp_tp, REPRO_WEIGHT_AG=1, dp and REPRO_SEQ_PARALLEL=1
    (the world's collectives run over one rank, the one-rank axes'
    skipped): the losses, gradient norms and trained weights of the
    single-device Trainer, bit for bit."""
    for job, got in _qwen_runs(world1, 1):
        _bitwise(got, plain(job), job.name)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_matches_the_single_device(world, world2, world4):
    """2x1, 1x2 and 2x2 in every mode: losses, gradient norms and leaves
    within the
    tolerances of one device's run from the same weights; the weights
    gathered once a layer and at every use give the same bits."""
    outs = world2[0] if world == 2 else world4
    for job, got in _qwen_runs(outs, world):
        _close(got, plain(job), job.name)
    for m in MESHES[world]:
        _bitwise(outs[0][_name("weight_ag", m)], outs[0][_name("fsdp_tp", m)],
                 f"REPRO_WEIGHT_AG at {m}")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_losses_match_the_jax_trainer(world, world1, world2, world4):
    """Every mode on every mesh: each step's loss within the train-parity
    tolerance of the JAX package's single-device Trainer on the bridged
    weights (its own mesh run fails under jax 0.9, ROADMAP C0)."""
    outs = {1: world1, 2: world2[0], 4: world4}[world]
    want = np.asarray(jax_losses(), np.float64)
    for job, got in _qwen_runs(outs, world):
        err = np.abs(np.asarray(got["losses"]) - want).max() \
            / np.abs(want).max()
        assert err <= LOGITS_TOL, (job.name, got["losses"], want)


class _Rank0:
    """Axis sizes and rank 0's coordinates (every rank's shards are of one
    size: the splits are even)."""

    def __init__(self, mesh):
        self.shape = {"data": mesh[0], "model": mesh[1]}
        self.coords = {"data": 0, "model": 0}


def _bytes_under_specs(mesh, env):
    """(param bytes, moment bytes) of a rank of ``mesh`` under the spec
    functions and ``env``'s REPRO_TRAIN_SHARDING."""
    from repro_torch.train.tree import leaves, map_tree
    cfg = reduced_config(get_config("qwen3-0.6b"))
    params = build_model(cfg, "cpu").init(0)
    rank0 = _Rank0(mesh)
    with ranks.knobs(env):
        layout = sharding.train_layout(cfg, params, rank0)
    p = sharding.shard_tree(params, layout.params, rank0)
    m = sharding.shard_tree(map_tree(lambda t: t.float(), params),
                            layout.moments, rank0)
    return (sum(t.numel() * t.element_size() for t in leaves(p)),
            2 * sum(t.numel() * 4 for t in leaves(m)))


def test_each_rank_holds_its_share_of_the_state(world2, world4):
    """Every rank's param and moment bytes are what the specs give: under
    fsdp_tp half (a quarter at 2x2) of the whole, apart from the leaves
    with no dim that divides (the norms), which stay whole; under dp the
    weights whole and the moments ZeRO-1 slices."""
    whole = plain(ranks.Job("p"))
    for outs, world in ((world2[0], 2), (world4, 4)):
        for m in MESHES[world]:
            for kind in ("fsdp_tp", "dp"):
                want_p, want_m = _bytes_under_specs(m, MODES[kind])
                for o in outs:
                    got = o[_name(kind, m)]
                    assert (got["param_bytes"], got["moment_bytes"]) \
                        == (want_p, want_m), (kind, m, o["rank"])
                if kind == "fsdp_tp":
                    assert want_p < whole["param_bytes"] / world * 1.05
                    assert want_m < whole["moment_bytes"] / world * 1.05
                else:
                    assert want_p == whole["param_bytes"]
                    assert want_m == whole["moment_bytes"] // world


@pytest.mark.parametrize("name", ["moe_1x2", "moe_2x2"])
def test_moe_trains_expert_parallel_with_the_global_aux(name, world2,
                                                         world4):
    """olmoe at 1x2 and 2x2: each model rank runs 2 of the 4 experts, and
    the losses (whose load-balance term is the global batch's) and leaves
    are one device's within the tolerances."""
    outs = world2[0] if name.endswith("1x2") else world4
    job = ranks.Job(name, arch="olmoe-1b-7b")
    _close(outs[0][name], plain(job), name)
    # the expert stacks split on E: a rank holds half of them at 1x2
    cfg = reduced_config(get_config("olmoe-1b-7b"))
    assert cfg.moe.n_experts == 4
    assert outs[0][name]["param_bytes"] < plain(job)["param_bytes"] / 1.9


def test_vlm_splits_embeds_and_positions_over_data(world2):
    """qwen2-vl's stub frontend at 2x1: ``embeds`` split on the batch and
    the M-RoPE ``positions`` on dim 1, as ``batch_specs`` says."""
    _close(world2[0][0]["vlm_2x1"],
           plain(ranks.Job("v", arch="qwen2-vl-72b")), "vlm_2x1")
    cfg = reduced_config(get_config("qwen2-vl-72b"))
    specs = sharding.batch_specs(cfg, {
        "embeds": np.zeros((4, 32, 64)), "positions": np.zeros((3, 4, 32)),
        "labels": np.zeros((4, 32))}, MeshShape({"data": 2, "model": 1}))
    assert specs == {"embeds": ("data", None, None),
                     "positions": (None, "data", None),
                     "labels": ("data", None)}


def test_a_batch_that_does_not_divide_is_replicated_not_summed(world2):
    """A global batch of 3 on 2x1 is replicated: every data rank computes
    the same rows and neither the loss nor the gradients are summed over
    the copies (the gradient norm is one device's)."""
    _close(world2[0][0]["batch3_2x1"], plain(ranks.Job("b", batch=3)),
           "batch3_2x1")


@pytest.mark.parametrize("name,batch", [("dp_summed_2x1", 4),
                                        ("replicated_summed_2x1", 3)])
def test_a_gradient_twice_too_large_fails_the_gate(name, batch, world2):
    """Planted faults (``_torch_train_ranks.PLANTS``): dp's gradients summed
    over the world instead of averaged, and a replicated batch's gradients
    summed over its copies.  Every gradient is twice one device's while
    the losses stay within their tolerance; the gradient-norm check is the
    one that fails."""
    got = world2[0][0][name]
    want = plain(ranks.Job("b", batch=batch))
    assert got["grad_norms"][0] == pytest.approx(2 * want["grad_norms"][0],
                                                 rel=LOSS_TOL)
    with pytest.raises(AssertionError, match="grad_norms"):
        _close(got, want, name)


def test_restart_on_a_mesh_replays_bitwise(world2):
    """2x1, 4 steps checkpointed every 2, a failure at step 3: every rank
    restores step 2 (whole leaves, its slice kept) and replays; the losses
    and weights are the clean run's bit for bit."""
    outs = world2[0][0]
    got, want = outs["restart_2x1"], outs["clean4_2x1"]
    assert got["losses"][-1] == want["losses"][-1]
    assert got["grad_norms"][-1] == want["grad_norms"][-1]
    for a, b in zip(got["params"], want["params"]):
        assert np.array_equal(a, b)


def test_checkpoints_move_between_meshes(world2):
    """A single-device checkpoint of step 2 restores on 2x1, and a 2x2
    checkpoint of step 2 on 1x2 (the mesh ``elastic_remesh`` leaves after
    losing a data row): both finish 4 steps within the tolerances of 4
    uninterrupted single-device steps."""
    want = plain(ranks.Job("four", steps=4))
    for name in ("from_single_2x1", "elastic_1x2"):
        got = world2[0][0][name]
        _close(got, {**want, "losses": want["losses"][2:],
                     "grad_norms": want["grad_norms"][2:]}, name)
    assert elastic_remesh(MeshShape({"data": 2, "model": 2})).shape \
        == {"data": 1, "model": 2}
    assert elastic_remesh(MeshShape({"data": 4, "model": 2}),
                          available=4).shape == {"data": 2, "model": 2}
    with pytest.raises(RuntimeError, match="no viable mesh"):
        elastic_remesh(MeshShape({"data": 1, "model": 2}))


def _composed(axis_n, name):
    """What each Function gives at rank r of an ``axis_n``-rank axis, from
    every rank's inputs (``_torch_train_ranks.rand``): (forward, gradient)
    per rank."""
    rand, n = ranks.rand, axis_n
    x = [rand((2, 3), 1, r) for r in range(n)]
    out = []
    for r in range(n):
        if name == "gather_sum":
            c = sum(rand((2 * n, 3), 2, k) for k in range(n))
            out.append((torch.cat(x), c[2 * r:2 * r + 2]))
        elif name == "gather_own":
            out.append((torch.cat(x), rand((2 * n, 3), 2, r)[2 * r:2 * r + 2]))
        elif name == "split":
            xs = rand((2, 3 * n), 3)
            out.append((xs[:, 3 * r:3 * r + 3],
                        torch.cat([rand((2, 3), 4, k) for k in range(n)], 1)))
        elif name == "copy_to":
            out.append((rand((2, 3), 5, r),
                        sum(rand((2, 3), 6, k) for k in range(n))))
        elif name == "reduce_from":
            out.append((sum(rand((2, 3), 7, k) for k in range(n)),
                        rand((2, 3), 8, r)))
        elif name == "all_reduce":
            out.append((sum(rand((2, 3), 9, k) for k in range(n)),
                        sum(rand((2, 3), 10, k) for k in range(n))))
        elif name == "mean_over":
            out.append((sum(rand((), 11, k) for k in range(n)) / n,
                        rand((), 12, r) / n))
        elif name == "gather_bucket":
            a = torch.cat([rand((2, 3), 13, k) for k in range(n)], 1)
            ca = sum(rand((2, 3 * n), 15, k) for k in range(n))
            cb = sum(rand((3,), 16, k) for k in range(n))
            out.append(((a, rand((3,), 14)), (ca[:, 3 * r:3 * r + 3], cb)))
    return out


FUNCTIONS = ("gather_sum", "gather_own", "split", "copy_to", "reduce_from",
             "all_reduce", "mean_over")


@pytest.mark.parametrize("axis,name", [
    (a, n) for a in ("data", "model") for n in FUNCTIONS]
    + [("data", "gather_bucket")])
def test_collective_functions_match_their_single_rank_composition(
        axis, name, world2):
    """Each autograd Function of ``distributed.collectives`` at world 2,
    over "data" (2x1) and "model" (1x2): the forward and the gradient of a
    random cotangent on each rank equal the composition on one rank of
    every rank's inputs (sum where a backward sums, the own part where it
    keeps it)."""
    outs = world2[0]
    want = _composed(2, name)
    for r, o in enumerate(outs):
        got = o["functions"][axis][name]
        for g, w in zip(_flat(got), _flat(want[r])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {r}")


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for t in x for y in _flat(t)]
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else x]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-small", "int8"])
def test_families_and_modes_waiting_for_a10d_raise_on_a_mesh(arch):
    """ssm, hybrid, the encoder-decoder and int8 moments raise on a mesh
    before allocating, naming ROADMAP A10d."""
    cfg = reduced_config(get_config("qwen3-0.6b" if arch == "int8"
                                    else arch))
    ocfg = AdamWConfig(state_dtype="int8" if arch == "int8" else "f32")
    with tempfile.TemporaryDirectory() as d, \
            process_group(0, 1, "gloo", os.path.join(d, "store")):
        with pytest.raises(NotImplementedError, match="A10d"):
            Trainer(cfg, TrainerConfig(seq_len=32, global_batch=2), ocfg,
                    mesh=make_train_mesh(1, 1), device="cpu")


def test_train_launcher_mesh_exits_clean():
    """``launch.train --smoke --device cpu --mesh 2x1`` trains on two gloo
    ranks, exits 0 and leaves no process in its session
    (``tools/session_leftovers.py``); pod1 names the devices it needs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "tools/session_leftovers.py", "--", sys.executable,
         "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--mesh", "2x1", "--steps", "2", "--seq-len", "32", "--batch", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "done at step 2" in out.stdout
    assert "session_leftovers: rc=0 left=[]" in out.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--mesh", "pod1"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "256 devices" in bad.stderr
