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
restart, checkpoints moving between meshes (``elastic_remesh``), a
split that does not divide and the launcher's ``--mesh``.

The stateful and encoder-decoder families (ROADMAP A10d): reduced
falcon-mamba-7b, zamba2-2.7b at 4 layers (two segments: the shared block
runs at two call sites) and whisper-small at 1x1, 2x1, 1x2 and 2x2 under
fsdp_tp and REPRO_WEIGHT_AG=1, zamba2 under dp and REPRO_SEQ_PARALLEL=1,
whisper with an odd vocabulary, two planted missing *f*s, the fused
in-projections' paired layout; int8 moments for falcon-mamba and qwen3 on
every mesh shape and under dp.  An int8 run is held to one device's int8
run by its losses and gradient norms over two steps, its weights after the
first update (``LEAF_TOL``) and its moments after the second, each value
within one quantization step (its block's scale) of one device's: the
second update's weights are not gated, because a reordered sum that flips
one value of v between 0 and one step changes that weight by up to
lr / eps (ROADMAP C0, the reference's scheme)."""
import dataclasses
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


# the families of ROADMAP A10d and their reduced depth (None: the reduced
# config's own); zamba2 at 4 layers runs two segments
FAMILIES = {"falcon-mamba-7b": None, "zamba2-2.7b": 4, "whisper-small": None}


def jax_cfg(arch="qwen3-0.6b", layers=None):
    jcfg = jax_reduced_config(jax_get_config(arch))
    return jcfg if layers is None else dataclasses.replace(jcfg,
                                                           n_layers=layers)


@lru_cache(maxsize=None)
def jax_weights(arch="qwen3-0.6b", layers=None):
    """The JAX package's seed-0 weights of a reduced arch (numpy)."""
    return jax.tree.map(np.asarray, jax_build_model(
        jax_cfg(arch, layers)).init(jax.random.PRNGKey(0)))


def family_jobs(world):
    """The three families under fsdp_tp and REPRO_WEIGHT_AG=1 on each mesh
    of ``world`` ranks, 2 steps from the JAX package's weights."""
    return [ranks.Job(_name(f"{arch}_{kind}", m), arch=arch, mesh=m,
                      env=MODES[kind], steps=2, layers=layers,
                      init=jax_weights(arch, layers))
            for arch, layers in FAMILIES.items() for m in MESHES[world]
            for kind in ("fsdp_tp", "weight_ag")]


INT8_ARCHS = ("falcon-mamba-7b", "qwen3-0.6b")


def int8_jobs(world):
    """int8 moments under fsdp_tp on each mesh of ``world`` ranks (and
    under dp on 2x1), 2 steps, the weights kept after the first."""
    meshes = [(m, "fsdp_tp") for m in MESHES[world]]
    if world == 2:
        meshes.append(((2, 1), "dp"))
    return [ranks.Job(_name(f"int8_{arch}_{kind}", m), arch=arch, mesh=m,
                      env=MODES[kind], steps=2, snap=1, opt_state="int8")
            for arch in INT8_ARCHS for m, kind in meshes]


def qwen_jobs(world):
    """qwen3-0.6b in every mode on each mesh of ``world`` ranks, from the
    JAX package's weights."""
    return [ranks.Job(_name(kind, m), mesh=m, env=env, init=jax_weights())
            for m in MESHES[world] for kind, env in MODES.items()]


@lru_cache(maxsize=None)
def _plain(arch, batch, steps, jax_init, layers, vocab, opt_state, snap):
    job = ranks.Job("plain", arch=arch, batch=batch, steps=steps,
                    layers=layers, vocab=vocab, opt_state=opt_state,
                    snap=snap,
                    init=jax_weights(arch, layers) if jax_init else None)
    return ranks.run(job)


def plain(job):
    """The job on one device: the port's single-device ``Trainer``."""
    return _plain(job.arch, job.batch, job.steps, job.init is not None,
                  job.layers, job.vocab, job.opt_state, job.snap)


INT8_MOVES = ranks.Job("int8_moves", arch="falcon-mamba-7b",
                       opt_state="int8")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Checkpoint directories: one device's 2 steps (for a 2x1 restore),
    a 2x2 mesh's 2 steps (for the 1x2 restore), a 2x1 restart's; the same
    three of int8 falcon-mamba."""
    d = {k: str(tmp_path_factory.mktemp(k))
         for k in ("single", "elastic", "restart", "int8_single",
                   "int8_elastic", "int8_restart")}
    ranks.run(ranks.Job("single", steps=2, workdir=d["single"]),
              whole=False)
    ranks.run(dataclasses.replace(INT8_MOVES, steps=2,
                                  workdir=d["int8_single"]), whole=False)
    return d


@pytest.fixture(scope="module")
def world1():
    return spawn_ranks(ranks.train_world, 1, args=(
        qwen_jobs(1) + family_jobs(1) + int8_jobs(1),))


@pytest.fixture(scope="module")
def world4(dirs):
    jobs = qwen_jobs(4) + family_jobs(4) + int8_jobs(4) + [
        ranks.Job("moe_2x2", arch="olmoe-1b-7b", mesh=(2, 2)),
        ranks.Job("elastic_2x2", mesh=(2, 2), steps=2,
                  workdir=dirs["elastic"]),
        dataclasses.replace(INT8_MOVES, name="int8_elastic_2x2",
                            mesh=(2, 2), steps=2,
                            workdir=dirs["int8_elastic"])]
    return spawn_ranks(ranks.train_world, 4, args=(jobs, False, True))


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
    jobs += family_jobs(2) + int8_jobs(2) + [
        ranks.Job("zamba2_dp_2x1", arch="zamba2-2.7b", layers=4,
                  mesh=(2, 1), steps=2, env=MODES["dp"]),
        ranks.Job("zamba2_seq_parallel_1x2", arch="zamba2-2.7b", layers=4,
                  mesh=(1, 2), steps=2, env=MODES["seq_parallel"]),
        ranks.Job("whisper_vocab257_1x2", arch="whisper-small", vocab=257,
                  mesh=(1, 2), steps=2),
        ranks.Job("bc_without_f_1x2", arch="falcon-mamba-7b", mesh=(1, 2),
                  steps=1, plant="bc_without_f"),
        ranks.Job("enc_out_without_f_1x2", arch="whisper-small",
                  mesh=(1, 2), steps=1, plant="enc_out_without_f"),
        ranks.Job("sum_exp_unreduced_1x2", mesh=(1, 2), steps=1,
                  plant="sum_exp_unreduced"),
        dataclasses.replace(INT8_MOVES, name="int8_clean4_2x1", mesh=(2, 1),
                            steps=4),
        dataclasses.replace(INT8_MOVES, name="int8_restart_2x1", mesh=(2, 1),
                            steps=4, checkpoint_every=2, fail_at=3,
                            workdir=dirs["int8_restart"]),
        dataclasses.replace(INT8_MOVES, name="int8_from_single_2x1",
                            mesh=(2, 1), steps=3,
                            workdir=dirs["int8_single"]),
        dataclasses.replace(INT8_MOVES, name="int8_elastic_1x2", mesh=(1, 2),
                            steps=2, workdir=dirs["int8_elastic"])]
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
        elif name == "vocab_ce":
            out.append(_vocab_ce_composed(n, r))
    return out


def _vocab_ce_composed(n, r, seed=0):
    """``softmax_cross_entropy`` of the whole logits of
    ``_torch_train_ranks.vocab_ce_case`` and rank ``r``'s slice of the
    gradient of its product with the cotangent."""
    from repro_torch.models.layers import softmax_cross_entropy
    k = ranks.VOCAB_SLICE
    whole = ranks.rand((2, 3, n * k), 17 + 2 * seed).requires_grad_(True)
    loss = softmax_cross_entropy(whole, ranks.vocab_labels(n))
    (grad,) = torch.autograd.grad(loss * ranks.rand((), 18 + 2 * seed),
                                  whole)
    return loss.detach(), grad[..., r * k:(r + 1) * k]


FUNCTIONS = ("gather_sum", "gather_own", "split", "copy_to", "reduce_from",
             "all_reduce", "mean_over", "vocab_ce")


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


def test_vocab_parallel_ce_matches_the_whole_logits_on_2x2(world4):
    """The vocab-parallel cross-entropy over "model" on a 2x2 mesh, each
    data row its own logits: on every rank the loss and the rank's slice
    of the gradient are ``softmax_cross_entropy``'s on the whole logits
    (labels at both ends of every rank's slice)."""
    labels = ranks.vocab_labels(2)
    assert set(labels.flatten().tolist()) >= {0, 3, 4, 7}
    for o in world4:
        d, m = divmod(o["rank"], 2)
        for g, w in zip(_flat(o["vocab_ce"]["vocab_ce"]),
                        _flat(_vocab_ce_composed(2, m, seed=d))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {o['rank']}")


def test_the_vocab_parallel_loss_gathers_no_logits(world2):
    """qwen3 at 1x2 under fsdp_tp: the head stays the rank's vocabulary
    slice into the loss, so the all_gathers a step (``TrainMesh.issued``)
    send less than one rank's slice of the (B, S, V) logits would, which
    the whole-logits loss all-gathered each step; the loss is one
    device's (``test_mesh_matches_the_single_device``)."""
    cfg = ranks.cfg_of("qwen3-0.6b")
    job = next(j for j in qwen_jobs(2) if j.name == "fsdp_tp_1x2")
    slice_bytes = job.batch * job.seq * cfg.vocab // 2 * 4
    for o in world2[0]:
        calls, sent, _ = o[job.name]["issued"]["all_gather"]
        assert sent // job.steps < slice_bytes, (o["rank"], sent, slice_bytes)


def test_an_unreduced_sum_of_exponentials_fails_the_loss_gate(world2):
    """Planted fault (``_torch_train_ranks.PLANTS``) at 1x2: the
    vocab-parallel cross-entropy's Σ exp(l − m) not summed over "model",
    so each rank's loss covers only its vocabulary slice; the loss gate
    fails."""
    job = next(j for j in world2[1] if j.name == "sum_exp_unreduced_1x2")
    got = world2[0][0][job.name]
    want = plain(dataclasses.replace(job, plant=None))
    assert not _gates(got, want)["losses"], (got["losses"], want["losses"])
    with pytest.raises(AssertionError, match="losses"):
        _close(got, want, job.name)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for t in x for y in _flat(t)]
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else x]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-small", "int8"])
def test_families_and_modes_waiting_for_a10d_raise_on_a_mesh(arch):
    """ssm, hybrid, the encoder-decoder and int8 moments, which waited for
    ROADMAP A10d, now train on a 1x1 mesh: one step of one device's loss
    and gradient norm, bit for bit."""
    cfg = reduced_config(get_config("qwen3-0.6b" if arch == "int8"
                                    else arch))
    ocfg = AdamWConfig(state_dtype="int8" if arch == "int8" else "f32")
    tcfg = TrainerConfig(seq_len=32, global_batch=2, steps=1, log_every=1)
    with tempfile.TemporaryDirectory() as d, \
            process_group(0, 1, "gloo", os.path.join(d, "store")):
        got = Trainer(cfg, tcfg, ocfg, mesh=make_train_mesh(1, 1),
                      device="cpu").train()["log"]
    want = Trainer(cfg, tcfg, ocfg, device="cpu").train()["log"]
    assert [(e["loss"], e["grad_norm"]) for e in got] \
        == [(e["loss"], e["grad_norm"]) for e in want]


@pytest.mark.parametrize("arch,model,heads,what", [
    ("falcon-mamba-7b", 3, None, "d_inner 128"),
    ("zamba2-2.7b", 16, None, "SSD heads 8"),
    ("zamba2-2.7b", 3, None, "d_inner 128, SSD heads 8"),
    ("whisper-small", 2, (6, 3), "kv heads 3")])
def test_a_split_that_does_not_divide_raises(arch, model, heads, what):
    """Under fsdp_tp, what a family splits over "model" must divide, and
    the error names the numbers: falcon-mamba's d_inner (its single head
    is never split), the hybrid's d_inner and SSD heads, and kv heads that
    neither divide the model ranks nor are divided by them where the query
    heads split.  Query heads that do not split refuse nothing (the
    attention then runs whole on each model rank)."""
    from repro_torch.train.trainer import check_mesh_trains
    cfg = reduced_config(get_config(arch))
    bad = cfg if heads is None else dataclasses.replace(
        cfg, n_heads=heads[0], n_kv_heads=heads[1])
    with pytest.raises(ValueError, match=what):
        check_mesh_trains(bad, MeshShape({"data": 1, "model": model}))
    # one model rank per d_inner slice that divides: no refusal
    check_mesh_trains(cfg, MeshShape({"data": 3, "model": 2}))
    check_mesh_trains(get_config("falcon-mamba-7b"),
                      MeshShape({"data": 1, "model": 2}))
    # heads that do not split (4 over 8), kv heads fewer than the ranks
    check_mesh_trains(cfg, MeshShape({"data": 1, "model": 8}))
    check_mesh_trains(get_config("qwen3-0.6b"),
                      MeshShape({"data": 16, "model": 16}))


# -- the stateful and encoder-decoder families, int8 moments (A10d) ---------

def _family_runs(outs, world, arch):
    for job in family_jobs(world):
        if job.arch == arch:
            yield job, outs[0][job.name]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_one_rank_mesh_is_the_single_device_bit_for_bit(arch,
                                                                world1):
    """falcon-mamba, zamba2 (two segments) and whisper at 1x1 under fsdp_tp
    and REPRO_WEIGHT_AG=1: the single-device Trainer's losses, gradient
    norms and trained weights, bit for bit."""
    for job, got in _family_runs(world1, 1, arch):
        _bitwise(got, plain(job), job.name)


@pytest.mark.parametrize("arch", list(FAMILIES))
@pytest.mark.parametrize("world", [2, 4])
def test_family_mesh_matches_the_single_device(arch, world, world2, world4):
    """2x1, 1x2 and 2x2: losses, gradient norms and leaves within the
    tolerances of one device's run from the same weights (K7 over a rank's
    d_inner channels, the SSD over its heads with the gated norm on whole
    rows, the shared block's gradient summed over its two call sites, the
    cross-attention's K/V from a replicated encoder output); the weights
    gathered once a layer and at every use give the same bits."""
    outs = world2[0] if world == 2 else world4
    for job, got in _family_runs(outs, world, arch):
        _close(got, plain(job), job.name)
    for m in MESHES[world]:
        _bitwise(outs[0][_name(f"{arch}_weight_ag", m)],
                 outs[0][_name(f"{arch}_fsdp_tp", m)],
                 f"{arch} REPRO_WEIGHT_AG at {m}")


@lru_cache(maxsize=None)
def jax_family_losses(arch):
    """The JAX package's single-device Trainer: 2 steps of a reduced family
    from its seed-0 weights, the jobs' optimizer."""
    tcfg = JaxTrainerConfig(seq_len=32, global_batch=4, steps=2,
                            log_every=1)
    res = JaxTrainer(jax_cfg(arch, FAMILIES[arch]), tcfg, jopt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10)).train()
    return [e["loss"] for e in res["log"]]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_mesh_losses_match_the_jax_trainer(arch, world1, world2,
                                                  world4):
    """Every family run on every mesh: each step's loss within the
    train-parity tolerance of the JAX package's single-device Trainer on
    the bridged weights."""
    want = np.asarray(jax_family_losses(arch), np.float64)
    for outs, world in ((world1, 1), (world2[0], 2), (world4, 4)):
        for job, got in _family_runs(outs, world, arch):
            err = np.abs(np.asarray(got["losses"]) - want).max() \
                / np.abs(want).max()
            assert err <= LOGITS_TOL, (job.name, got["losses"], want)


@pytest.mark.parametrize("name", ["zamba2_dp_2x1",
                                  "zamba2_seq_parallel_1x2"])
def test_hybrid_trains_under_dp_and_sequence_parallelism(name, world2):
    """zamba2 (two segments) under REPRO_TRAIN_SHARDING=dp at 2x1 and under
    REPRO_SEQ_PARALLEL=1 at 1x2 (the shared MLP on a rank's sequence
    slice): one device's run within the tolerances."""
    job = next(j for j in world2[1] if j.name == name)
    _close(world2[0][0][name], plain(job), name)


def test_an_odd_vocabulary_is_not_split_on_model(world2):
    """whisper with a vocabulary of 257 at 1x2: the embedding and the
    logits stay whole on "model" (the spec drops the entry, as for
    whisper-small's 51,865) and the run is one device's within the
    tolerances."""
    job = next(j for j in world2[1] if j.name == "whisper_vocab257_1x2")
    _close(world2[0][0][job.name], plain(job), job.name)
    cfg = ranks.cfg_of("whisper-small", vocab=257)
    specs = sharding.param_specs(cfg, build_model(cfg, "cpu").init(0),
                                 MeshShape({"data": 1, "model": 2}))
    assert specs["embed"] == {"embed": (None, "data"),
                              "unembed": ("data", None)}


@pytest.mark.parametrize("name,fails", [("bc_without_f_1x2", "leaves"),
                                        ("enc_out_without_f_1x2",
                                         "grad_norms")])
def test_a_missing_f_fails_the_gradient_norm_gate(name, fails, world2):
    """Planted faults (``_torch_train_ranks.PLANTS``) at 1x2, one step:
    Mamba1's B and C, and the cross-attention's encoder output, read by
    each rank's channels or heads without *f*.  The forward is unchanged,
    so the loss gate passes, while every gradient upstream is one rank's
    share.  Without the encoder's *f* the gradient norm moves by about a
    tenth and its gate fails; without B and C's the norm moves by about
    1e-5 relative at this size (their gradients are small beside the
    embedding's), under the norm gate, and the leaf gate fails (AdamW's
    update of x_proj's B and C columns is as large as any other's)."""
    job = next(j for j in world2[1] if j.name == name)
    got, want = world2[0][0][name], plain(dataclasses.replace(job,
                                                              plant=None))
    gates = _gates(got, want)
    assert gates["losses"], name
    assert not gates[fails], (name, gates)
    with pytest.raises(AssertionError):
        _close(got, want, name)


def _gates(got, want):
    """Which of ``_close``'s gates ``got`` passes."""
    out = {k: all(abs(a - b) <= LOSS_TOL * abs(b)
                  for a, b in zip(got[k], want[k]))
           for k in ("losses", "grad_norms")}
    out["leaves"] = all(
        float(np.abs(a - b).max()) <= LEAF_TOL * max(float(np.abs(b).max()),
                                                     1e-30)
        for a, b in zip(got["params"], want["params"]))
    return out


def _int8_close(got, want, what):
    """An int8 run against one device's (the module's docstring): losses
    and gradient norms, the weights after the first update, the moments
    after the last, each value within one step of its block."""
    _close({**got, "params": got["snap_params"]},
           {**want, "params": want["snap_params"]}, what)
    _moments_close(got, want, what)


def _moments_close(got, want, what):
    assert len(got["moments"]) == len(want["moments"]), what
    for i, (g, w) in enumerate(zip(got["moments"], want["moments"])):
        for k in (0, 2):                                  # m, then v
            gap = np.abs(g[k] - w[k])
            assert (gap <= w[k + 1] * (1 + 1e-3)).all(), (
                what, i, "mv"[k // 2], float((gap / w[k + 1]).max()))


def _int8_runs(outs, world, arch):
    for job in int8_jobs(world):
        if job.arch == arch:
            yield job, outs[0][job.name]


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_moments_on_one_rank_are_the_single_device_bit_for_bit(
        arch, world1):
    """int8 moments at 1x1: losses, gradient norms, weights and the
    moments' payload and scales of one device's int8 run, bit for bit."""
    for job, got in _int8_runs(world1, 1, arch):
        want = plain(job)
        _bitwise(got, want, job.name)
        for g, w in zip(got["moments"], want["moments"]):
            for a, b in zip(g, w):
                assert np.array_equal(a, b), job.name


@pytest.mark.parametrize("arch", INT8_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_int8_moments_on_a_mesh_keep_the_single_device_blocks(
        arch, world, world2, world4):
    """int8 moments at 2x1, 1x2, 2x2 and under dp: one device's int8 run
    within ``_int8_close``, and a rank holds its share of the whole
    leaves' blocks (1/world of them where a leaf's blocks divide; a leaf
    of fewer blocks stays whole on every rank)."""
    outs = world2[0] if world == 2 else world4
    for job, got in _int8_runs(outs, world, arch):
        want = plain(job)
        _int8_close(got, want, job.name)
        mine = _int8_bytes(arch, job.mesh, job.env)
        assert mine < want["moment_bytes"] / world * 1.35, job.name
        for o in outs:
            assert o[job.name]["moment_bytes"] == mine, (job.name,
                                                         o["rank"])


def _int8_bytes(arch, mesh, env):
    """A rank's bytes of both int8 moments under the spec functions: each
    leaf's blocks (256 int8 values and an f32 scale each) over the world
    when they divide, all of them otherwise."""
    from repro_torch.train.tree import leaves
    cfg = reduced_config(get_config(arch))
    params = build_model(cfg, "cpu").init(0)
    with ranks.knobs(env):
        layout = sharding.train_layout(cfg, params, _Rank0(mesh), "int8")
    total = 0
    for q, p in zip(leaves(layout.moments), leaves(params)):
        nb = -(-p.numel() // 256)
        total += (nb // (mesh[0] * mesh[1]) if q.q[0] is not None
                  else nb) * (256 + 4)
    return 2 * total


def test_int8_restart_on_a_mesh_replays_bitwise(world2):
    """int8 falcon-mamba at 2x1, 4 steps checkpointed every 2, a failure
    at step 3: the restored blocks replay the clean run bit for bit."""
    got, want = (world2[0][0][k] for k in ("int8_restart_2x1",
                                           "int8_clean4_2x1"))
    assert got["losses"][-1] == want["losses"][-1]
    assert got["grad_norms"][-1] == want["grad_norms"][-1]
    for a, b in zip(got["params"], want["params"]):
        assert np.array_equal(a, b)
    for g, w in zip(got["moments"], want["moments"]):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


def test_int8_checkpoints_move_between_meshes(world2, world4):
    """A 2x2 int8 checkpoint (whole quantized leaves) restored on 1x2 gives
    back the 2x2 run's weights and moments bit for bit; one device's
    checkpoint of step 2 restored on 2x1 trains a third step within the
    tolerances of three single-device steps (its moments within one step
    of their block)."""
    got, want = world2[0][0]["int8_elastic_1x2"], world4[0][
        "int8_elastic_2x2"]
    assert got["losses"] == []
    for a, b in zip(got["params"], want["params"]):
        assert np.array_equal(a, b)
    for g, w in zip(got["moments"], want["moments"]):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    got = world2[0][0]["int8_from_single_2x1"]
    three = plain(dataclasses.replace(INT8_MOVES, steps=3))
    for key in ("losses", "grad_norms"):
        assert got[key][0] == pytest.approx(three[key][2], rel=LOSS_TOL)
    _moments_close(got, three, "int8_from_single_2x1")


def test_paired_halves_round_trip_bitwise(world2):
    """The fused in-projections' ``sharding.Paired`` layout at 2x1 and 1x2
    (``_torch_train_ranks.paired_world``): a rank holds its slice of each
    half (1/n of the leaf's bytes), and ``unshard_tree`` gives back the
    whole leaf bit for bit."""
    for o in world2[0]:
        for mesh, r in o["paired"].items():
            assert r["round_trip"], (mesh, o["rank"])
            assert r["local_bytes"] * 2 == r["whole_bytes"], (mesh, r)
            assert r["halves"], (mesh, o["rank"])


def test_int8_update_on_a_mesh_gives_the_single_device_bits(world2):
    """Given one device's weights and gradients, the mesh's int8 update
    (``optimizer._blocks_update``, windows of 256 values so that a leaf
    spans several and a window cuts a rank's block range) at 2x1 and 1x2
    gives one device's weights and moments (payload and scales) bit for
    bit: paired, row-, column- and doubly-split, replicated leaves and one
    of fewer blocks than ranks (``_torch_train_ranks.int8_update_world``)."""
    for o in world2[0]:
        for mesh, leaves in o["int8_update"].items():
            assert all(leaves.values()), (mesh, o["rank"], leaves)


def test_the_paired_spec_is_the_reference_spec():
    """``train_layout`` marks Mamba's fused in-projections ``Paired`` and
    nothing else; a ``Paired`` spec equals the plain spec that the rules
    give (and the reference's)."""
    def specs(tree, params):
        out = []
        sharding._tree_map2(lambda sp, _: out.append(sp), tree, params)
        return out
    for arch in ("falcon-mamba-7b", "zamba2-2.7b", "qwen3-0.6b"):
        cfg = reduced_config(get_config(arch))
        params = build_model(cfg, "cpu").init(0)
        mesh = MeshShape({"data": 2, "model": 2})
        got = specs(sharding.train_layout(cfg, params, mesh).params, params)
        assert got == specs(sharding.param_specs(cfg, params, mesh), params)
        want = 0 if arch == "qwen3-0.6b" else cfg.n_layers
        assert sum(isinstance(sp, sharding.Paired) for sp in got) == want


def test_train_launcher_mesh_trains_the_ssm_family():
    """``launch.train --smoke --device cpu --mesh 1x2 --arch
    falcon-mamba-7b`` trains d_inner over two gloo ranks, exits 0 and
    leaves no process in its session."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "tools/session_leftovers.py", "--", sys.executable,
         "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--mesh", "1x2", "--arch", "falcon-mamba-7b", "--steps", "2",
         "--seq-len", "32", "--batch", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "done at step 2" in out.stdout
    assert "session_leftovers: rc=0 left=[]" in out.stdout


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
