"""Rank bodies of the mesh-training tests, run by
``repro_torch.launch.mesh.spawn_ranks`` in processes of their own: this
module imports the port only (no JAX), so a rank starts fast.  A body runs
a list of jobs, each one ``Trainer`` on a ``TrainMesh`` of the group, and
returns plain Python and numpy values for the test to check against the
port's single-device ``Trainer`` and the JAX package's."""
import contextlib
import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class Job:
    """One training run on a ``data x model`` mesh of the group.

    ``env``: knobs set for the run; ``init``: numpy weights (the JAX
    package's, bridged) in place of the seeded init; ``workdir`` and
    ``checkpoint_every``: checkpoints; ``fail_at``: one injected
    failure; ``plant``: a fault of ``PLANTS`` put into the mesh step for
    the run."""
    name: str
    arch: str = "qwen3-0.6b"
    mesh: tuple = (1, 1)
    env: tuple = ()
    steps: int = 3
    batch: int = 4
    seq: int = 32
    lr: float = 1e-3
    init: object = None
    workdir: str = None
    checkpoint_every: int = 50
    fail_at: int = None
    plant: str = None


def cfg_of(arch):
    from repro_torch.configs.base import get_config, reduced_config
    return reduced_config(get_config(arch))


def trainer_of(job, mesh=None, device="cpu"):
    """The job's ``Trainer`` (``mesh`` None: one device)."""
    from repro_torch import bridge
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(seq_len=job.seq, global_batch=job.batch,
                         steps=job.steps, log_every=1, workdir=job.workdir,
                         checkpoint_every=job.checkpoint_every)
    ocfg = AdamWConfig(lr=job.lr, warmup_steps=1, total_steps=10)
    tr = Trainer(cfg_of(job.arch), tcfg, ocfg, mesh=mesh, device=device)
    if job.init is not None:
        tr.fns = dataclasses.replace(
            tr.fns, init=lambda seed=0: bridge.params_from_numpy(job.init))
    return tr


@contextlib.contextmanager
def knobs(env):
    old = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _summed_over_the_world(steps, sharding):
    """dp's gradients summed over the world and not averaged (the division
    by its size dropped)."""
    from repro_torch.train.tree import map_tree
    mean = steps._dp_mean
    steps._dp_mean = lambda grads, mesh: map_tree(
        lambda g: g * mesh.world, mean(grads, mesh))
    return lambda: setattr(steps, "_dp_mean", mean)


def _replicated_rows_summed(steps, sharding):
    """A batch that does not divide, replicated over "data": the FSDP
    gathers' backward sums the copies' gradients as if their rows
    differed (the loss is still not summed)."""
    shard = sharding.train_shard
    sharding.train_shard = lambda mesh, seq_len, batch_split: shard(
        mesh, seq_len, True)
    return lambda: setattr(sharding, "train_shard", shard)


# faults that scale every gradient of a 2-rank mesh step by 2
PLANTS = {"dp_summed": _summed_over_the_world,
          "replicated_summed": _replicated_rows_summed}


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    undo = PLANTS[name](steps, sharding)
    try:
        yield
    finally:
        undo()


def _bytes(tree):
    from repro_torch.train.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def run(job, mesh=None, device="cpu", whole=True):
    """Train ``job``: its losses and grad norms, this rank's param and
    moment bytes, the collectives a step, and (``whole``) the whole
    trained weights as numpy, flattened in ``leaves`` order."""
    from repro_torch.distributed import sharding
    from repro_torch.train.tree import leaves
    with knobs(job.env), planted(job.plant):
        tr = trainer_of(job, mesh, device)
        if mesh is not None:
            mesh.reset_issued()
        res = tr.train(fail_at=job.fail_at)
        state = res["state"]
        out = {"losses": [e["loss"] for e in res["log"]],
               "grad_norms": [e["grad_norm"] for e in res["log"]],
               "param_bytes": _bytes(state["params"]),
               "moment_bytes": _bytes(state["opt"]["m"])
               + _bytes(state["opt"]["v"])}
        params = state["params"]
        if mesh is not None:
            out["issued"] = mesh.issued
            if whole:
                params = sharding.unshard_tree(params, tr.layout.params,
                                               mesh, to_host=True)
    if whole:
        out["params"] = [p.detach().cpu().numpy() for p in leaves(params)]
    return out


def train_world(mesh, device, jobs, collectives=False):
    """The jobs in order, each on a ``TrainMesh`` of its shape over this
    group (after ``functions_world`` when ``collectives``): rank 0's results
    (with the whole weights) and every rank's bytes."""
    from repro_torch.launch.mesh import make_train_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": mesh.rank}
    if collectives:
        out["functions"] = functions_world(mesh, device)
    for job in jobs:
        tmesh = make_train_mesh(*job.mesh)
        out[job.name] = run(job, tmesh, device, whole=True)
        if mesh.rank:
            out[job.name].pop("params")
    return out


# -- the differentiable collectives, one rank's side ----------------------------

def rand(shape, seed, rank=None):
    """Seeded f32 values (a rank's own when ``rank`` is given)."""
    g = torch.Generator().manual_seed(seed * 10 + (0 if rank is None
                                                   else rank + 1))
    return torch.randn(shape, generator=g)


def functions(mesh, axis):
    """Each Function of ``distributed.collectives`` over ``axis`` on this
    rank: {name: (forward, gradient of <forward, cotangent>)}, both numpy;
    a rank's own input and cotangent from ``rand`` with its rank."""
    from repro_torch.distributed import collectives as col
    r = mesh.index(axis)
    n = mesh.size(axis)
    cases = {
        "gather_sum": (lambda x: col.gather(x, mesh, axis, 0, True),
                       rand((2, 3), 1, r), rand((2 * n, 3), 2, r)),
        "gather_own": (lambda x: col.gather(x, mesh, axis, 0, False),
                       rand((2, 3), 1, r), rand((2 * n, 3), 2, r)),
        "split": (lambda x: col.split(x, mesh, axis, 1),
                  rand((2, 3 * n), 3), rand((2, 3), 4, r)),
        "copy_to": (lambda x: col.copy_to(x, mesh, axis),
                    rand((2, 3), 5, r), rand((2, 3), 6, r)),
        "reduce_from": (lambda x: col.reduce_from(x, mesh, axis),
                        rand((2, 3), 7, r), rand((2, 3), 8, r)),
        "all_reduce": (lambda x: col.all_reduce(x, mesh, axis),
                       rand((2, 3), 9, r), rand((2, 3), 10, r)),
        "mean_over": (lambda x: col.mean_over(x, mesh, axis),
                      rand((), 11, r), rand((), 12, r)),
    }
    out = {}
    for name, (fn, x, c) in cases.items():
        x.requires_grad_(True)
        y = fn(x)
        (y * c).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    if axis == "data":
        # one sharded weight (dim 1) and one replicated, gradients summed
        a, b = rand((2, 3), 13, r), rand((3,), 14)
        for t in (a, b):
            t.requires_grad_(True)
        ga, gb = col.gather_bucket([a, b], [1, None], mesh, True)
        ((ga * rand((2, 3 * n), 15, r)).sum()
         + (gb * rand((3,), 16, r)).sum()).backward()
        out["gather_bucket"] = ((ga.detach().numpy(), gb.detach().numpy()),
                                (a.grad.numpy(), b.grad.numpy()))
    return out


def functions_world(mesh, device):
    """``functions`` over "data" on a 2x1 mesh of the group and over
    "model" on 1x2."""
    from repro_torch.launch.mesh import make_train_mesh
    return {"data": functions(make_train_mesh(mesh.world, 1), "data"),
            "model": functions(make_train_mesh(1, mesh.world), "model")}
