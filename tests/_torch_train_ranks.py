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
    the run; ``opt_state``: the AdamW moments' dtype; ``layers`` and
    ``vocab``: the reduced config's depth and vocabulary, when given;
    ``heads``: its (query, kv) heads, when given; ``snap``: also keep the
    whole weights after that many steps."""
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
    opt_state: str = "f32"
    layers: int = None
    vocab: int = None
    snap: int = None
    heads: tuple = None


def cfg_of(arch, layers=None, vocab=None, heads=None):
    from repro_torch.configs.base import get_config, reduced_config
    cfg = reduced_config(get_config(arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    return cfg


def trainer_of(job, mesh=None, device="cpu"):
    """The job's ``Trainer`` (``mesh`` None: one device)."""
    from repro_torch import bridge
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(seq_len=job.seq, global_batch=job.batch,
                         steps=job.steps, log_every=1, workdir=job.workdir,
                         checkpoint_every=job.checkpoint_every)
    ocfg = AdamWConfig(lr=job.lr, warmup_steps=1, total_steps=10,
                       state_dtype=job.opt_state)
    tr = Trainer(cfg_of(job.arch, job.layers, job.vocab, job.heads), tcfg,
                 ocfg,
                 mesh=mesh, device=device)
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


def _bc_without_f(steps, sharding):
    """Mamba1's B and C used by each rank's channels without *f*: their
    cotangent, and every gradient upstream of it, is one model rank's
    share."""
    from repro_torch.models import mamba
    bc_in = mamba._bc_in
    mamba._bc_in = lambda bc, shard: bc
    return lambda: setattr(mamba, "_bc_in", bc_in)


def _enc_out_without_f(steps, sharding):
    """The cross-attention reads the encoder output without *f*: the
    encoder's gradients are one model rank's share."""
    from repro_torch.models import encdec
    enc_in = encdec._enc_in
    encdec._enc_in = lambda enc_out, shard: enc_out.view_as(enc_out)
    return lambda: setattr(encdec, "_enc_in", enc_in)


def _sum_exp_unreduced(steps, sharding):
    """The vocab-parallel cross-entropy's Σ exp(l − m) left as the rank's
    slice's (not summed over "model"): each rank's loss is its own
    vocabulary slice's."""
    from repro_torch.distributed import collectives as col
    row_stats = col._row_stats

    def local_sum(logits, mesh, axis):
        m = mesh.reduce(logits.amax(-1), axis, op="max")
        return m, (logits - m[..., None]).exp().sum(-1)
    col._row_stats = local_sum
    return lambda: setattr(col, "_row_stats", row_stats)


# faults of a 2-rank mesh step: the first two scale every gradient by 2,
# the next two leave some gradients one model rank's share, the last
# changes the loss
PLANTS = {"dp_summed": _summed_over_the_world,
          "replicated_summed": _replicated_rows_summed,
          "bc_without_f": _bc_without_f,
          "enc_out_without_f": _enc_out_without_f,
          "sum_exp_unreduced": _sum_exp_unreduced}


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
    from repro_torch.train.tree import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree)[0])


def _numpy(tree):
    from repro_torch.train.tree import leaves
    return [p.detach().cpu().numpy().copy() for p in leaves(tree)]


def _snapping(tr, job, mesh, out):
    """Wrap the trainer's step so that the whole weights after step
    ``job.snap`` land in ``out["snap_params"]`` (every rank gathers)."""
    from repro_torch.distributed import sharding
    step, calls = tr._step, [0]

    def snapped(*args):
        res = step(*args)
        calls[0] += 1
        if calls[0] == job.snap:
            params = res[0] if mesh is None else sharding.unshard_tree(
                res[0], tr.layout.params, mesh, to_host=True)
            out["snap_params"] = _numpy(params)
        return res
    tr._step = snapped


def _moments(opt):
    """Whole int8 moments as numpy: (m dequantized, each value's block
    scale, the same for v) per leaf; whole f32 moments as they are."""
    from repro_torch.train.optimizer import Quantized, dequantize
    from repro_torch.train.tree import leaves

    def one(d):
        if not isinstance(d, Quantized):
            return d.cpu().numpy(), None
        scale = d.scale.expand(d.q.shape).reshape(-1)
        scale = scale[:scale.numel() - d.pad].reshape(d.shape)
        return dequantize(d).cpu().numpy(), scale.cpu().numpy()
    return [one(m) + one(v) for m, v in zip(leaves(opt["m"]),
                                             leaves(opt["v"]))]


def run(job, mesh=None, device="cpu", whole=True):
    """Train ``job``: its losses and grad norms, this rank's param and
    moment bytes, the collectives a step, and (``whole``) the whole
    trained weights as numpy, flattened in ``leaves`` order, with the
    whole moments (``_moments``) of an int8 run."""
    from repro_torch.distributed import sharding
    with knobs(job.env), planted(job.plant):
        tr = trainer_of(job, mesh, device)
        out = {}
        if job.snap is not None:
            _snapping(tr, job, mesh, out)
        if mesh is not None:
            mesh.reset_issued()
        res = tr.train(fail_at=job.fail_at)
        state = res["state"]
        out.update({"losses": [e["loss"] for e in res["log"]],
                    "grad_norms": [e["grad_norm"] for e in res["log"]],
                    "param_bytes": _bytes(state["params"]),
                    "moment_bytes": _bytes(state["opt"]["m"])
                    + _bytes(state["opt"]["v"])})
        params, opt = state["params"], state["opt"]
        if mesh is not None:
            out["issued"] = mesh.issued
            if whole:
                params = sharding.unshard_tree(params, tr.layout.params,
                                               mesh, to_host=True)
                if job.opt_state == "int8":
                    opt = sharding.unshard_tree(opt, tr._moment_specs(),
                                                mesh, to_host=True)
    if whole:
        out["params"] = _numpy(params)
        if job.opt_state == "int8":
            out["moments"] = _moments(opt)
    return out


def train_world(mesh, device, jobs, collectives=False, vocab_ce=False):
    """The jobs in order, each on a ``TrainMesh`` of its shape over this
    group (after ``functions_world`` when ``collectives``, and the
    vocab-parallel cross-entropy on a 2x2 mesh when ``vocab_ce``): rank
    0's results (with the whole weights) and every rank's bytes."""
    from repro_torch.launch.mesh import make_train_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": mesh.rank}
    if collectives:
        out["functions"] = functions_world(mesh, device)
        out["paired"] = paired_world(mesh)
        out["int8_update"] = int8_update_world(mesh)
    if vocab_ce:
        tm = make_train_mesh(2, mesh.world // 2)
        out["vocab_ce"] = _run_cases(
            {"vocab_ce": vocab_ce_case(tm, "model", tm.coords["data"])})
    for job in jobs:
        tmesh = make_train_mesh(*job.mesh)
        out[job.name] = run(job, tmesh, device, whole=True)
        if mesh.rank:
            for k in ("params", "snap_params", "moments"):
                out[job.name].pop(k, None)
    return out


# -- the differentiable collectives, one rank's side ----------------------------

def rand(shape, seed, rank=None):
    """Seeded f32 values (a rank's own when ``rank`` is given)."""
    g = torch.Generator().manual_seed(seed * 10 + (0 if rank is None
                                                   else rank + 1))
    return torch.randn(shape, generator=g)


VOCAB_SLICE = 4


def vocab_labels(n):
    """(2, 3) labels over a vocabulary of ``n`` slices of ``VOCAB_SLICE``:
    both ends of every slice, then the rest of the six from the middle."""
    k = VOCAB_SLICE
    ends = [e for r in range(n) for e in (r * k, r * k + k - 1)]
    mid = [r * k + 1 for r in range(n)] + [r * k + 2 for r in range(n)]
    return torch.tensor((ends + mid)[:6]).view(2, 3)


def vocab_ce_case(mesh, axis, seed=0):
    """The vocab-parallel cross-entropy over ``axis``: whole f32 logits
    (2, 3, n x ``VOCAB_SLICE``) from ``seed``, this rank's vocabulary
    slice as input, one cotangent for every rank (the loss is
    replicated over ``axis``)."""
    from repro_torch.distributed import collectives as col
    n, r = mesh.size(axis), mesh.index(axis)
    whole = rand((2, 3, n * VOCAB_SLICE), 17 + 2 * seed)
    labels = vocab_labels(n)
    return (lambda x: col.vocab_parallel_ce(x, labels, mesh, axis),
            whole[..., r * VOCAB_SLICE:(r + 1) * VOCAB_SLICE].clone(),
            rand((), 18 + 2 * seed))


def _run_cases(cases):
    """{name: (forward, gradient of <forward, cotangent>)} of each (fn,
    input, cotangent), both numpy."""
    out = {}
    for name, (fn, x, c) in cases.items():
        x.requires_grad_(True)
        y = fn(x)
        (y * c).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def functions(mesh, axis):
    """Each Function of ``distributed.collectives`` over ``axis`` on this
    rank: {name: (forward, gradient of <forward, cotangent>)}, both numpy;
    a rank's own input and cotangent from ``rand`` with its rank (the
    vocab-parallel cross-entropy: ``vocab_ce_case``)."""
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
        "vocab_ce": vocab_ce_case(mesh, axis),
    }
    out = _run_cases(cases)
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


def paired_world(mesh):
    """A fused in-projection's ``sharding.Paired`` layout on a 2x1 and a
    1x2 mesh of the group: whether this rank holds its rows' slice of each
    half, its bytes and the whole's, and whether ``unshard_tree`` gives the
    whole back bit for bit."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_train_mesh
    out = {}
    for shape in ((mesh.world, 1), (1, mesh.world)):
        tm = make_train_mesh(*shape)
        whole = rand((8, 12), 21)
        spec = {"w": sharding.Paired(("data", "model"))}
        local = sharding.shard_tree({"w": whole}, spec, tm)["w"]
        back = sharding.unshard_tree({"w": local}, spec, tm)["w"]
        n, r = tm.shape["model"], tm.coords["model"]
        rows = 8 // tm.shape["data"]
        mine = whole[tm.coords["data"] * rows:(tm.coords["data"] + 1) * rows]
        k = 6 // n
        out[f"{shape[0]}x{shape[1]}"] = {
            "round_trip": torch.equal(back, whole),
            "local_bytes": local.numel() * local.element_size(),
            "whole_bytes": whole.numel() * whole.element_size(),
            "halves": torch.equal(local, torch.cat(
                [mine[:, r * k:(r + 1) * k],
                 mine[:, 6 + r * k:6 + (r + 1) * k]], 1))}
    return out


def int8_update_world(mesh):
    """One AdamW step with int8 moments on a 2x1 and a 1x2 mesh of the
    group, from one set of whole weights and gradients, in windows of
    ``MESH_UPDATE_CHUNK`` = 256 values (so a leaf spans several, and a
    window cuts a rank's block range), against the same step on one
    device: whether the whole weights and the moments' payload and scales
    are its bits, leaf by leaf (a ``Paired`` leaf, leaves split on dim 0,
    dim 1 and both, a replicated one, one of fewer blocks than ranks)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train import optimizer as opt_mod
    shapes = {"paired": ((12, 64), sharding.Paired(("data", "model"))),
              "rows": ((40, 50), ("data", None)),
              "cols": ((20, 96), (None, "model")),
              "both": ((30, 64), ("model", "data")),
              "whole": ((700,), (None,)), "small": ((100,), (None,))}
    params = {k: rand(shape, 30 + i) for i, (k, (shape, _)) in
              enumerate(shapes.items())}
    grads = {k: rand(p.shape, 40 + i) for i, (k, p) in
             enumerate(params.items())}
    ocfg = opt_mod.AdamWConfig(state_dtype="int8", quant_block=16, lr=1e-2,
                               warmup_steps=1)
    adam = opt_mod.AdamW(ocfg)
    one = {k: v.clone() for k, v in params.items()}
    one_state = adam.init(one)
    adam.update(grads, one_state, one)
    chunk = opt_mod.MESH_UPDATE_CHUNK
    opt_mod.MESH_UPDATE_CHUNK = 256
    out = {}
    try:
        for shape in ((mesh.world, 1), (1, mesh.world)):
            tm = make_train_mesh(*shape)
            specs = {k: sp for k, (_, sp) in shapes.items()}
            q = {k: opt_mod.quantized_like(tuple(v.shape), 16)
                 for k, v in params.items()}
            layout = sharding.TrainLayout(
                tm, specs, sharding.opt_state_specs(
                    specs, {"m": q, "v": q}, tm)["m"])
            local = sharding.shard_tree({k: v.clone() for k, v in
                                         params.items()}, specs, tm)
            state = adam.init(local, layout)
            adam.update(sharding.shard_tree(grads, specs, tm), state, local,
                        layout=layout)
            whole = sharding.unshard_tree(local, specs, tm)
            moments = sharding.unshard_tree(
                [state["m"], state["v"]], [layout.moments, layout.moments],
                tm)
            out[f"{shape[0]}x{shape[1]}"] = {
                k: torch.equal(whole[k], one[k]) and all(
                    torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
                    for a, b in zip((moments[0][k], moments[1][k]),
                                    (one_state["m"][k], one_state["v"][k])))
                for k in params}
    finally:
        opt_mod.MESH_UPDATE_CHUNK = chunk
    return out
