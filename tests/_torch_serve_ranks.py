"""Rank bodies of the mesh prefill and decode tests, run by
``repro_torch.launch.mesh.spawn_ranks`` in processes of their own: this
module imports the port only (no JAX), so a rank starts fast.  A body runs
a list of jobs, each a prefill and then teacher-forced decode steps
through ``launch.steps.make_prefill_step(mesh=)`` and
``make_decode_step(mesh=)`` on a ``TrainMesh`` of the group, and returns
numpy values (the logits and the caches gathered whole) for the test to
check against the port's single device and the JAX package."""
import dataclasses

import numpy as np
import torch

from _torch_train_ranks import cfg_of, knobs


@dataclasses.dataclass(frozen=True)
class Job:
    """A prompt of ``prompt`` tokens a row for ``batch`` rows, prefilled
    and then decoded ``steps`` tokens (drawn from a seed) in a cache of
    capacity ``cap``, on a ``data x model`` mesh.  ``heads``: the reduced
    config's (query, kv) heads, when given; ``init``: numpy weights (the
    JAX package's, bridged) in place of the seeded init; ``env``: knobs
    set for the run."""
    name: str
    arch: str = "qwen3-0.6b"
    mesh: tuple = (1, 1)
    batch: int = 4
    prompt: int = 8
    steps: int = 4
    cap: int = 12
    heads: tuple = None
    init: object = None
    env: tuple = ()


def job_cfg(job):
    return cfg_of(job.arch, heads=job.heads)


def weights(job, cfg):
    from repro_torch import bridge
    from repro_torch.models import build_model
    if job.init is not None:
        return bridge.params_from_numpy(job.init)
    return build_model(cfg, "cpu").init(0)


def inputs(cfg, job) -> dict:
    """The job's seeded numpy inputs: the prompt's tokens (the VLM's stub
    embeds and M-RoPE positions, the audio family's frames beside them)
    and each decode step's token (or embeds)."""
    rng = np.random.default_rng(11)
    b, s, d = job.batch, job.prompt, cfg.d_model
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "forced": rng.integers(0, cfg.vocab,
                                  (job.steps, b, 1)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = rng.normal(size=(b, s, d)).astype(np.float32)
        out["step_embeds"] = rng.normal(
            size=(job.steps, b, 1, d)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(b, s, d)).astype(np.float32)
    return out


def _positions(b, start, n):
    """M-RoPE streams (3, b, n) from ``start``: time, and a 2-wide grid's
    rows and columns."""
    t = np.arange(start, start + n, dtype=np.int32)
    streams = np.stack([t, t // 2, t % 2])
    return np.broadcast_to(streams[:, None, :], (3, b, n)).copy()


def prefill_batch(cfg, inp) -> dict:
    b, s = inp["tokens"].shape
    if cfg.family == "vlm":
        return {"embeds": torch.from_numpy(inp["embeds"]),
                "positions": torch.from_numpy(_positions(b, 0, s))}
    out = {"tokens": torch.from_numpy(inp["tokens"])}
    if cfg.family == "audio":
        out = {"frames": torch.from_numpy(inp["frames"]), **out}
    return out


def decode_batch(cfg, inp, i) -> dict:
    """Step ``i``'s batch, without ``cur_len``."""
    b, s = inp["tokens"].shape
    if cfg.family == "vlm":
        return {"embeds": torch.from_numpy(inp["step_embeds"][i]),
                "positions": torch.from_numpy(_positions(b, s + i, 1))}
    return {"token": torch.from_numpy(inp["forced"][i])}


def place(small: dict, big: dict) -> dict:
    """``big`` with ``small``'s leaves written at the start of each dim (a
    prefill's cache of the prompt's capacity in a larger one)."""
    for k, v in small.items():
        if isinstance(v, dict):
            place(v, big[k])
        else:
            big[k][tuple(slice(0, n) for n in v.shape)] = v
    return big


def _numpy(tree):
    from repro_torch.train.tree import leaves_with_path
    return {"/".join(p): t.detach().cpu().numpy().copy()
            for p, t in leaves_with_path(tree)}


def run_one(job, device="cpu"):
    """The job on one device: {"prefill_logits", "prefill_cache",
    "decode_logits", "cache"}."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    cfg = job_cfg(job)
    params = weights(job, cfg)
    inp = inputs(cfg, job)
    with torch.no_grad(), knobs(job.env):
        cache, logits = make_prefill_step(cfg, device)(
            params, prefill_batch(cfg, inp))
        out = {"prefill_logits": logits.numpy().copy(),
               "prefill_cache": _numpy(cache)}
        big = place(cache, build_model(cfg, device).make_cache(job.batch,
                                                               job.cap))
        decode = make_decode_step(cfg, device)
        steps = []
        for i in range(job.steps):
            batch = decode_batch(cfg, inp, i)
            if cfg.family != "ssm":
                batch["cur_len"] = job.prompt + i
            big, logits = decode(params, big, batch)
            steps.append(logits.numpy().copy())
    out["decode_logits"] = steps
    out["cache"] = _numpy(big)
    return out


def run_mesh(job, mesh, device="cpu"):
    """The job on ``mesh`` (this rank's ``TrainMesh``): the same values as
    ``run_one``, the logits gathered over "data" and the caches whole
    (``unshard_tree`` under ``cache_specs``), and the collectives this rank
    issued in the prefill and in the first decode step."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import abstract_cache
    cfg = job_cfg(job)
    params = weights(job, cfg)
    inp = inputs(cfg, job)
    layout = sharding.train_layout(cfg, params, mesh)
    local = sharding.shard_tree(params, layout.params, mesh)

    def slice_of(batch):
        specs = sharding.batch_specs(cfg, batch, mesh)
        split = any(e is not None for sp in specs.values() for e in sp)
        return sharding.shard_tree(batch, specs, mesh), split

    def whole(logits, split):
        return mesh.gather(logits, 0, "data") if split else logits

    with torch.no_grad(), knobs(job.env):
        batch, split = slice_of(prefill_batch(cfg, inp))
        mesh.reset_issued()
        cache, logits = make_prefill_step(cfg, device, mesh=mesh)(
            local, batch, layout, split)
        issued = {"prefill": mesh.issued}
        pre_specs = sharding.cache_specs(
            cfg, abstract_cache(cfg, job.batch, job.prompt), mesh)
        cache = sharding.unshard_tree(cache, pre_specs, mesh)
        out = {"prefill_logits": whole(logits, split).numpy().copy(),
               "prefill_cache": _numpy(cache)}
        big = place(cache, build_model(cfg, device).make_cache(job.batch,
                                                               job.cap))
        specs = sharding.cache_specs(cfg, big, mesh)
        blocks = sharding.shard_tree(big, specs, mesh)
        decode = make_decode_step(cfg, device, mesh=mesh)
        steps = []
        for i in range(job.steps):
            batch, split = slice_of(decode_batch(cfg, inp, i))
            if cfg.family != "ssm":
                batch["cur_len"] = job.prompt + i
            mesh.reset_issued()
            blocks, logits = decode(local, blocks, batch, layout, specs,
                                    split)
            if i == 0:
                issued["decode"] = mesh.issued
            steps.append(whole(logits, split).numpy().copy())
        out["decode_logits"] = steps
        out["cache"] = _numpy(sharding.unshard_tree(blocks, specs, mesh))
    out["issued"] = issued
    return out


def serve_world(mesh, device, jobs):
    """The jobs in order, each on a ``TrainMesh`` of its shape over this
    group: rank 0's results."""
    from repro_torch.launch.mesh import make_train_mesh
    out = {}
    for job in jobs:
        res = run_mesh(job, make_train_mesh(*job.mesh), device)
        if mesh.rank == 0:
            out[job.name] = res
    return out
