"""The port's dry run (``repro_torch.launch.dryrun``, ROADMAP A13a) held
against the JAX package on the CPU: the cells (``SHAPES``,
``cell_is_runnable``), the abstract weights of every arch at full width,
the batch and cache specs, the roofline functions bit for bit under the
reference's constants, the kernel wrappers' cost hooks (meta counts the
same as the CPU plain version), a tiny train, prefill and decode step's
matrix FLOPs against ``analyze_hlo`` of the reference's compiled steps,
the virtual mesh's collectives against gloo ranks' ``TrainMesh.issued``,
the attention layouts a 16-way model axis needs (one KV head a rank;
heads that do not split run whole) against one device, and ``run_cell``
end to end for train, prefill, decode and skipped cells (the mesh
prefill and decode steps themselves: ``test_torch_serve_steps_mesh.py``)."""
import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_ranks as ranks
from _torch_parity import reference_hardware
from repro.configs import base as jbase
from repro.launch import hlo_analysis as jhlo
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import model_zoo as jzoo
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ShapeSpec, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import rmsnorm as k2
from repro_torch.kernels import ssm_scan as k7
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as thlo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import MeshShape, dry_train_mesh, spawn_ranks
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models import model_zoo as tzoo
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tbase.list_archs()
# one arch of each family
FAMILY_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "qwen2-vl-72b",
                "falcon-mamba-7b", "zamba2-2.7b", "whisper-small")
LOSS_TOL = 1e-4
LEAF_TOL = 1e-3
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32, "int8": torch.int8}


def _leaves(tree, path=()):
    """(path, leaf) of a port tree (dicts and lists) in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _shapes(tree):
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _leaves(tree)}


# -- the cells ---------------------------------------------------------------

def test_shapes_and_runnability_equal_the_reference():
    assert tbase.list_archs() == jbase.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        for name in tbase.SHAPES:
            assert tbase.cell_is_runnable(
                get_config(arch), tbase.SHAPES[name]) \
                == jbase.cell_is_runnable(jbase.get_config(arch),
                                          jbase.SHAPES[name]), (arch, name)


def test_all_cells_are_the_twenty_train_cells():
    """(Named when only the train cells were ported.)  Every arch x every
    shape x mesh, in the reference's order
    (``repro.launch.dryrun.all_cells``: ``ALL_ARCHS``, then ``SHAPES``,
    then the meshes; its module is not imported, as it sets XLA_FLAGS for
    512 host devices)."""
    from repro.configs import ALL_ARCHS
    meshes = ["pod1", "pod2"]
    cells = list(dryrun.all_cells(meshes))
    assert cells == [(a, s, m) for a in ALL_ARCHS for s in jbase.SHAPES
                     for m in meshes]
    assert len(cells) == 80
    skipped = [c for c in cells if not tbase.cell_is_runnable(
        get_config(c[0]), tbase.SHAPES[c[1]])[0]]
    assert len(skipped) == 16 and {s for _, s, _ in skipped} == {"long_500k"}


# -- abstract trees ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_the_reference(arch, monkeypatch):
    """Full width: the leaves of ``abstract_params`` (meta, nothing drawn)
    are those of the reference's ``jax.eval_shape`` of ``init`` named
    through ``bridge.params_from_numpy`` (fed zero-stride stand-ins, each
    leaf made a meta tensor), shape and dtype.  Their element count is the
    reference tree's; ``param_count()``, the analytic count, leaves out
    the norms and biases and differs by under 0.3%."""
    want_abs = jzoo.abstract_params(jbase.get_config(arch))
    stand_in = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), want_abs)
    monkeypatch.setattr(bridge, "tensor_from_numpy",
                        lambda a, device="cpu": torch.empty(
                            a.shape, dtype=_TORCH_DTYPES[a.dtype.name],
                            device="meta"))
    want = bridge.params_from_numpy(stand_in)
    got = tzoo.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for _, t in _leaves(got))
    assert _shapes(got) == _shapes(want)
    n = sum(t.numel() for _, t in _leaves(got))
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree.leaves(want_abs))
    cfg = get_config(arch)
    assert abs(n - cfg.param_count()) <= 3e-3 * cfg.param_count()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    jfns = jzoo.build_model(jbase.get_config(arch))
    for name, spec in tbase.SHAPES.items():
        got = build_model(cfg, "meta").input_specs(spec)
        want = jfns.input_specs(jbase.SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) \
                == (tuple(want[k].shape), jnp.dtype(want[k].dtype).name), \
                (arch, name, k)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_abstract_cache_equals_the_reference(arch):
    got = tzoo.abstract_cache(get_config(arch), 2, 64)
    want = jzoo.abstract_cache(jbase.get_config(arch), 2, 64)
    flat = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            (tuple(s.shape), jnp.dtype(s.dtype).name)
            for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert _shapes(got) == flat


def test_meta_is_refused_by_the_entry_points():
    """Only the dry run's functions take ``meta``: never a default, and the
    trainer refuses it."""
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        Trainer(reduced_config(get_config("qwen3-0.6b")), TrainerConfig(),
                device="meta")


# -- roofline functions ------------------------------------------------------

def _reference_record():
    """A port Hardware record of ``hlo_analysis``'s module constants."""
    return dataclasses.replace(
        reference_hardware(), matrix_flops=jhlo.PEAK_FLOPS,
        mem_bw=jhlo.HBM_BW, link_bw=jhlo.ICI_BW, net_bw=jhlo.ICI_BW,
        alpha=1e-6, hbm_bytes=jhlo.HBM_BYTES)


def _collective_grid():
    """The inputs of tests/test_hlo_analysis.py and a grid of kinds,
    groups, payloads and counts, one kind and several together."""
    out = [{"all-reduce": {"bytes": 1e9, "count": 1, "max_group": 4}},
           {"all-gather": {"bytes": 1e9, "count": 1, "max_group": 4}}, {}]
    kinds = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
             "collective-permute")
    for g in (1, 2, 3, 16, 256, 512):
        for nbytes in (0, 1, 123_456_789, 7.3e12):
            for count in (1, 3, 294):
                out.append({kinds[(g + count) % 5]: {
                    "bytes": nbytes, "count": count, "max_group": g}})
                out.append({k: {"bytes": nbytes * (i + 1), "count": count,
                                "max_group": g} for i, k in enumerate(kinds)})
    return out


def test_roofline_functions_equal_the_reference_bit_for_bit():
    hw = _reference_record()
    for coll in _collective_grid():
        assert thlo.collective_time_s(coll, hw) \
            == jhlo.collective_time_s(coll), coll
    for flops in (0, 1e9, 1e15, 3.2e17):
        for traffic in (0, 1e9, 1e13):
            for coll in _collective_grid()[:40]:
                a = {"flops": flops, "bytes_traffic": traffic,
                     "collectives": coll}
                assert thlo.roofline_terms(a, hw) \
                    == jhlo.roofline_terms(a), a


def test_a_collective_across_nodes_moves_at_the_network_rate():
    from repro_torch.core.hardware import H100
    mesh = dry_train_mesh({"data": 2, "model": 16})
    x = torch.empty((1024,), dtype=torch.bfloat16, device="meta")
    mesh.gather(x, 0, "model")          # ranks 0-15: two nodes of 8
    mesh.reduce(x, "data")              # ranks 0 and 16
    coll = thlo.mesh_collectives(mesh, H100.node_devices)
    assert coll["all-gather"] == {"bytes": 2048 * 16, "count": 1,
                                  "max_group": 16, "net_bytes": 2048 * 16,
                                  "net_count": 1}
    assert coll["all-reduce"]["bytes"] == 4096
    one_node = thlo.mesh_collectives(mesh, 64)
    assert one_node["all-gather"]["net_bytes"] == 0
    t_net = thlo.collective_time_s({"all-gather": coll["all-gather"]}, H100)
    t_link = thlo.collective_time_s({"all-gather": one_node["all-gather"]},
                                    H100)
    assert t_net - H100.alpha == pytest.approx(
        (t_link - H100.alpha) * H100.link_bw / H100.net_bw)


# -- the kernel wrappers' hooks ------------------------------------------------

def _k2(dev, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 16), generator=g).to(dtype).to(dev)
    w = torch.randn((16,), generator=g).to(dev)
    x2 = torch.randn((10, 16), generator=g).to(dtype).to(dev)
    gy = torch.randn((6, 16), generator=g).to(dtype).to(dev)
    gy2 = torch.randn((10, 16), generator=g).to(dtype).to(dev)
    return {"fwd": (k2.rmsnorm_kernel, (x, w)),
            "pair": (k2.rmsnorm_pair_kernel, (x, w, x2, w)),
            "bwd": (k2.rmsnorm_bwd_kernel, (x, w, gy)),
            "pair_bwd": (k2.rmsnorm_pair_bwd_kernel, (x, w, gy, x2, w, gy2))}


def _k3(dev, dtype):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((4, 8, 16), generator=g).to(dtype)
    k = torch.randn((2, 12, 16), generator=g).to(dtype)
    v = torch.randn((2, 12, 16), generator=g).to(dtype)
    do = torch.randn((4, 8, 16), generator=g).to(dtype)
    o, lse = k3.flash_attention_kernel(q, k, v, True, 4)
    to = lambda *ts: tuple(t.to(dev) for t in ts)  # noqa: E731
    return {"fwd": (lambda *a: k3.flash_attention_kernel(*a, True, 4),
                    to(q, k, v)),
            "bwd": (lambda *a: k3.flash_attention_bwd_kernel(*a, True, 4),
                    to(q, k, v, o, lse, do))}


def _k7(dev, dtype):
    g = torch.Generator().manual_seed(2)
    b, t, d, n = 2, 20, 8, 4
    dt = torch.rand((b, t, d), generator=g) * 0.1
    A = -torch.rand((d, n), generator=g)
    Bm, C, x = (torch.randn(s, generator=g).to(dtype)
                for s in ((b, t, n), (b, t, n), (b, t, d)))
    h0 = torch.zeros((b, d, n))
    _, _, ckpt = k7.ssm_scan_fused_ckpt_kernel(dt, A, Bm, C, x, h0)
    dy = torch.randn((b, t, d), generator=g)
    to = lambda *ts: tuple(t.to(dev) for t in ts)  # noqa: E731
    return {"fwd": (k7.ssm_scan_fused_kernel, to(dt, A, Bm, C, x, h0)),
            "fwd_ckpt": (k7.ssm_scan_fused_ckpt_kernel,
                         to(dt, A, Bm, C, x, h0)),
            "bwd": (k7.ssm_scan_fused_bwd_kernel,
                    to(dt, A, Bm, C, x, ckpt, dy)),
            "unfused_bwd": (k7.ssm_scan_bwd_kernel, to(
                torch.rand((b, t, d, n), generator=g),
                torch.randn((b, t, d, n), generator=g),
                torch.randn((b, t, n), generator=g), ckpt, dy))}


KERNEL_CASES = [(k, e, dt) for k, entries in
                (("k2", ("fwd", "pair", "bwd", "pair_bwd")),
                 ("k3", ("fwd", "bwd")),
                 ("k7", ("fwd", "fwd_ckpt", "bwd", "unfused_bwd")))
                for e in entries for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("kernel,entry,dtype", KERNEL_CASES)
def test_the_meta_branch_counts_as_the_plain_version(kernel, entry, dtype):
    """K2 (forward, pair, backward), K3 (forward, backward) and K7 (fused
    forward, with checkpoints, backward; the unfused backward): the meta
    branch's outputs have the plain version's shapes and dtypes, and both
    count the same FLOPs, bytes and launches under ``analyze_step``."""
    make = {"k2": _k2, "k3": _k3, "k7": _k7}[kernel]
    fn, cpu_args = make("cpu", dtype)[entry]
    _, meta_args = make("meta", dtype)[entry]
    cpu = thlo.analyze_step(fn, *cpu_args)
    meta = thlo.analyze_step(fn, *meta_args)
    outs = [(tuple(t.shape), t.dtype)
            for _, t in _leaves(cpu["out"]) if t is not None]
    assert outs == [(tuple(t.shape), t.dtype)
                    for _, t in _leaves(meta["out"]) if t is not None]
    assert all(t.device.type == "meta" for _, t in _leaves(meta["out"])
               if t is not None)
    for key in ("flops", "bytes_traffic", "launches", "kernel_flops"):
        assert cpu[key] == meta[key], key
    assert sum(cpu["launches"].values()) == 1
    assert cpu["bytes_traffic"] == 2 * sum(
        t.numel() * t.element_size() for _, t in _leaves(cpu["out"])
        if t is not None)


def test_the_hooks_count_the_reference_dots():
    q = torch.empty((4, 8, 16), device="meta")
    k = torch.empty((2, 12, 16), device="meta")
    assert k3.attention_flops(q, k, 2) == 2 * 2 * 4 * 8 * 12 * 16
    fwd = thlo.analyze_step(lambda *a: k3.flash_attention_kernel(*a), q, k,
                            k)
    assert fwd["flops"] == 4 * 4 * 8 * 12 * 16
    assert k7.scan_flops(2, 20, 8, 4, 1) == 2 * 2 * 20 * 8 * 4
    norm = thlo.analyze_step(k2.rmsnorm_kernel, q[0],
                             torch.empty((16,), device="meta"))
    assert norm["flops"] == 0 and norm["launches"] == {"rmsnorm": 1}


def test_the_functions_count_forward_and_backward_alike():
    """Through the autograd Functions (what the train step calls), forward
    and backward on CPU tensors and on meta: the same counts, one launch
    of each direction."""
    def run(dev):
        g = torch.Generator().manual_seed(3)
        q = torch.randn((4, 8, 16), generator=g).to(dev).requires_grad_()
        k = torch.randn((2, 8, 16), generator=g).to(dev).requires_grad_()
        w = torch.randn((16,), generator=g).to(dev).requires_grad_()

        def step():
            o = k3.FlashAttentionFn.apply(q, k, k, True, 0)
            y = k2.RMSNormFn.apply(o.reshape(-1, 16), w, 1e-5, True)
            y.sum().backward()
        return thlo.analyze_step(step)
    cpu, meta = run("cpu"), run("meta")
    for key in ("flops", "bytes_traffic", "launches"):
        assert cpu[key] == meta[key], key
    assert cpu["launches"] == {"flash_attention": 1, "rmsnorm": 1,
                               "rmsnorm_bwd": 1, "flash_attention_bwd": 1}


# -- a train step's FLOPs against the reference's compiled step --------------

def test_a_tiny_train_step_counts_the_reference_matmul_flops():
    """Reduced qwen3, remat off, B 4 x S 32: the port's single-device step
    on the CPU (the K3 and K2 plain versions inside their hooks) counts
    exactly the dot FLOPs ``analyze_hlo`` reads from the reference's step
    compiled by XLA:CPU (which keeps every dot a ``dot``)."""
    b, s = 4, 32
    jcfg = jbase.reduced_config(jbase.get_config("qwen3-0.6b"))
    jstep, jopt = jax_make_train_step(jcfg, remat=False)
    jparams = jzoo.abstract_params(jcfg)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
             for k in ("tokens", "labels")}
    text = jax.jit(jstep).lower(jparams, jax.eval_shape(jopt.init, jparams),
                                batch).compile().as_text()
    assert "custom-call" not in text
    want = jhlo.analyze_hlo(text, 1)["flops"]

    cfg = reduced_config(get_config("qwen3-0.6b"))
    step, opt = make_train_step(cfg, remat=False, device="cpu")
    params = build_model(cfg, "cpu").init(0)
    g = torch.Generator().manual_seed(0)
    tb = {k: torch.randint(0, cfg.vocab, (b, s), generator=g,
                           dtype=torch.int32) for k in ("tokens", "labels")}
    got = thlo.analyze_step(step, params, opt.init(params), tb)
    assert got["flops"] == want
    assert got["launches"]["flash_attention"] == cfg.n_layers
    # the same step on meta counts the same
    meta = thlo.analyze_step(
        make_train_step(cfg, remat=False, device="meta")[0],
        tzoo.abstract_params(cfg), opt.init(tzoo.abstract_params(cfg)),
        tzoo.input_specs(cfg, ShapeSpec("tiny", s, b, "train")))
    assert meta["flops"] == want


# -- prefill and decode steps' FLOPs against the reference's compiled steps --

SERVE_FLOP_ARCHS = ("qwen3-0.6b", "falcon-mamba-7b")


def _jax_serve_text(arch, kind, b, s):
    """``as_text`` of the reference's ``make_prefill_step`` (B x S tokens)
    or ``make_decode_step`` (one token a row over a cache of capacity S)
    jitted on one device, on abstract inputs."""
    from repro.launch.steps import make_decode_step as jdecode
    from repro.launch.steps import make_prefill_step as jprefill
    jcfg = jbase.reduced_config(jbase.get_config(arch))
    jparams = jzoo.abstract_params(jcfg)
    jfns = jzoo.build_model(jcfg)
    if kind == "prefill":
        return jax.jit(jprefill(jcfg)).lower(
            jparams, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}) \
            .compile().as_text()
    batch = {"token": jax.ShapeDtypeStruct((b, 1), jnp.int32)}
    if jcfg.family != "ssm":
        batch["cur_len"] = jax.ShapeDtypeStruct((), jnp.int32)
    cache = jax.eval_shape(lambda: jfns.make_cache(b, s))
    return jax.jit(jdecode(jcfg)).lower(jparams, cache, batch) \
        .compile().as_text()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVE_FLOP_ARCHS)
def test_a_tiny_serve_step_counts_the_reference_matmul_flops(arch, kind):
    """Reduced qwen3 and falcon-mamba, B 4 x S 32: the port's one-device
    prefill step, and its decode step over a cache of capacity 32, on the
    CPU (K2 and K7's plain versions inside their hooks) count exactly the
    dot FLOPs ``analyze_hlo`` reads from the reference's step compiled by
    XLA:CPU; so do the dry run's counts of the same steps on a 1x1
    virtual mesh on meta."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    b, s = 4, 32
    text = _jax_serve_text(arch, kind, b, s)
    assert "custom-call" not in text
    want = jhlo.analyze_hlo(text, 1)["flops"]

    cfg = reduced_config(get_config(arch))
    fns = build_model(cfg, "cpu")
    params = fns.init(0)
    g = torch.Generator().manual_seed(0)
    if kind == "prefill":
        got = thlo.analyze_step(make_prefill_step(cfg, "cpu"), params, {
            "tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                    dtype=torch.int32)})
    else:
        batch = {"token": torch.randint(0, cfg.vocab, (b, 1), generator=g,
                                        dtype=torch.int32)}
        if cfg.family != "ssm":
            batch["cur_len"] = s - 1
        got = thlo.analyze_step(make_decode_step(cfg, "cpu"), params,
                                fns.make_cache(b, s), batch)
    assert got["flops"] == want, (got["flops"], want)
    assert got["launches"]["rmsnorm"] > 0
    if cfg.family == "ssm":
        assert got["launches"]["ssm_scan"] == cfg.n_layers
    count = {"prefill": dryrun.count_prefill_step,
             "decode": dryrun.count_decode_step}[kind]
    meta = count(cfg, ShapeSpec("tiny", s, b, kind),
                 dry_train_mesh({"data": 1, "model": 1}))
    assert meta["flops"] == want
    assert meta["launches"] == got["launches"]


# -- the virtual mesh against gloo ranks ---------------------------------------

def _issued_jobs(world):
    """qwen3 and falcon-mamba under fsdp_tp and qwen3 with int8 moments,
    one step on each mesh of ``world`` ranks."""
    meshes = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}[world]
    return [ranks.Job(f"{name}_{d}x{m}", arch=arch, mesh=(d, m), steps=1,
                      opt_state=opt)
            for d, m in meshes
            for name, arch, opt in (("qwen", "qwen3-0.6b", "f32"),
                                    ("falcon", "falcon-mamba-7b", "f32"),
                                    ("int8", "qwen3-0.6b", "int8"))]


# the attention layouts of a 16-way model axis at 4 ranks: one KV head a
# rank (4 over 2 heads on 1x4), and heads that do not split (6 over 1x4:
# qwen's 6 over 2, whisper's 6 over 6) run whole on each model rank
LAYOUT_JOBS = [
    ranks.Job("kv_head_1x4", mesh=(1, 4), steps=2),
    ranks.Job("kv_head_2x2", heads=(4, 1), mesh=(2, 2), steps=2),
    ranks.Job("whole_heads_1x4", heads=(6, 2), mesh=(1, 4), steps=2),
    ranks.Job("whisper_whole_heads_1x4", arch="whisper-small", heads=(6, 6),
              mesh=(1, 4), steps=2)]


@pytest.fixture(scope="module")
def gloo_runs():
    """rank 0's results of the jobs on 2 and 4 gloo ranks."""
    two = spawn_ranks(ranks.train_world, 2, args=(_issued_jobs(2),))[0]
    four = spawn_ranks(ranks.train_world, 4,
                       args=(_issued_jobs(4) + LAYOUT_JOBS,))[0]
    return {**two, **four}


def _dry_issued(job):
    mesh = dry_train_mesh({"data": job.mesh[0], "model": job.mesh[1]})
    dryrun.count_train_step(
        ranks.cfg_of(job.arch, job.layers, job.vocab, job.heads),
        ShapeSpec(job.name, job.seq, job.batch, "train"), mesh,
        opt_cfg=AdamWConfig(state_dtype=job.opt_state))
    return mesh.issued


@pytest.mark.parametrize("job", _issued_jobs(2) + _issued_jobs(4)
                         + LAYOUT_JOBS, ids=lambda j: j.name)
def test_the_virtual_mesh_issues_the_gloo_ranks_collectives(job, gloo_runs):
    """One step on a ``DryTrainMesh`` of the job's shape, on meta, issues
    the collectives (calls and bytes, by kind) that rank 0 of the gloo
    group issued a step in ``TrainMesh.issued``."""
    got = _dry_issued(job)
    want = gloo_runs[job.name]["issued"]
    for kind in want:
        assert got[kind][:2] == [v // job.steps for v in want[kind][:2]], \
            (job.name, kind, got, want)
        assert got[kind][2] == 0.0


@pytest.mark.parametrize("job", LAYOUT_JOBS, ids=lambda j: j.name)
def test_the_sixteen_way_attention_layouts_train_as_one_device(job,
                                                               gloo_runs):
    """Losses and gradient norms within 1e-4 of the single-device Trainer's
    and the trained weights within 1e-3 of each leaf's largest."""
    got = gloo_runs[job.name]
    want = ranks.run(job)
    for key in ("losses", "grad_norms"):
        assert len(got[key]) == len(want[key]) == job.steps
        for a, b in zip(got[key], want[key]):
            assert abs(a - b) <= LOSS_TOL * abs(b), (job.name, key)
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                               1e-30)
        assert err <= LEAF_TOL, (job.name, i, err)


# -- the vocab-parallel loss at production scale --------------------------------

def _whole_logits_loss(cfg, p, h, labels, shard=None):
    """The training loss with the logits gathered whole over "model"
    before the f32 cross-entropy (the port's loss before it was
    vocab-parallel)."""
    from repro_torch.models.layers import (logits_from_hidden,
                                           softmax_cross_entropy)
    return softmax_cross_entropy(logits_from_hidden(cfg, p, h, shard),
                                 labels)


def _train_4k_pod1(arch):
    return dryrun.count_train_step(get_config(arch),
                                   tbase.SHAPES["train_4k"],
                                   dryrun.cell_mesh("pod1"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-small"])
def test_the_train_loss_keeps_the_logits_split_on_model(arch, monkeypatch):
    """``train_4k`` on pod1 (16 x 16) on meta, against the same step with
    the logits gathered whole before the loss: qwen3-0.6b's 151,936-word
    head stays split over the 16 model ranks, so its peak fits the card
    (the whole logits' does not) and its all-gathers a step fall by at
    least the bf16 logits of the rank's rows, (16, 4,096, 151,936);
    whisper-small's 51,865 does not divide 16, so its logits are whole
    either way and nothing moves."""
    from repro_torch.core.hardware import H100
    from repro_torch.models import encdec, transformer
    split = _train_4k_pod1(arch)
    for mod in (transformer, encdec):
        monkeypatch.setattr(mod, "lm_head_loss", _whole_logits_loss)
    whole = _train_4k_pod1(arch)
    if arch == "whisper-small":
        assert split["collectives"] == whole["collectives"]
        assert split["peak_bytes"] == whole["peak_bytes"]
        return
    ag = {k: r["collectives"]["all-gather"]["bytes"]
          for k, r in (("split", split), ("whole", whole))}
    spec = tbase.SHAPES["train_4k"]
    logits = spec.global_batch // 16 * spec.seq_len \
        * get_config(arch).vocab * 2
    assert split["peak_bytes"] <= H100.hbm_bytes < whole["peak_bytes"]
    assert ag["split"] <= ag["whole"] - logits, (ag, logits)
    assert split["flops"] == whole["flops"]


# -- run_cell end to end ---------------------------------------------------------

# fields of the reference's result that only XLA gives
XLA_ONLY = {"lower_s", "compile_s", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes", "alias_size_in_bytes",
            "xla_cost_flops", "xla_cost_bytes", "hlo_lines", "skip_reason"}
PORT_ONLY = {"argument_bytes_per_device", "peak_bytes_per_device", "fits",
             "hardware", "analyze_s", "launches", "mesh_shape"}


def _reference_fields():
    """The keys the reference's ``run_cell`` writes, read from its source."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    body = src[src.index("def run_cell"):src.index("def all_cells")]
    return set(re.findall(r'result\["(\w+)"\]', body)) \
        | set(re.findall(r'"(\w+)": ', body[:body.index("ok, why")]))


@pytest.mark.parametrize("kind,shape,devices", [
    ("pod1", {"data": 2, "model": 2}, 4),
    ("pod2", {"pod": 2, "data": 2, "model": 2}, 8)])
def test_run_cell_writes_the_reference_fields(kind, shape, devices,
                                              monkeypatch, tmp_path):
    """A tiny registered cell (reduced qwen3, B 8 x S 32) on virtual 2x2
    and 2x2x2 meshes: status ok, FLOPs counted, and the reference's fields
    less the XLA-only ones, with the port's memory fields.  The reference's
    own mesh dry run fails under this jax, so fields are compared, not
    values."""
    monkeypatch.setitem(tbase._REGISTRY, "tiny-qwen",
                        lambda: reduced_config(get_config("qwen3-0.6b")))
    monkeypatch.setitem(tbase.SHAPES, "tiny_train",
                        ShapeSpec("tiny_train", 32, 8, "train"))
    monkeypatch.setattr(tmesh, "production_mesh_shape",
                        lambda multi_pod=False: MeshShape(shape))
    out = tmp_path / "cell.json"
    res = dryrun.run_cell("tiny-qwen", "tiny_train", kind, out)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["status"] == "ok" and res["devices"] == devices
    assert res["hlo_flops_per_device"] > 0
    assert res["peak_bytes_per_device"] >= res["argument_bytes_per_device"] \
        > 0
    assert res["fits"] is True
    assert set(res) == (_reference_fields() - XLA_ONLY) | PORT_ONLY
    assert set(res["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "bottleneck", "step_time_s"}
    assert set(res["collectives"]) == {"all-gather", "all-reduce"}


@pytest.mark.parametrize("arch,kind,batch", [
    ("qwen3-0.6b", "prefill", 8), ("qwen3-0.6b", "decode", 8),
    ("zamba2-2.7b", "decode", 1), ("whisper-small", "prefill", 8)])
def test_run_cell_writes_the_reference_fields_for_inference(
        arch, kind, batch, monkeypatch, tmp_path):
    """A tiny registered prefill or decode cell (the reduced arch, S 32)
    on a virtual 2x2 mesh: status ok, FLOPs counted, and the reference's
    fields less the XLA-only ones, with the port's memory fields; a
    decode cell also writes its cache's and states' bytes a device.  The
    reference's model FLOPs are 2 N_active B (S at prefill)."""
    monkeypatch.setitem(tbase._REGISTRY, "tiny",
                        lambda: reduced_config(get_config(arch)))
    monkeypatch.setitem(tbase.SHAPES, "tiny_serve",
                        ShapeSpec("tiny_serve", 32, batch, kind))
    monkeypatch.setattr(tmesh, "production_mesh_shape",
                        lambda multi_pod=False: MeshShape(
                            {"data": 2, "model": 2}))
    out = tmp_path / "cell.json"
    res = dryrun.run_cell("tiny", "tiny_serve", "pod1", out)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["status"] == "ok" and res["kind"] == kind
    assert res["hlo_flops_per_device"] > 0
    assert res["peak_bytes_per_device"] >= res["argument_bytes_per_device"]
    extra = {"cache_bytes_per_device", "state_bytes_per_device"} \
        if kind == "decode" else set()
    assert set(res) == (_reference_fields() - XLA_ONLY) | PORT_ONLY | extra
    cfg = reduced_config(get_config(arch))
    tokens = batch * (32 if kind == "prefill" else 1)
    assert res["model_flops_global"] == 2 * cfg.active_param_count() * tokens
    if kind == "decode":
        # whole K/V leaves of 2 heads a rank (zamba2: 4 kv heads over 2
        # model ranks; batch 1: the positions over the 2 data ranks)
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        n = cfg.n_layers // cfg.hybrid.attn_every if cfg.hybrid \
            else cfg.n_layers
        whole = 2 * n * batch * 32 * kv * hd * 4
        assert res["cache_bytes_per_device"] == whole // 4
        assert (res["state_bytes_per_device"] > 0) == (cfg.hybrid is not None)


def test_a_skipped_cell_writes_the_reference_reason(tmp_path):
    out = tmp_path / "cell.json"
    res = dryrun.run_cell("qwen3-0.6b", "long_500k", "pod1", out)
    assert json.loads(out.read_text()) == res
    assert res["status"] == "skipped"
    assert res["skip_reason"] == jbase.cell_is_runnable(
        jbase.get_config("qwen3-0.6b"), jbase.SHAPES["long_500k"])[1]
