"""The port's sharding spec functions against the reference's, exactly:
``param_specs``, ``batch_specs``, ``cache_specs``, ``paged_cache_specs``
and ``opt_state_specs`` on ``jax.eval_shape`` of the reference's own init,
caches and optimizer state, for every registered arch at its full size, at
the mesh shapes {data:1, model:1}, {data:2, model:4}, {data:16, model:16}
and {pod:2, data:16, model:16}, under REPRO_TRAIN_SHARDING fsdp_tp and dp.
A mesh here is only its axis sizes (``.shape``), for both packages.  Also
``local_shard``, the mesh helpers, and ``ndsbp_to_pspec`` on the layouts
the TP search emits."""
import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_archs
from repro.core.distribution import choose_tp_layout as r_choose_tp_layout
from repro.distributed import param_sharding as r_ps
from repro.distributed import sharding as r_sh
from repro.models import build_model as jax_build_model
from repro.train.optimizer import AdamW, AdamWConfig
from repro.train.optimizer import Quantized as RQuantized
from repro_torch.core.distribution import choose_tp_layout, ndsbp_to_pspec
from repro_torch.core.sbp import Placement
from repro_torch.distributed import sharding as t_sh
from repro_torch.launch.mesh import (MeshShape, make_local_mesh,
                                     mesh_device_count,
                                     production_mesh_shape)
from repro_torch.train.optimizer import Quantized

torch.set_num_threads(1)

ARCHS = list_archs()
MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
MODES = ("fsdp_tp", "dp")
FUNCTIONS = ("param", "batch", "cache", "paged_cache", "opt_state")


@functools.lru_cache(maxsize=None)
def abstract(arch):
    """The reference's abstract params, decode caches (B 8 and 32), paged
    cache (where the family has one) and f32 / int8 AdamW states."""
    cfg = jax_get_config(arch)
    fns = jax_build_model(cfg)
    params = jax.eval_shape(lambda: fns.init(jax.random.PRNGKey(0)))
    caches = [jax.eval_shape(lambda b=b, s=s: fns.make_cache(b, s))
              for b, s in ((8, 64), (32, 256))]
    paged = None
    if fns.make_paged_cache is not None:
        kw = {"state_slots": 5} if cfg.family in ("ssm", "hybrid") else {}
        paged = jax.eval_shape(lambda: fns.make_paged_cache(33, 16, **kw))
    opts = [jax.eval_shape(lambda d=d: AdamW(AdamWConfig(
        state_dtype=d)).init(params)) for d in ("f32", "int8")]
    return cfg, params, caches, paged, opts


def batches(cfg):
    """Training and decode batch shapes of the arch's family."""
    sd = jax.ShapeDtypeStruct
    out = []
    for b, s in ((8, 64), (32, 128)):
        if cfg.family == "vlm":
            x = {"embeds": sd((b, s, cfg.d_model), jnp.float32),
                 "positions": sd((3, b, s), jnp.int32)}
        elif cfg.family == "audio":
            x = {"frames": sd((b, 1500, cfg.d_model), jnp.float32),
                 "tokens": sd((b, s), jnp.int32)}
        else:
            x = {"tokens": sd((b, s), jnp.int32)}
        out.append(dict(x, labels=sd((b, s), jnp.int32)))
        out.append({"token": sd((b, 1), jnp.int32),
                    "cur_len": sd((), jnp.int32)})
    return out


def ref_flat(tree):
    """{path: spec} of a reference spec tree (a quantized moment's spec as
    (q, scale, shape, pad))."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (PartitionSpec, RQuantized)))[0]
    out = {}
    for path, v in leaves:
        key = "/".join(r_ps._path_keys(path))
        out[key] = (tuple(v.q), tuple(v.scale), tuple(v.shape), v.pad) \
            if isinstance(v, RQuantized) else tuple(v)
    return out


def port_flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_flat(v, path + (str(i),)))
        return out
    if isinstance(tree, Quantized):
        tree = (tree.q, tree.scale, tuple(tree.shape), tree.pad)
    return {"/".join(path): tree}


def to_port_quantized(tree):
    return jax.tree.map(
        lambda x: Quantized(x.q, x.scale, x.shape, x.pad)
        if isinstance(x, RQuantized) else x, tree,
        is_leaf=lambda x: isinstance(x, RQuantized))


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, fn, monkeypatch):
    cfg, params, caches, paged, opts = abstract(arch)
    if fn == "paged_cache" and paged is None:
        assert cfg.family == "audio"      # the paged engine refuses it
        caches, fn = [jax.eval_shape(lambda: jax_build_model(cfg)
                                     .make_cache(32, 256))], "cache"
    for mode in MODES:
        monkeypatch.setenv("REPRO_TRAIN_SHARDING", mode)
        for shape in MESHES:
            mesh = types.SimpleNamespace(shape=dict(shape))
            if fn == "param":
                cases = [(r_sh.param_specs(cfg, params, mesh),
                          t_sh.param_specs(cfg, params, mesh))]
            elif fn == "batch":
                cases = [(r_sh.batch_specs(cfg, b, mesh),
                          t_sh.batch_specs(cfg, b, mesh))
                         for b in batches(cfg)]
            elif fn == "cache":
                cases = [(r_sh.cache_specs(cfg, c, mesh),
                          t_sh.cache_specs(cfg, c, mesh)) for c in caches]
            elif fn == "paged_cache":
                cases = [(r_sh.paged_cache_specs(cfg, paged, mesh),
                          t_sh.paged_cache_specs(cfg, paged, mesh))]
            else:
                rp = r_sh.param_specs(cfg, params, mesh)
                tp = t_sh.param_specs(cfg, params, mesh)
                cases = [(r_sh.opt_state_specs(rp, o, mesh),
                          t_sh.opt_state_specs(tp, to_port_quantized(o),
                                               mesh)) for o in opts]
            for want, got in cases:
                want, got = ref_flat(want), port_flat(got)
                assert got == want, (mode, shape)


def test_local_shard_cuts_the_rank_slice():
    """A rank's slice under a spec: one axis, two axes on one dim
    (row-major, as the reference lays them out), a dim no axis names; a
    tensor of its own."""
    mesh = MeshShape({"pod": 2, "data": 2, "model": 4})
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    got = t_sh.local_shard(x, (("pod", "data"), "model"), mesh,
                           {"pod": 1, "data": 0, "model": 3})
    assert torch.equal(got, x[4:6, 9:12]) and got.is_contiguous()
    got[0, 0] = -1
    assert x[4, 9] == 4 * 12 + 9
    assert torch.equal(t_sh.local_shard(x, (None, "model"), mesh,
                                        {"model": 1}), x[:, 3:6])
    with pytest.raises(ValueError, match="does not split"):
        t_sh.local_shard(x, ("model", None), MeshShape({"model": 3}),
                         {"model": 0})


def test_mesh_shapes_and_local_mesh():
    """The production meshes as axis sizes, a local mesh of one without a
    process group, and their device counts."""
    assert production_mesh_shape().shape == {"data": 16, "model": 16}
    big = production_mesh_shape(multi_pod=True)
    assert list(big.shape) == ["pod", "data", "model"]
    assert mesh_device_count(big) == 512
    assert t_sh.fsdp_axes(big) == ("pod", "data")
    assert t_sh.batch_axes(big) == ("pod", "data")
    assert make_local_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("n_model", [2, 4])
def test_ndsbp_to_pspec_gives_the_tp_rules_trailing(n_model):
    """The TP search's chosen ND-SBP of each weight, as a spec, is the
    trailing spec ``choose_tp_rules`` gives that weight family, in both
    packages (column (None, "model"), row ("model", None))."""
    from jax.sharding import PartitionSpec as P
    from repro.core.distribution import ndsbp_to_pspec as r_ndsbp
    from repro.core.sbp import Placement as RPlacement
    kw = dict(d_model=64, q_dim=64, d_ff=128, vocab=256, n_model=n_model)
    pl, rpl = Placement(("model",), (n_model,)), RPlacement(("model",),
                                                           (n_model,))
    want = {"column": (None, "model"), "row": ("model", None)}
    r_plan = r_choose_tp_layout(**kw)
    for name, c in choose_tp_layout(**kw).choices.items():
        assert ndsbp_to_pspec(c.sbp, pl, 2) == want[c.kind]
        assert r_ndsbp(r_plan.choices[name].sbp, rpl, 2) == P(*want[c.kind])
