"""Params and paged caches cross the numpy bridge bit for bit, f32 and
bf16 (bf16 as a uint16 view; ``ml_dtypes`` appears only here, in the
test)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced_config
from repro.models import build_model
from repro.models import transformer as jtf
from repro_torch import bridge

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bitwise(dtype):
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-0.6b")),
                              dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        build_model(cfg).init(jax.random.PRNGKey(0)))
    params = bridge.params_from_numpy(tree, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    want_t = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert params["layers"][1]["attn"]["wq"].dtype == want_t
    # layer 1 of the port is slice 1 of the JAX stack, value for value
    np.testing.assert_array_equal(
        params["layers"][1]["attn"]["wq"].float().numpy(),
        tree["layers"][0]["attn"]["wq"][1].astype(np.float32))
    back = bridge.params_to_numpy(params, bf16_dtype=ml_dtypes.bfloat16)
    got, want = dict(_flat(back)), dict(_flat(tree))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_cache_round_trip_bitwise(dtype):
    cfg = reduced_config(get_config("qwen3-0.6b"))
    rng = np.random.default_rng(0)
    cache = {k: np.asarray(v + jnp.asarray(
        rng.normal(size=v.shape), dtype))
        for k, v in jtf.make_paged_cache(cfg, 5, 4, dtype).items()}
    tcache = bridge.paged_cache_from_numpy(cache, "cpu")
    assert tcache["k"].shape == (cfg.n_layers, 5, 4, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)
    raw = bridge.paged_cache_to_numpy(tcache)
    typed = bridge.paged_cache_to_numpy(tcache, bf16_dtype=ml_dtypes.bfloat16)
    for k in cache:
        np.testing.assert_array_equal(typed[k].view(np.uint8),
                                      cache[k].view(np.uint8))
        if dtype == jnp.bfloat16:
            assert raw[k].dtype == np.uint16
            np.testing.assert_array_equal(
                tcache[k].float().numpy(), cache[k].astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,family", [("falcon-mamba-7b", "ssm"),
                                         ("zamba2-2.7b", "hybrid")])
def test_stateful_params_round_trip_bitwise(arch, family, dtype):
    """``init_ssm_lm`` ((L, ...) stacks in one dict) and ``init_hybrid``
    ((n_seg, per, ...) stacks beside the shared block) cross to per-layer
    dicts in forward order and back, bit for bit."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        build_model(cfg).init(jax.random.PRNGKey(0)))
    params = bridge.params_from_numpy(tree, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    last = cfg.n_layers - 1
    want = tree["layers"]["mamba"]["in_proj" if family == "ssm"
                                   else "in_proj_zx"]
    want = want[last] if family == "ssm" \
        else want[last // cfg.hybrid.attn_every, last % cfg.hybrid.attn_every]
    got = params["layers"][last]["mamba"]["in_proj" if family == "ssm"
                                          else "in_proj_zx"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    every = cfg.hybrid.attn_every if family == "hybrid" else 1
    back = bridge.params_to_numpy(params, every=every, family=family,
                                  bf16_dtype=ml_dtypes.bfloat16)
    got, want = dict(_flat(back)), dict(_flat(tree))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)
    jcache = build_model(cfg).make_paged_cache(5, 4, state_slots=3)
    tcache = bridge.paged_cache_from_numpy(jax.tree.map(np.asarray, jcache))
    again = bridge.paged_cache_to_numpy(tcache, bf16_dtype=ml_dtypes.bfloat16)
    assert jax.tree.structure(again) == jax.tree.structure(
        jax.tree.map(np.asarray, jcache))
