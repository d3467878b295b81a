"""Helpers shared by the ``test_torch_*`` files: the same seeded weights and
inputs go through the JAX package and the PyTorch port on the CPU."""
import jax
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge

DENSE_ARCHS = ("qwen3-0.6b", "phi3-mini-3.8b", "stablelm-3b", "nemotron-4-15b")

# f32 module outputs and per-step logits (float32 reassociation makes the
# bound relative to the reference's magnitude)
MODULE_TOL = 2e-5
LOGITS_TOL = 1e-4


def reduced(arch):
    """(JAX config, port config) of the reduced f32 arch."""
    from repro_torch.configs.base import get_config, reduced_config
    return jax_reduced_config(jax_get_config(arch)), \
        reduced_config(get_config(arch))


def bridged_params(arch, seed=0):
    """JAX ``init_lm`` weights and the same weights as port tensors."""
    jcfg, tcfg = reduced(arch)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    return jcfg, tcfg, jparams, tparams


def assert_close(got, want, tol, what=""):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|diff| {err:.3g} > {bound:.3g}"
