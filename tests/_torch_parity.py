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


def reference_hardware():
    """A ``repro_torch`` Hardware record holding the JAX package's own
    device constants, read from its modules here, so that the port's
    compiler run on it must reproduce the reference exactly.  The two
    alignments have no module constant: ``kernel_plan`` of a schedule whose
    tiles are 1 aligns them up to exactly those values."""
    import dataclasses
    from repro.core import codegen, cost_model, vectorize
    from repro.core.schedule import minlp, ntt
    from repro_torch.core.hardware import Hardware
    probe = codegen.kernel_plan(minlp.Schedule({0: {"i": 1, "l": 1}},
                                               0.0, 0.0, 0.0, 0))
    assert minlp.HBM_BW == cost_model.HBM_BW
    defaults = {f.name: f.default
                for f in dataclasses.fields(codegen.KernelPlan)}
    return Hardware(
        name="reference constants",
        matrix_flops=cost_model.PEAK_FLOPS,
        vector_flops=cost_model.VPU_FLOPS,
        mem_bw=cost_model.HBM_BW,
        link_bw=cost_model.ICI_BW,
        alpha=cost_model.ALPHA,
        unpacked_matrix_eff=cost_model.UNPACKED_MXU_EFF,
        unpacked_vector_eff=cost_model.UNPACKED_VPU_EFF,
        onchip_bytes=minlp.VMEM_BYTES,
        double_buffer=minlp.DOUBLE_BUFFER,
        clock_hz=ntt.CLOCK_HZ,
        matrix_macs_per_cycle=ntt.MXU_MACS_PER_CYCLE,
        vector_elems_per_cycle=ntt.VPU_LANES,
        matrix_tile=ntt.MICRO_KERNELS["matmul"].tile,
        vector_tile=ntt.MICRO_KERNELS["exp"].tile,
        matrix_lanes=vectorize.MXU_LANES,
        vector_lanes=vectorize.VPU_LANES,
        tile_align=probe.block_m,
        fine_align=probe.paged_block_kv,
        **defaults)


def port_term(t):
    """The same term built from ``repro_torch.core.tensor_ir``."""
    from repro_torch.core.tensor_ir import Term
    return Term(t.op, tuple(port_term(c) for c in t.children), t.attrs)
