"""The port's codegen against ``repro.core.codegen``.

``compile_term`` runs the same seeded numpy inputs through the JAX
reference and the port.  With kernels on, the reference runs its Pallas
matmul kernel in interpret mode and the port (CPU tensors) its matmul
kernel's plain version.  f32 outputs are held to a relative 1e-5 per output
row (``ref.row_rel_err``): the two sum in different orders (reassociation),
and an absolute 1e-5 is already missed at outputs of size ~9 (the
reference's own golden test sees 1.24e-5 there).  Layout transforms move
data only and must agree exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_term, reference_hardware
from repro.core import codegen as r_cg
from repro.core import tensor_ir as r_ir
from repro.core.schedule.minlp import Schedule as RSchedule
from repro.core.vectorize import auto_vectorize
from repro_torch.core import codegen as t_cg
from repro_torch.core.hardware import H100
from repro_torch.core.schedule.minlp import Schedule as TSchedule
from repro_torch.kernels import matmul as k4
from repro_torch.kernels import ref

torch.set_num_threads(1)

REF = reference_hardware()
ROW_TOL_F32 = 1e-5


def _inputs(shapes, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in shapes.items()}


def _run_both(term, env, kernels):
    want = r_cg.compile_term(term, use_pallas=kernels)(
        **{k: jnp.asarray(v) for k, v in env.items()})
    got = t_cg.compile_term(port_term(term), use_kernels=kernels)(
        **{k: torch.from_numpy(v) for k, v in env.items()})
    return got, torch.from_numpy(np.array(want))


def _attn(ir, q, span, hd):
    Q, K, V = ir.inp("Q", (q, hd)), ir.inp("K", (hd, span)), \
        ir.inp("V", (span, hd))
    return ir.matmul(ir.unary(ir.matmul(Q, K), kind="exp"), V)


TERMS = {
    # the engine's decode and prefill-chunk terms, at test width
    "decode": (lambda: _attn(r_ir, 1, 256, 64)),
    "prefill": (lambda: _attn(r_ir, 128, 256, 128)),
    "mlp_silu": (lambda: r_ir.matmul(
        r_ir.unary(r_ir.matmul(r_ir.inp("x", (16, 64)),
                               r_ir.inp("w1", (64, 96))), kind="silu"),
        r_ir.inp("w2", (96, 64)))),
    "all_ops": (lambda: r_ir.binary(
        r_ir.unary(r_ir.transpose(r_ir.inp("a", (8, 8)), (1, 0)), kind="gelu"),
        r_ir.unary(r_ir.inp("b", (8, 8)), kind="relu2"), kind="sub")),
}


def _shapes(term):
    out = {}

    def walk(t):
        if t.op == "input":
            out[t.attr("name")] = t.attr("shape")
        for c in t.children:
            walk(c)
    walk(term)
    return out


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name", sorted(TERMS))
def test_compile_term_matches_reference(name, kernels):
    term = TERMS[name]()
    env = _inputs(_shapes(term))
    n0 = k4.launches
    got, want = _run_both(term, env, kernels)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ref.row_rel_err(got, want)[1] <= ROW_TOL_F32
    assert k4.launches == n0     # CPU tensors never launch the kernel


@pytest.mark.parametrize("kernels", [False, True])
def test_packed_term_matches_reference(kernels):
    """A vectorized (packed) term: packed_matmul and pass-through layouts."""
    term = _attn(r_ir, 256, 256, 128)
    _, packed, _ = auto_vectorize(term)
    assert packed != term
    env = _inputs(_shapes(term), seed=1)
    got, want = _run_both(packed, env, kernels)
    assert ref.row_rel_err(got, want)[1] <= ROW_TOL_F32
    plain, _ = _run_both(term, env, kernels)
    assert ref.row_rel_err(got, plain)[1] <= ROW_TOL_F32


@pytest.mark.parametrize("lanes,shape", [((8, 128), (128, 256)),
                                         ((128, 128), (256, 128)),
                                         ((64, 64), (128, 192)),
                                         ((1, 256), (3, 512))])
def test_pack_unpack_match_reference_exactly(lanes, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    r = np.asarray(r_cg._pack_array(jnp.asarray(x), lanes, (0, 1)))
    t = t_cg._pack_array(torch.from_numpy(x), lanes, (0, 1))
    np.testing.assert_array_equal(t.numpy(), r)
    back = t_cg._unpack_array(t, lanes, (0, 1), 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(r_cg._unpack_array(jnp.asarray(r), lanes, (0, 1), 2)),
        back.numpy())


def test_kernel_plan_matches_reference():
    """Under the reference record the plan, its page and LoRA mappings
    equal the reference's; under the H100 record they are the record's."""
    cases = [{}, {0: {"i": 300, "j": 1000, "k": 70, "l": 20}},
             {0: {"i": 1, "l": 1}}, {0: {"l0": 1, "l2": 2048, "l1": 4}}]
    for tiles in cases:
        r = r_cg.kernel_plan(RSchedule(tiles, 0.0, 0.0, 0.0, 0))
        t = t_cg.kernel_plan(TSchedule(tiles, 0.0, 0.0, 0.0, 0), hw=REF)
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
        for bs, m in ((16, 128), (16, 4), (5, 7), (0, 3)):
            assert r_cg.paged_pages_per_fetch(r, bs, m) == \
                t_cg.paged_pages_per_fetch(t, bs, m)
        for out_dim, rank in ((1024, 8), (64, 33), (4096, 1)):
            assert r_cg.lora_tiles(r, out_dim, rank) == \
                t_cg.lora_tiles(t, out_dim, rank)
    h = t_cg.kernel_plan(TSchedule({}, 0.0, 0.0, 0.0, 0))
    assert h == t_cg.KernelPlan()
    assert (h.block_m, h.block_n, h.block_k, h.paged_block_kv) == \
        (H100.block_m, H100.block_n, H100.block_k, H100.paged_block_kv)
    aligned = t_cg.kernel_plan(TSchedule({0: {"i": 300, "l": 20}},
                                         0.0, 0.0, 0.0, 0))
    assert aligned.block_m % H100.tile_align == 0
    assert aligned.paged_block_kv % H100.fine_align == 0


def test_unknown_op_is_refused():
    from repro_torch.core.tensor_ir import T, inp
    with pytest.raises(ValueError, match="unknown op"):
        t_cg.compile_term(T("box", inp("x", (2, 2))))(x=torch.zeros(2, 2))
