"""The port's segmented LoRA ops (K5 shrink, K6 expand, and the fused
delta that runs both and adds the base in one launch) against the JAX
package.

On the CPU the port's wrappers run their plain versions; JAX runs its Pallas
kernels in interpret mode (``repro.kernels.ops``), as
``tests/test_lora_kernel.py`` does.  The grid is that file's: ragged per-row
adapter mixes, ragged ranks in one slab, GQA-shaped projections, bf16 slabs
and the expand tile.  Tolerances: f32 1e-5, which is float32
reassociation of a d-term sum; bf16 2e-2, where both sides compute in f32
from the same bf16 inputs and round the expand output to bf16 once, so they
differ by at most one bf16 step (2^-8 relative) where the two f32 sums
straddle a rounding point.  The fused delta's CPU path is bitwise the
composition of the other two (plus the add), takes one slot per sequence of
``rows_per_seq`` rows, and agrees with the JAX model glue on slabs built by
both adapter stores.  A ``gpu`` test holds the CUDA kernels against the
plain versions on a card and skips without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import MODULE_TOL, assert_close
from repro.kernels import ops as jops
from repro.models import lora as jlora
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lora import (lora_delta_kernel, lora_expand_kernel,
                                     lora_shrink_kernel, tensor_core_rows)
from repro_torch.models import lora as tlora

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

IDX_MIXES = [
    [0, 1, 2, 0],           # ragged mix, repeats
    [-1, -1, -1, -1],       # all base rows
    [2, -1, 0, -1],         # interleaved base / adapter
    [1],                    # single row
]


def _both(a, dtype="float32"):
    """(jax array, torch tensor) of one numpy input, bf16-rounded alike."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _case(rng, shapes, dtype="float32", scale=0.5):
    return [_both((rng.normal(size=s) * scale).astype(np.float32), dtype)
            for s in shapes]


def _ids(idx):
    return jnp.asarray(idx, jnp.int32), torch.tensor(idx, dtype=torch.int32)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("idx", IDX_MIXES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shrink_expand_match_jax(idx, dtype):
    t, d_in, d_out, s, r = len(idx), 64, 48, 3, 16
    rng = np.random.default_rng(7)
    (ja, ta), (jb, tb), (jx, tx) = _case(
        rng, [(s, d_in, r), (s, r, d_out), (t, d_in)], dtype)
    jid, tid = _ids(idx)
    tol = TOL[dtype]

    h = ops.lora_shrink(tx, ta, tid)
    assert h.dtype == torch.float32 and h.shape == (t, r)
    np.testing.assert_allclose(_np(h), np.asarray(jops.lora_shrink(jx, ja,
                                                                   jid)),
                               rtol=tol, atol=tol)
    y = ops.lora_expand(h, tb, tid)
    assert y.dtype == tb.dtype and y.shape == (t, d_out)
    want = jops.lora_expand(jnp.asarray(_np(h)), jb, jid)
    np.testing.assert_allclose(_np(y), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * r ** 0.5)


def test_base_rows_are_exact_zero():
    """idx < 0 gives exact zeros, not merely small values, in each op on
    its own (expand is fed nonzero h on the base rows too)."""
    rng = np.random.default_rng(1)
    (_, ta), (_, tb), (_, tx), (_, th) = _case(
        rng, [(2, 32, 8), (2, 8, 32), (4, 32), (4, 8)])
    ids = torch.tensor([-1, 0, -1, 1], dtype=torch.int32)
    h = ops.lora_shrink(tx, ta, ids)
    y = ops.lora_expand(th, tb, ids)
    for out in (h, y):
        assert torch.equal(out[[0, 2]], torch.zeros_like(out[[0, 2]]))
        assert (out[[1, 3]] != 0).any()


def test_ragged_ranks_share_one_slab():
    """A rank-8 adapter in a rank-16 slot contributes zero through its
    padding, and a rank-0 slot (all padding) is exactly zero; the port
    agrees with JAX on the padded slab."""
    rng = np.random.default_rng(2)
    a8 = (rng.normal(size=(3, 48, 8)) * 0.5).astype(np.float32)
    b8 = (rng.normal(size=(3, 8, 64)) * 0.5).astype(np.float32)
    a16 = np.pad(a8, ((0, 0), (0, 0), (0, 8)))
    b16 = np.pad(b8, ((0, 0), (0, 8), (0, 0)))
    a16[2] = 0.0
    b16[2] = 0.0
    x = (rng.normal(size=(3, 48)) * 0.5).astype(np.float32)
    jid, tid = _ids([0, 1, 2])
    t = torch.from_numpy
    y16 = ops.lora_expand(ops.lora_shrink(t(x), t(a16), tid), t(b16), tid)
    y8 = ops.lora_expand(ops.lora_shrink(t(x), t(a8), tid), t(b8), tid)
    np.testing.assert_allclose(_np(y16[:2]), _np(y8[:2]), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(y16[2], torch.zeros_like(y16[2]))
    want = jops.lora_expand(jops.lora_shrink(jnp.asarray(x), jnp.asarray(a16),
                                             jid), jnp.asarray(b16), jid)
    np.testing.assert_allclose(_np(y16), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d_in,d_out", [(64, 64),   # q/o-shaped
                                        (64, 16),   # GQA kv-shaped
                                        (16, 64)])  # and its transpose
def test_gqa_projection_shapes(d_in, d_out):
    rng = np.random.default_rng(3)
    (ja, ta), (jb, tb), (jx, tx) = _case(
        rng, [(2, d_in, 8), (2, 8, d_out), (5, d_in)])
    jid, tid = _ids([0, -1, 1, 1, 0])
    y = ops.lora_expand(ops.lora_shrink(tx, ta, tid), tb, tid)
    want = jops.lora_expand(jops.lora_shrink(jx, ja, jid), jb, jid)
    np.testing.assert_allclose(_np(y), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_out", [16, 33, 256])
def test_expand_tile_invariance(block_out):
    """Every output tile, one that does not divide d_out included, gives
    the same result, bitwise on the port's side."""
    rng = np.random.default_rng(4)
    (ja, ta), (jb, tb), (jx, tx) = _case(
        rng, [(2, 32, 8), (2, 8, 80), (4, 32)])
    jid, tid = _ids([0, 1, -1, 0])
    h = ops.lora_shrink(tx, ta, tid)
    y = ops.lora_expand(h, tb, tid, block_out=block_out)
    assert torch.equal(y, ops.lora_expand(h, tb, tid, block_out=80))
    want = jops.lora_expand(jops.lora_shrink(jx, ja, jid), jb, jid,
                            block_out=block_out)
    np.testing.assert_allclose(_np(y), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("proj,seq", [("q", 1), ("down", 5)])
def test_delta_matches_jax(proj, seq):
    """``models.lora.delta`` on one layer's slab (decode rows, and a
    prefill chunk whose ids repeat per token) against the JAX function."""
    rng = np.random.default_rng(5)
    d_in, d_out = (64, 96) if proj == "q" else (96, 64)
    ids = [2, -1, 0] if seq == 1 else [1]
    (ja, ta), (jb, tb), (jx, tx) = _case(
        rng, [(3, d_in, 16), (3, 16, d_out), (len(ids), seq, d_in)])
    jid, tid = _ids(ids)
    got = tlora.delta(proj, tx, {"ids": tid, "block_out": 128,
                                 "slabs": {proj: {"a": ta, "b": tb}}})
    want = jlora.delta(proj, jx, {"ids": jid,
                                  "slabs": {proj: {"a": ja, "b": jb}}})
    assert got.shape == tuple(want.shape) and got.dtype == tx.dtype
    assert_close(got, np.asarray(want), MODULE_TOL, f"delta {proj}")
    assert tlora.delta("v", tx, {"ids": tid, "block_out": 128,
                                 "slabs": {proj: {"a": ta, "b": tb}}}) is None
    assert tlora.add_delta(proj, tx, tx, None) is tx


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Bad dtypes, ranks, shapes and devices are refused before a launch;
    a device the kernels do not serve is never computed on the CPU."""
    x, a = torch.zeros(2, 8), torch.zeros(1, 8, 8)
    h, b = torch.zeros(2, 8), torch.zeros(1, 8, 4)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        lora_shrink_kernel(x, a, ids.long())
    with pytest.raises(TypeError, match="share a dtype"):
        lora_shrink_kernel(x.bfloat16(), a, ids)
    with pytest.raises(ValueError, match="rank"):
        lora_shrink_kernel(x, torch.zeros(1, 8, 12), ids)
    with pytest.raises(ValueError, match="rank"):
        lora_expand_kernel(torch.zeros(2, 72), torch.zeros(1, 72, 4), ids)
    with pytest.raises(ValueError, match="feature dim"):
        lora_shrink_kernel(torch.zeros(2, 4), a, ids)
    with pytest.raises(TypeError, match="float32"):
        lora_expand_kernel(h.bfloat16(), b, ids)
    with pytest.raises(ValueError, match="block_out"):
        lora_expand_kernel(h, b, ids, block_out=0)
    with pytest.raises(ValueError, match="contiguous"):
        lora_shrink_kernel(x, torch.zeros(1, 8, 8).transpose(1, 2), ids)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lora_shrink_kernel(torch.empty(2, 8, **meta),
                           torch.empty(1, 8, 8, **meta),
                           torch.empty(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        lora_expand_kernel(torch.empty(2, 8, **meta),
                           torch.empty(1, 8, 4, **meta),
                           torch.empty(2, dtype=torch.int32, **meta))


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_cpu_is_the_composition_bitwise(dtype, with_base):
    """The fused op's CPU path is ``base + expand(shrink(x)).to(dtype)`` bit
    for bit, base rows included (there it is base + 0)."""
    rng = np.random.default_rng(9)
    (_, ta), (_, tb), (_, tx), (_, tbase) = _case(
        rng, [(3, 40, 16), (3, 16, 24), (6, 40), (6, 24)],
        "bfloat16" if dtype == torch.bfloat16 else "float32")
    ids = torch.tensor([2, -1, 0, 1, -1, 2], dtype=torch.int32)
    base = tbase if with_base else None
    got = ops.lora_delta(tx, ta, tb, ids, block_out=16, base=base)
    want = ops.lora_expand(ops.lora_shrink(tx, ta, ids), tb, ids).to(dtype)
    if with_base:
        want = torch.add(tbase, want)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got[[1, 4]], (tbase[[1, 4]] + 0) if with_base
                       else torch.zeros_like(got[[1, 4]]))


@pytest.mark.parametrize("seq", [3, 16])
def test_per_sequence_ids_equal_the_per_row_api(seq):
    """ids per sequence with rows_per_seq s equal the per-row API (s = 1)
    on each id repeated s times, in all three ops."""
    rng = np.random.default_rng(10)
    (_, ta), (_, tb), (_, tx), (_, tbase) = _case(
        rng, [(3, 32, 8), (3, 8, 40), (4 * seq, 32), (4 * seq, 40)],
        "bfloat16")
    ids = torch.tensor([1, -1, 2, 0], dtype=torch.int32)
    rows = ids.repeat_interleave(seq)
    h = ops.lora_shrink(tx, ta, ids, rows_per_seq=seq)
    assert torch.equal(h, ops.lora_shrink(tx, ta, rows))
    assert torch.equal(ops.lora_expand(h, tb, ids, block_out=16,
                                       rows_per_seq=seq),
                       ops.lora_expand(h, tb, rows, block_out=16))
    assert torch.equal(ops.lora_delta(tx, ta, tb, ids, rows_per_seq=seq,
                                      base=tbase),
                       ops.lora_delta(tx, ta, tb, rows, base=tbase))


def test_tensor_core_rule():
    """The shrink's regime follows the dtype, rows_per_seq and d alone."""
    assert tensor_core_rows(torch.bfloat16, 1024, 256)
    assert tensor_core_rows(torch.bfloat16, 1024, 16)
    assert not tensor_core_rows(torch.bfloat16, 1024, 15)
    assert not tensor_core_rows(torch.bfloat16, 1020, 256)
    assert not tensor_core_rows(torch.float32, 1024, 256)


def _store_slabs(ranks):
    """One layer's slabs of every projection from the JAX adapter store and
    the port's, after the same loads (ragged ranks share a slot rank of
    16): (jax slabs, torch slabs, torch config, slot of each tenant)."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduced_config as jreduced
    from repro.serve import adapters as jadapters
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.serve.adapters import AdapterStore
    cfg = reduced_config(get_config("qwen3-0.6b"))
    stores = (jadapters.AdapterStore(jreduced(jget("qwen3-0.6b")),
                                     max_adapters=3, rank_cap=16),
              AdapterStore(cfg, max_adapters=3, rank_cap=16, device="cpu"))
    slots = [[st.load(f"t{i}", rank=r, alpha=2.0 * r)
              for i, r in enumerate(ranks)] for st in stores]
    assert slots[0] == slots[1]
    (js, ts) = (st.slabs() for st in stores)
    return ({p: {k: v[0] for k, v in sl.items()} for p, sl in js.items()},
            {p: {k: v[0] for k, v in sl.items()} for p, sl in ts.items()},
            cfg, slots[1])


@pytest.mark.parametrize("case", ["decode", "chunk"])
def test_fused_delta_matches_jax_model_glue(case):
    """``models.lora.add_delta`` / ``delta`` (one fused launch) against the
    JAX functions on the slabs both adapter stores build (ranks 4, 8 and 16
    in one rank-16 slab): decode rows with base rows among them, and a
    prefill chunk of s > 1 rows per sequence."""
    jslabs, tslabs, cfg, slots = _store_slabs((4, 8, 16))
    ids = [slots[2], -1, slots[0], slots[1], -1] if case == "decode" \
        else [slots[1], slots[2]]
    seq = 1 if case == "decode" else 7
    rng = np.random.default_rng(11)
    for proj in ("q", "down"):
        d_in = tslabs[proj]["a"].shape[1]
        d_out = tslabs[proj]["b"].shape[2]
        (jx, tx), (jb, tbase) = _case(rng, [(len(ids), seq, d_in),
                                            (len(ids), seq, d_out)])
        jid, tid = _ids(ids)
        tl = {"ids": tid, "block_out": 32, "slabs": tslabs}
        jl = {"ids": jid, "slabs": jslabs}
        got = tlora.add_delta(proj, tbase, tx, tl)
        want = jlora.add_delta(proj, jb, jx, jl)
        assert got.shape == tuple(want.shape) and got.dtype == tx.dtype
        assert_close(got, np.asarray(want), MODULE_TOL, f"add_delta {proj}")
        assert_close(tlora.delta(proj, tx, tl),
                     np.asarray(jlora.delta(proj, jx, jl)), MODULE_TOL,
                     f"delta {proj}")
        base_rows = [i for i, v in enumerate(ids) if v < 0]
        assert torch.equal(got[base_rows], tbase[base_rows] + 0)


def test_model_glue_passes_sequences_not_repeated_rows(monkeypatch):
    """The model calls the fused op once per projection with one id per
    sequence and rows_per_seq = the chunk's length (no per-row repeat)."""
    seen = []

    def spy(x, a, b, ids, rows_per_seq=1, block_out=256, base=None):
        seen.append((tuple(ids.shape), rows_per_seq, block_out,
                     base is not None))
        return torch.zeros((x.shape[0], b.shape[-1]), dtype=x.dtype)
    monkeypatch.setattr(ops, "lora_delta", spy)
    lora = {"ids": torch.tensor([0, -1], dtype=torch.int32), "block_out": 512,
            "slabs": {"q": {"a": torch.zeros(2, 16, 8),
                            "b": torch.zeros(2, 8, 24)}}}
    x = torch.ones(2, 5, 16)
    assert tlora.add_delta("q", torch.ones(2, 5, 24), x, lora).shape \
        == (2, 5, 24)
    assert tlora.delta("q", x, lora).shape == (2, 5, 24)
    assert seen == [((2,), 5, 24, True), ((2,), 5, 24, False)]


def test_delta_refuses_what_the_kernel_does_not_take():
    """Mismatched dtypes, a rows_per_seq that does not divide the rows (or
    disagrees with the ids), a rank off the multiple of 8, a bad base and
    block_out are refused before a launch."""
    x, a, b = torch.zeros(6, 8), torch.zeros(2, 8, 8), torch.zeros(2, 8, 4)
    ids = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError, match="share x's dtype"):
        lora_delta_kernel(x, a, b.bfloat16(), ids)
    with pytest.raises(TypeError, match="share a dtype"):
        lora_delta_kernel(x.bfloat16(), a, b.bfloat16(), ids)
    with pytest.raises(TypeError, match="base"):
        lora_delta_kernel(x, a, b, ids, base=torch.zeros(6, 4).bfloat16())
    with pytest.raises(ValueError, match="base"):
        lora_delta_kernel(x, a, b, ids, base=torch.zeros(6, 5))
    with pytest.raises(ValueError, match="does not divide"):
        lora_delta_kernel(x, a, b, ids[:2], rows_per_seq=4)
    with pytest.raises(ValueError, match="does not divide"):
        lora_shrink_kernel(x, a, ids[:2], rows_per_seq=4)
    with pytest.raises(ValueError, match="ids"):
        lora_delta_kernel(x, a, b, ids, rows_per_seq=3)
    with pytest.raises(ValueError, match="rank"):
        lora_delta_kernel(x, torch.zeros(2, 8, 12), torch.zeros(2, 12, 4),
                          ids)
    with pytest.raises(ValueError, match="disagree"):
        lora_delta_kernel(x, a, torch.zeros(3, 8, 4), ids)
    with pytest.raises(ValueError, match="block_out"):
        lora_delta_kernel(x, a, b, ids, block_out=0)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lora_delta_kernel(torch.empty(2, 8, **meta),
                          torch.empty(1, 8, 8, **meta),
                          torch.empty(1, 8, 4, **meta),
                          torch.empty(2, dtype=torch.int32, **meta))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_kernels_match_plain_versions_on_cuda(cuda, dtype):
    from repro_torch.kernels import lora as lk
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = ref.ROW_TOL[dtype]
    for t, d, o, r in ((8, 1024, 2048, 16), (37, 100, 77, 8),
                       (3, 3072, 1024, 64)):
        a = torch.randn((4, d, r), generator=gen, device=cuda).to(dtype)
        b = torch.randn((4, r, o), generator=gen, device=cuda).to(dtype)
        x = torch.randn((t, d), generator=gen, device=cuda).to(dtype)
        ids = torch.tensor([(i % 5) - 1 for i in range(t)],
                           dtype=torch.int32, device=cuda)
        base = torch.randn((t, o), generator=gen, device=cuda).to(dtype)
        n0 = (lk.shrink_launches, lk.expand_launches, lk.delta_launches)
        h = ops.lora_shrink(x, a, ids)
        ys = [ops.lora_expand(h, b, ids, block_out=bo) for bo in (33, 128)]
        fused = ops.lora_delta(x, a, b, ids, block_out=128, base=base)
        torch.cuda.synchronize()
        assert (lk.shrink_launches, lk.expand_launches,
                lk.delta_launches) == (n0[0] + 1, n0[1] + 2, n0[2] + 1)
        # one launch, the composition's bits
        assert torch.equal(fused, base + ys[0])
        assert ref.row_rel_err(fused, ref.lora_delta_ref(
            x, a, b, ids, base))[1] <= tol
        # h is f32 whatever the inputs: the two differ by reassociation only
        want_h = ref.lora_shrink_ref(x, a, ids)
        assert ref.row_rel_err(h, want_h)[1] <= ref.ROW_TOL[torch.float32]
        want = ref.lora_expand_ref(h, b, ids, dtype)
        assert ref.row_rel_err(ys[0], want)[1] <= tol
        assert torch.equal(ys[0], ys[1])
        base = ids < 0
        assert torch.equal(h[base], torch.zeros_like(h[base]))
        assert torch.equal(ys[0][base], torch.zeros_like(ys[0][base]))
    # 64 rows a sequence: the tensor-core tile in bf16 (rank 24 padded to
    # 32), the CUDA cores in f32; one launch equals K5 then K6 plus the base
    a = torch.randn((4, 1024, 24), generator=gen, device=cuda).to(dtype)
    b = torch.randn((4, 24, 200), generator=gen, device=cuda).to(dtype)
    x = torch.randn((128, 1024), generator=gen, device=cuda).to(dtype)
    base = torch.randn((128, 200), generator=gen, device=cuda).to(dtype)
    ids = torch.tensor([2, -1], dtype=torch.int32, device=cuda)
    h = ops.lora_shrink(x, a, ids, rows_per_seq=64)
    y = ops.lora_expand(h, b, ids, block_out=33, rows_per_seq=64)
    fused = ops.lora_delta(x, a, b, ids, 64, 128, base)
    assert torch.equal(fused, base + y)
    rows = ids.repeat_interleave(64)
    assert ref.row_rel_err(h, ref.lora_shrink_ref(x, a, rows))[1] \
        <= ref.ROW_TOL[torch.float32]
    assert ref.row_rel_err(fused, ref.lora_delta_ref(x, a, b, rows,
                                                     base))[1] <= tol
