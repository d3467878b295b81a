"""K2 (rmsnorm) of the port against the JAX package, and its pair and
backward.

On the CPU the wrappers run their plain versions: the backward's
(``ref.rmsnorm_bwd_ref``) and ``RMSNormFn``'s gradients are held against
``jax.vjp`` of the reference's ``repro.models.layers.rms_norm`` on numpy
inputs from a seed; a pair (a layer's q and k norms in one launch) equals
two single calls bit for bit, values and gradients; ``ops.rmsnorm`` and
``ops.rmsnorm_pair`` call the kernels directly when autograd records
nothing, with the Function's bits; a model call makes 3n + 1 K2 launches.
Tests marked ``gpu`` hold the CUDA kernels against their plain versions on
a card and skip without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LOGITS_TOL, assert_close, bridged_params
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as k2
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

EPS = 1e-6
# f32: relative row error of the gradients against jax.vjp (reassociation
# only); bf16: ``ref.ROW_TOL``, compared in f32
F32_GRAD_TOL = 1e-5


def _inputs(r, d, seed, bf16=False):
    """x, w, g as numpy f32 (bf16-rounded when ``bf16``), from one seed."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(r, d)), 1 + 0.5 * rng.normal(size=(d,)),
            rng.normal(size=(r, d))]
    arrs = [a.astype(np.float32) for a in arrs]
    if bf16:
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax_grads(x, w, g, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda a, b: jlayers.rms_norm(a, b, EPS),
                     jnp.asarray(x, jd), jnp.asarray(w, jd))
    return [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in vjp(jnp.asarray(g, jd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 1000, 1024])
@pytest.mark.parametrize("r", [1, 37])
def test_backward_matches_jax_vjp(r, d, dtype):
    """dx and dw of the plain backward and of ``RMSNormFn`` (through
    ``ops.rmsnorm``) against jax.vjp of the reference's rms_norm, row by
    row; dw is one row."""
    x, w, g = _inputs(r, d, seed=r * d, bf16=dtype == torch.bfloat16)
    want = _jax_grads(x, w, g, dtype)
    tx, tw, tg = (_torch(a, dtype) for a in (x, w, g))
    plain = ref.rmsnorm_bwd_ref(tx, tw, tg, EPS)
    xg, wg = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    out = ops.rmsnorm(xg, wg, EPS)
    assert out.grad_fn is not None and out.dtype == dtype
    fn = torch.autograd.grad(out, (xg, wg), tg)
    tol = F32_GRAD_TOL if dtype == torch.float32 else ref.ROW_TOL[dtype]
    for got in (plain, fn):
        assert got[0].dtype == got[1].dtype == dtype
        assert ref.row_rel_err(got[0].float(), want[0])[1] <= tol
        assert ref.row_rel_err(got[1].float()[None], want[1][None])[1] <= tol
    assert torch.equal(plain[0], fn[0]) and torch.equal(plain[1], fn[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_equals_two_single_calls(dtype):
    """q (B,S,H,hd) and k (B,S,KV,hd) normed as a pair: outputs and every
    gradient bitwise those of two ``ops.rmsnorm`` calls, with and without
    autograd recording."""
    rng = np.random.default_rng(5)
    q, k = (_torch(rng.normal(size=s).astype(np.float32), dtype)
            for s in ((2, 3, 4, 16), (2, 3, 2, 16)))
    wq, wk = (_torch((1 + 0.3 * rng.normal(size=16)).astype(np.float32),
                     dtype) for _ in range(2))
    gq, gk = (_torch(rng.normal(size=t.shape).astype(np.float32), dtype)
              for t in (q, k))
    yq, yk = ops.rmsnorm_pair(q, wq, k, wk, EPS)
    assert torch.equal(yq, ops.rmsnorm(q, wq, EPS))
    assert torch.equal(yk, ops.rmsnorm(k, wk, EPS))
    leaves = [t.clone().requires_grad_() for t in (q, wq, k, wk)]
    pq, pk = ops.rmsnorm_pair(*leaves, EPS)
    assert pq.grad_fn is not None and torch.equal(pq, yq)
    pair = torch.autograd.grad((pq, pk), leaves, (gq, gk))
    single = [t.clone().requires_grad_() for t in (q, wq, k, wk)]
    sq = ops.rmsnorm(single[0], single[1], EPS)
    sk = ops.rmsnorm(single[2], single[3], EPS)
    alone = torch.autograd.grad((sq, sk), single, (gq, gk))
    for a, b in zip(pair, alone):
        assert torch.equal(a, b)
    # the pair's backward wrapper is two of the single one
    dq = k2.rmsnorm_pair_bwd_kernel(q.reshape(-1, 16), wq, gq.reshape(-1, 16),
                                    k.reshape(-1, 16), wk, gk.reshape(-1, 16),
                                    EPS)
    one = k2.rmsnorm_bwd_kernel(q.reshape(-1, 16), wq, gq.reshape(-1, 16),
                                EPS) + \
        k2.rmsnorm_bwd_kernel(k.reshape(-1, 16), wk, gk.reshape(-1, 16), EPS)
    for a, b in zip(dq, one):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pair", [False, True])
def test_ops_call_the_kernel_when_nothing_records(pair, monkeypatch):
    """Under ``no_grad``, or with no input needing grad, ``ops.rmsnorm`` and
    ``ops.rmsnorm_pair`` call the kernel wrapper and never the Function; the
    bits equal the Function's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 5, 32)).astype(np.float32))
    w = torch.from_numpy((1 + 0.2 * rng.normal(size=32)).astype(np.float32))
    fn = k2.RMSNormPairFn if pair else k2.RMSNormFn
    if pair:
        args = (x, w, x[:2] * 3, w * 0.5)
        want = fn.apply(args[0].reshape(-1, 32), args[1],
                        args[2].reshape(-1, 32), args[3], EPS)
        call = ops.rmsnorm_pair
    else:
        args = (x, w)
        want = (fn.apply(x.reshape(-1, 32), w, EPS),)
        call = ops.rmsnorm

    def refuse(*a, **kw):
        raise AssertionError("the Function was called")
    monkeypatch.setattr(fn, "apply", refuse)
    outs = []
    for ctx in (torch.no_grad(), torch.enable_grad()):
        with ctx:
            got = call(*args, EPS)
        outs.append(got if pair else (got,))
    for got in outs:
        for g_, w_ in zip(got, want):
            assert g_.grad_fn is None
            assert torch.equal(g_.reshape(-1, 32), w_)
    with pytest.raises(AssertionError, match="Function was called"):
        call(*(a.clone().requires_grad_() for a in args), EPS)


def test_planted_faults_of_the_backward_fail_the_gate():
    """The faults ``chip_smoke.py`` plants in the backward's gate (dx
    without its mean term; one row block left out of dw) fail the f32 gate
    by far, at a small shape; the clean plain version passes it."""
    x, w, g = (torch.from_numpy(a) for a in _inputs(256, 128, seed=9))
    dx, dw = ref.rmsnorm_bwd_ref(x, w, g, EPS)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    rdx, rdw = torch.autograd.grad(ref.rmsnorm_ref(xr, wr, EPS), (xr, wr), g)
    tol = ref.ROW_TOL[torch.float32]
    assert ref.row_rel_err(dx, rdx)[1] <= tol
    assert ref.row_rel_err(dw[None], rdw[None])[1] <= tol
    no_mean, _ = ref.rmsnorm_bwd_ref(x, w, g, EPS, mean_term=False)
    _, dropped = ref.rmsnorm_bwd_ref(x, w, g, EPS, drop_rows=(96, 128))
    assert ref.row_rel_err(no_mean, rdx)[1] > 100 * tol
    assert ref.row_rel_err(dropped[None], rdw[None])[1] > 100 * tol


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w = torch.zeros(3, 8), torch.ones(8)
    with pytest.raises(ValueError, match="share D"):
        k2.rmsnorm_pair_kernel(x, w, torch.zeros(3, 4), torch.ones(4))
    with pytest.raises(ValueError, match="share D"):
        k2.rmsnorm_pair_kernel(x, w, x.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match="x's shape and dtype"):
        k2.rmsnorm_bwd_kernel(x, w, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        k2.rmsnorm_bwd_kernel(x, w, torch.zeros(8, 3).t())
    with pytest.raises(TypeError):
        k2.rmsnorm_pair_kernel(x.half(), w.half(), x.half(), w.half())
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.rmsnorm_bwd_kernel(torch.empty(3, 8, **meta),
                              torch.empty(8, **meta),
                              torch.empty(3, 8, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm_pair(torch.empty(2, 8, **meta), torch.empty(8, **meta),
                         torch.empty(1, 8, **meta), torch.empty(8, **meta))
    with pytest.raises(RuntimeError, match="requires grad"):
        k2.rmsnorm_pair_kernel(x.requires_grad_(), w, x, w)


def test_model_call_makes_3n_plus_1_norm_launches(monkeypatch):
    """A reduced qwen3 prefill with no grad: K2 once a layer for each of
    ln1 and ln2, the q/k pair once a layer, the final norm once (3n + 1),
    and its logits still those of the JAX package."""
    jcfg, tcfg, jparams, tparams = bridged_params("qwen3-0.6b")
    calls = {"single": 0, "pair": 0}

    def counting(name, key):
        fn = getattr(k2, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(k2, name, wrapped)
    counting("rmsnorm_kernel", "single")
    counting("rmsnorm_pair_kernel", "pair")
    tokens = [3, 17, 5, 9, 11, 2, 40]
    with torch.no_grad():
        _, tl = ttf.lm_prefill(tcfg, tparams, {"tokens": torch.tensor([tokens])})
    n = tcfg.n_layers
    assert calls == {"single": 2 * n + 1, "pair": n}, calls
    _, jl = jtf.lm_prefill(jcfg, jparams,
                           {"tokens": jnp.asarray([tokens], jnp.int32)})
    assert_close(tl, jl, LOGITS_TOL, "prefill logits")


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# widths: ragged (1, 37, 1000, 1001), qwen's (128, 1024), the block-a-row
# widths (2560, 5120), and one past the registers (8200, read twice)
CUDA_WIDTHS = (1, 37, 128, 1000, 1001, 1024, 2560, 5120, 8200)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_matches_plain_version_on_cuda(cuda, dtype):
    """The forward and the pair against the plain version row by row at
    ragged widths and R = 0, 1, 37; a row alone bitwise its row in the
    batch; two launches bitwise equal; the pair bitwise two single
    launches."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = ref.ROW_TOL[dtype]
    for d in CUDA_WIDTHS:
        w = (1 + 0.3 * torch.randn(d, generator=gen, device=cuda)).to(dtype)
        for r in (0, 1, 37):
            x = torch.randn((r, d), generator=gen, device=cuda).to(dtype)
            n0 = k2.launches
            got = k2.rmsnorm_kernel(x, w, EPS)
            assert k2.launches == n0 + (r > 0)
            assert got.shape == x.shape and got.dtype == dtype
            if r == 0:
                continue
            assert ref.row_rel_err(got, ref.rmsnorm_ref(x, w, EPS))[1] <= tol
            assert torch.equal(got, k2.rmsnorm_kernel(x, w, EPS))
            for i in (0, r - 1):
                assert torch.equal(k2.rmsnorm_kernel(x[i:i + 1], w, EPS),
                                   got[i:i + 1])
        x1 = torch.randn((37, d), generator=gen, device=cuda).to(dtype)
        x2 = torch.randn((5, d), generator=gen, device=cuda).to(dtype)
        w2 = torch.randn(d, generator=gen, device=cuda).to(dtype)
        y1, y2 = k2.rmsnorm_pair_kernel(x1, w, x2, w2, EPS)
        assert torch.equal(y1, k2.rmsnorm_kernel(x1, w, EPS))
        assert torch.equal(y2, k2.rmsnorm_kernel(x2, w2, EPS))
        e1, e2 = k2.rmsnorm_pair_kernel(x1, w, x2[:0], w2, EPS)
        assert torch.equal(e1, y1) and e2.shape == (0, d)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_version_on_cuda(cuda, dtype):
    """dx and dw against the plain backward row by row at ragged widths and
    R = 0, 1, 37, 300; two launches bitwise equal; a row's dx alone bitwise
    its row in the batch; the pair bitwise two single calls; dw over the
    first three quarters of the rows differs from dw over all of them; dw
    of no rows is zero."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    tol = ref.ROW_TOL[dtype]
    # not D = 1: there dx = rstd g w (1 - x_hat^2) is a difference of two
    # values near 1 that rounds to noise on both sides
    for d in CUDA_WIDTHS[1:]:
        w = (1 + 0.3 * torch.randn(d, generator=gen, device=cuda)).to(dtype)
        for r in (0, 1, 37, 300):
            x, g = (torch.randn((r, d), generator=gen, device=cuda).to(dtype)
                    for _ in range(2))
            n0 = k2.bwd_launches
            dx, dw = k2.rmsnorm_bwd_kernel(x, w, g, EPS)
            assert k2.bwd_launches == n0 + 1
            assert dx.dtype == dtype and dw.dtype == dtype
            if r == 0:
                assert dx.shape == (0, d) and not dw.float().abs().any()
                continue
            rdx, rdw = ref.rmsnorm_bwd_ref(x, w, g, EPS)
            assert ref.row_rel_err(dx, rdx)[1] <= tol
            assert ref.row_rel_err(dw[None], rdw[None])[1] <= tol
            again = k2.rmsnorm_bwd_kernel(x, w, g, EPS)
            assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
            alone, _ = k2.rmsnorm_bwd_kernel(x[-1:], w, g[-1:], EPS)
            assert torch.equal(alone, dx[-1:])
            if r >= 4:
                part = k2.rmsnorm_bwd_kernel(x[:3 * r // 4], w,
                                             g[:3 * r // 4], EPS)[1]
                assert not torch.equal(part, dw)
        x2, g2 = (torch.randn((7, d), generator=gen, device=cuda).to(dtype)
                  for _ in range(2))
        pair = k2.rmsnorm_pair_bwd_kernel(x, w, g, x2, w, g2, EPS)
        one = k2.rmsnorm_bwd_kernel(x, w, g, EPS) \
            + k2.rmsnorm_bwd_kernel(x2, w, g2, EPS)
        for a, b in zip(pair, one):
            assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_narrow_mode_kernels_match_plain_versions_on_cuda(cuda):
    """REPRO_NORM_F32=0's mode (``f32=False``, bf16): the forward, the pair
    and the backward against the narrow plain versions row by row at the
    ragged widths; the pair bitwise two single launches; a bf16 x gives
    other bits than the f32 mode, an f32 x the same."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    tol = ref.ROW_TOL[torch.bfloat16]
    for d in CUDA_WIDTHS[1:]:
        w = (1 + 0.3 * torch.randn(d, generator=gen, device=cuda)).to(
            torch.bfloat16)
        x, g = (torch.randn((37, d), generator=gen, device=cuda).to(
            torch.bfloat16) for _ in range(2))
        y = k2.rmsnorm_kernel(x, w, EPS, f32=False)
        assert ref.row_rel_err(y, ref.rmsnorm_ref(x, w, EPS, False))[1] <= tol
        y1, y2 = k2.rmsnorm_pair_kernel(x, w, x[:5], w.flip(0), EPS,
                                        f32=False)
        assert torch.equal(y1, y) and torch.equal(
            y2, k2.rmsnorm_kernel(x[:5], w.flip(0), EPS, f32=False))
        dx, dw = k2.rmsnorm_bwd_kernel(x, w, g, EPS, f32=False)
        rdx, rdw = ref.rmsnorm_bwd_ref(x, w, g, EPS, f32=False)
        assert ref.row_rel_err(dx, rdx)[1] <= tol
        assert ref.row_rel_err(dw[None], rdw[None])[1] <= tol
        if d >= 128:
            assert not torch.equal(y, k2.rmsnorm_kernel(x, w, EPS))
        xf, wf = x.float(), w.float()
        assert torch.equal(k2.rmsnorm_kernel(xf, wf, EPS, f32=False),
                           k2.rmsnorm_kernel(xf, wf, EPS))
    torch.cuda.synchronize()
