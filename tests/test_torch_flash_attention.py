"""The port's flash attention (K3, forward and backward) against the JAX
package, and the kernel wrappers' refusal to cut the autograd graph.

On the CPU the port's wrappers run their plain versions (a CUDA tensor
would launch ``csrc/flash_attention.cu``).  The forward is held against the
Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention``, on
the shapes of ``tests/test_kernels.py``), and, where the Pallas kernel's
block sizes would not divide the sequence, against the reference's
``multi_head_attention``.  The Pallas kernel has no backward, so the
backward is held against ``jax.grad`` of ``multi_head_attention`` (what the
JAX trainer differentiates) and against torch autograd of the port's plain
attention.  Grouped-query attention is read by the kernels (k/v at the KV
heads, groups of up to 8 here): the grouped call equals the call on K/V
repeated to every query head, with dK/dV summed over each group.  The test
marked ``gpu`` holds the CUDA kernels against the plain versions on a card
and skips without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.attention import multi_head_attention as jax_mha
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import lora as k56
from repro_torch.kernels import matmul as k4
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as k1
from repro_torch.kernels import rmsnorm as k2
from repro_torch.kernels import ssm_scan as k7
from repro_torch.models.attention import multi_head_attention

torch.set_num_threads(1)

# f32, relative to the reference's largest value (f32 reassociation)
TOL = 2e-5
BF16_TOL = 5e-2


def _qkv(b, sq, skv, h, kv, hd, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, sq, h, hd)) * scale).astype(np.float32)
    k = (rng.normal(size=(b, skv, kv, hd)) * scale).astype(np.float32)
    v = (rng.normal(size=(b, skv, kv, hd)) * scale).astype(np.float32)
    return q, k, v


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max|diff| {err:.3g} > {bound:.3g}"


# -- forward -----------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1), (16, 2)])
def test_forward_matches_pallas_interpret(causal, h, kv):
    q, k, v = _qkv(2, 128, 128, h, kv, 64)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_kv=64)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    _close(got, want, TOL, "flash forward")


def test_forward_bf16_matches_pallas_interpret():
    q, k, v = _qkv(1, 128, 128, 2, 2, 64)
    want = jops.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)),
                                block_q=64, block_kv=64)
    got = ops.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL, "flash bf16")


def test_forward_q_offset_matches_pallas_interpret():
    """A q suffix of 64 against a kv prefix of 256 (a decode chunk)."""
    q, k, v = _qkv(1, 64, 256, 2, 2, 64)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_offset=192,
                                block_q=64, block_kv=64)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, q_offset=192)
    _close(got, want, TOL, "flash q_offset")


@pytest.mark.parametrize("sq,skv,causal,off", [(37, 37, True, 0),
                                                (20, 33, False, 0),
                                                (23, 41, True, 18)])
def test_forward_ragged_matches_reference_attention(sq, skv, causal, off):
    """Lengths no block size divides (the Pallas kernel asserts on them)."""
    q, k, v = _qkv(2, sq, skv, 4, 2, 16, seed=1)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, q_offset=off)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, q_offset=off)
    _close(got, want, TOL, "flash ragged")
    # and the port's own impl switch reaches the same function
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(multi_head_attention(tq, tk, tv, causal=causal, q_offset=off,
                                impl="kernel"),
           multi_head_attention(tq, tk, tv, causal=causal, q_offset=off),
           TOL, "impl kernel vs reference")


def test_lse_is_the_row_logsumexp():
    q, k, v = _qkv(1, 19, 19, 2, 2, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).reshape(2, 19, 16)
                  .contiguous() for x in (q, k, v))
    _, lse = k3.flash_attention_kernel(tq, tk, tv, True, 0)
    s = (tq @ tk.transpose(1, 2)) / 4.0
    s = s.masked_fill(~torch.ones(19, 19, dtype=torch.bool).tril(), -1e30)
    assert lse.dtype == torch.float32 and lse.shape == (2, 19)
    _close(lse, torch.logsumexp(s, -1).numpy(), TOL, "lse")


# -- backward ----------------------------------------------------------------

BWD_CASES = [(2, 32, 32, 4, 2, True, 0), (2, 24, 24, 4, 4, False, 0),
             (1, 29, 45, 4, 1, True, 16), (2, 17, 17, 2, 2, True, 0),
             (2, 33, 33, 16, 2, True, 0)]


def _jax_grads(q, k, v, do, causal, off):
    def f(q, k, v):
        o = jax_mha(q, k, v, causal=causal, q_offset=off)
        return jnp.sum(o * jnp.asarray(do))
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("b,sq,skv,h,kv,causal,off", BWD_CASES)
def test_backward_matches_jax_grad(b, sq, skv, h, kv, causal, off):
    """dQ, dK, dV through FlashAttentionFn (GQA read by the kernels, which
    sum dK/dV over each group) against jax.grad of the reference."""
    q, k, v = _qkv(b, sq, skv, h, kv, 16, seed=3)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    want = _jax_grads(q, k, v, do, causal, off)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, TOL, name)


@pytest.mark.parametrize("b,sq,skv,h,kv,causal,off", BWD_CASES)
def test_backward_matches_torch_autograd_of_plain_attention(
        b, sq, skv, h, kv, causal, off):
    q, k, v = _qkv(b, sq, skv, h, kv, 16, seed=5)
    do = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape)
                          .astype(np.float32))
    grads = []
    for impl in ("kernel", "reference"):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o = multi_head_attention(*ts, causal=causal, q_offset=off, impl=impl)
        grads.append(torch.autograd.grad(o, ts, do))
    for name, g, w in zip(("dq", "dk", "dv"), *grads):
        _close(g, w.numpy(), TOL, name)


@pytest.mark.parametrize("b,sq,skv,h,kv,causal,off", BWD_CASES)
def test_plain_versions_accumulate_in_f64_for_f64_inputs(
        b, sq, skv, h, kv, causal, off):
    """Given f64 tensors, the plain forward and backward stay in f64 (the
    witness both f32 sides are held against on the card), and the backward
    equals f64 autograd of a softmax attention written out here."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b * h, n, 16)) * 0.3)
                   for n in (sq, skv, skv, sq))
    o, lse = ref.flash_attention_ref(q, k, v, causal, off)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    assert o.dtype == lse.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in got)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    s = ts[0] @ ts[1].transpose(1, 2) / 4.0
    if causal:
        live = off + torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        s = s.masked_fill(~live, float("-inf"))
    want = torch.autograd.grad(torch.softmax(s, -1) @ ts[2], ts, do)
    torch.testing.assert_close(o, (torch.softmax(s, -1) @ ts[2]).detach(),
                               rtol=0, atol=1e-12)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


def test_plain_backward_matches_jax_grad_directly():
    """``ref.flash_attention_bwd_ref`` on the kernel's own (BH,S,hd) layout,
    P recomputed from the forward's lse."""
    q, k, v = _qkv(1, 21, 21, 3, 3, 16, seed=7)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    want = _jax_grads(q, k, v, do, True, 0)
    bh = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(  # noqa: E731
        3, -1, 16).contiguous()
    tq, tk, tv, tdo = bh(q), bh(k), bh(v), bh(do)
    o, lse = ref.flash_attention_ref(tq, tk, tv, True, 0)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, True, 0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.reshape(1, 3, -1, 16).transpose(1, 2)
        _close(g, w, TOL, name)


def _heads(x):
    """(B,S,heads,hd) numpy -> the kernels' (B*heads,S,hd) tensor."""
    b, n, h, hd = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, n, hd) \
        .contiguous()


@pytest.mark.parametrize("causal,off", [(True, 0), (False, 0), (True, 7)])
@pytest.mark.parametrize("group", [2, 8])
def test_grouped_call_equals_the_call_on_repeated_kv(group, causal, off):
    """The wrappers on (BKV,Skv,hd) k/v give the output, lse and dq of the
    same call on k/v repeated to every query head, and dk/dv equal to that
    call's summed over each group (through FlashAttentionFn too)."""
    q, k, v = _qkv(2, 19, 19 + off, 2 * group, 2, 16, seed=12)
    do = _heads(np.random.default_rng(13).normal(size=q.shape)
                .astype(np.float32))
    tq, tk, tv = _heads(q), _heads(k), _heads(v)
    rk, rv = (t.repeat_interleave(group, dim=0) for t in (tk, tv))
    o, lse = k3.flash_attention_kernel(tq, tk, tv, causal, off)
    ro, rlse = k3.flash_attention_kernel(tq, rk, rv, causal, off)
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=0)
    got = k3.flash_attention_bwd_kernel(tq, tk, tv, o, lse, do, causal, off)
    want = k3.flash_attention_bwd_kernel(tq, rk, rv, ro, rlse, do, causal,
                                         off)
    assert got[1].shape == tk.shape and got[2].shape == tv.shape
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w.unflatten(0, (4, group)).sum(1),
                                   rtol=0, atol=1e-6)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn = torch.autograd.grad(k3.FlashAttentionFn.apply(*ts, causal, off), ts,
                             do)
    for g, w in zip(fn, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("bh,bkv", [(6, 4), (4, 8), (6, 0)])
def test_wrappers_refuse_kv_heads_that_do_not_divide(bh, bkv):
    q = torch.zeros(bh, 5, 8)
    kv = torch.zeros(bkv, 5, 8)
    with pytest.raises(ValueError, match="BKV dividing BH"):
        k3.flash_attention_kernel(q, kv, kv)
    with pytest.raises(ValueError, match="BKV dividing BH"):
        k3.flash_attention_bwd_kernel(q, kv, kv, q, torch.zeros(bh, 5), q)


def test_function_path_is_taken_only_when_grad_is_needed():
    """``ops.flash_attention`` always calls ``FlashAttentionFn``, which
    records a graph only when grad mode is on and an input requires it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 2, 16))
    assert ops.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    assert ops.flash_attention(qg, k, v).grad_fn is not None
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v).grad_fn is None
    with torch.inference_mode():
        assert ops.flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("shape", [(6, 32), (2, 3, 16)])
def test_rmsnorm_goes_through_its_function(shape):
    """``ops.rmsnorm`` always calls ``RMSNormFn``: no graph without a
    grad-requiring input, and with one, dx and dw equal to ``jax.grad`` of
    the reference's ``rms_norm``."""
    from repro.models.layers import rms_norm as jax_rms_norm
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1 + 0.5 * rng.normal(size=shape[-1:])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert ops.rmsnorm(tx, tw, 1e-6).grad_fn is None
    xg, wg = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    out = ops.rmsnorm(xg, wg, 1e-6)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (xg, wg), torch.from_numpy(g))
    want = jax.grad(lambda a, b: jnp.sum(jax_rms_norm(a, b, 1e-6) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for name, a, b in zip(("dx", "dw"), got, want):
        _close(a, b, TOL, name)


# -- wrappers refuse to cut the graph ------------------------------------------

def _f(*shape):
    return torch.randn(*shape)


WRAPPER_CALLS = {
    "rmsnorm": lambda g: k2.rmsnorm_kernel(_f(4, 8).requires_grad_(g),
                                           _f(8)),
    "paged_attention": lambda g: k1.paged_attention_kernel(
        _f(1, 1, 2, 8).requires_grad_(g), _f(3, 4, 1, 8), _f(3, 4, 1, 8),
        torch.ones((1, 2), dtype=torch.int32),
        torch.full((1, 2), 3, dtype=torch.int32),
        torch.full((1,), 4, dtype=torch.int32)),
    "matmul": lambda g: k4.matmul_kernel(_f(3, 4), _f(4, 5).requires_grad_(g)),
    "lora_shrink": lambda g: k56.lora_shrink_kernel(
        _f(2, 8).requires_grad_(g), _f(2, 8, 8),
        torch.tensor([0, -1], dtype=torch.int32)),
    "lora_expand": lambda g: k56.lora_expand_kernel(
        _f(2, 8), _f(2, 8, 8).requires_grad_(g),
        torch.tensor([1, 0], dtype=torch.int32)),
    "ssm_scan": lambda g: k7.ssm_scan_kernel(
        _f(1, 3, 4, 2).requires_grad_(g), _f(1, 3, 4, 2), _f(1, 3, 2),
        _f(1, 4, 2)),
    "flash_attention": lambda g: k3.flash_attention_kernel(
        _f(2, 5, 8), _f(2, 5, 8).requires_grad_(g), _f(2, 5, 8)),
    "flash_attention_bwd": lambda g: k3.flash_attention_bwd_kernel(
        _f(2, 5, 8), _f(2, 5, 8), _f(2, 5, 8), _f(2, 5, 8),
        _f(2, 5), _f(2, 5, 8).requires_grad_(g)),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CALLS))
def test_wrappers_refuse_grad_inputs(name):
    """A kernel's output has no grad_fn, so every wrapper raises when
    autograd would record through it; it runs under no_grad and on inputs
    that need no gradient.  The check comes before the device branch, so
    the CPU shows it."""
    call = WRAPPER_CALLS[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call(True)
    call(False)
    with torch.no_grad():
        call(True)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 5, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3.flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        k3.flash_attention_kernel(torch.zeros(2, 5, 12), torch.zeros(2, 5, 12),
                                  torch.zeros(2, 5, 12))
    with pytest.raises(ValueError, match=r"q \(BH,Sq,hd\)"):
        k3.flash_attention_kernel(q, torch.zeros(3, 5, 8), torch.zeros(3, 5, 8))
    with pytest.raises(ValueError, match="contiguous"):
        k3.flash_attention_kernel(torch.zeros(2, 8, 5).transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="q_offset"):
        k3.flash_attention_kernel(q, q, q, True, -1)
    with pytest.raises(ValueError, match="at least one key"):
        k3.flash_attention_kernel(q, torch.zeros(2, 0, 8),
                                  torch.zeros(2, 0, 8))
    with pytest.raises(ValueError, match="lse"):
        k3.flash_attention_bwd_kernel(q, q, q, q, torch.zeros(2, 5,
                                      dtype=torch.float64), q)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_kernels_match_plain_versions_on_cuda(cuda):
    """K3's forward (o, lse) and backward (dq, dk, dv) against the plain
    versions, f32 and bf16, causal with and without q_offset, non-causal,
    ragged, at head_dim 40, 80, 128 and 256, and with KV heads grouped by
    2 and 8; two backward launches are bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for bh, bkv, sq, skv, hd, causal, off in (
                (4, 4, 300, 300, 128, True, 0),
                (4, 4, 128, 640, 128, True, 512),
                (3, 3, 70, 90, 256, False, 0),
                (2, 2, 65, 65, 40, True, 3),
                (8, 4, 97, 97, 80, True, 0),
                (16, 2, 128, 128, 128, True, 0)):
            q, do = (torch.randn((bh, sq, hd), generator=gen,
                                 device=cuda).to(dtype) for _ in range(2))
            k, v = (torch.randn((bkv, skv, hd), generator=gen,
                                device=cuda).to(dtype) for _ in range(2))
            n0, b0 = k3.launches, k3.bwd_launches
            o, lse = k3.flash_attention_kernel(q, k, v, causal, off)
            grads = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                  causal, off)
            torch.cuda.synchronize()
            assert (k3.launches, k3.bwd_launches) == (n0 + 1, b0 + 1)
            ro, rlse = ref.flash_attention_ref(q, k, v, causal, off)
            tol = ref.ROW_TOL[dtype]
            assert ref.row_rel_err(o, ro)[1] <= tol
            assert float((lse - rlse).abs().max()) <= 1e-4
            for g, w in zip(grads, ref.flash_attention_bwd_ref(
                    q, k, v, o, lse, do, causal, off)):
                assert ref.row_rel_err(g, w, floor=ref.GRAD_ROW_FLOOR)[1] \
                    <= ref.GRAD_ROW_TOL[dtype]
            again = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                  causal, off)
            assert all(torch.equal(a, b) for a, b in zip(grads, again))
