"""The port's selective scan (K7) and its gradient against the JAX package.

On the CPU the port's wrapper runs its plain sequential version (a CUDA
tensor would launch ``csrc/ssm_scan.cu``); JAX runs its Pallas kernel in
interpret mode (``repro.kernels.ops``) and its sequential oracle
(``repro.kernels.ref``), on the shapes of ``tests/test_kernels.py``.  The
chunked entry is one scan over all T; it equals, bit for bit, the plain
chunked oracle that carries the state from one chunk into the next and
pads a ragged tail with the identity step, and so does a prefill split
into engine chunks, each resuming from the last one's state.  The plain
backward (``ref.ssm_scan_bwd_ref``) is held against ``jax.vjp`` of the
reference's ``_chunked_selective_scan``, the function its loss
differentiates, and ``SSMScanFn`` against autograd through the plain scan.
The fused entries (Mamba1's discretisation a = exp(dt A), b = (dt B) x
inside the kernel, what every Mamba1 layer calls): the plain forward is
``_discretise`` then the plain scan bit for bit and matches the JAX
package's discretisation then its Pallas kernel; the plain backward
(``ref.ssm_scan_fused_bwd_ref``) matches autograd of that composition and
``jax.vjp`` of the reference's discretisation and chunked scan, and
``SSMScanFusedFn`` matches autograd.  The tests marked ``gpu`` hold the
CUDA kernels against the plain versions on a card and skip without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as k7
from repro_torch.models import mamba as tmb
from _torch_parity import MODULE_TOL

torch.set_num_threads(1)

# f32, relative to the reference's largest value: the JAX side walks the
# same sequential recurrence (kernel and oracle); y sums N products in
# another order
TOL = 1e-5


def _inputs(b, t, d, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.6, 0.99, size=(b, t, d, n)).astype(np.float32)
    bb = (rng.normal(size=(b, t, d, n)) * 0.1).astype(np.float32)
    c = rng.normal(size=(b, t, n)).astype(np.float32)
    h0 = (rng.normal(size=(b, d, n)) * 0.1).astype(np.float32)
    return a, bb, c, h0


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("t,d,n", [(16, 32, 8), (64, 128, 16), (32, 64, 4),
                                   (1, 64, 16)])
def test_scan_matches_jax_kernel_and_oracle(t, d, n):
    a, bb, c, h0 = _inputs(2, t, d, n)
    y, hl = ops.ssm_scan(*_t(a, bb, c, h0))
    jy, jh = jops.ssm_scan(*map(jnp.asarray, (a, bb, c, h0)),
                           block_d=min(32, d))
    ry, rh = jax.vmap(jref.ssm_scan_ref)(*map(jnp.asarray, (a, bb, c, h0)))
    for got, want in ((y, jy), (hl, jh), (y, ry), (hl, rh)):
        _close(got, want)


@pytest.mark.parametrize("t,chunk", [(32, 8), (24, 8), (19, 8), (16, 16),
                                     (7, 8), (300, 256)])
def test_chunked_matches_jax_and_is_bitwise_one_scan(t, chunk):
    """The chunked entry matches the JAX chunked kernel (one launch a
    chunk, state carried, identity-padded tail), equals the port's chunked
    oracle (the same carry spelled out) bit for bit, and so equals the
    port's unchunked scan bit for bit."""
    d, n = (16, 4) if t < 256 else (64, 16)
    a, bb, c, h0 = _inputs(2, t, d, n, seed=t)
    ta, tb, tc, th = _t(a, bb, c, h0)
    y, hl = ops.ssm_scan_chunked(ta, tb, tc, th, chunk=chunk)
    jy, jh = jops.ssm_scan_chunked(*map(jnp.asarray, (a, bb, c, h0)),
                                   chunk=chunk, block_d=16)
    _close(y, jy)
    _close(hl, jh)
    ry, rh = ref.ssm_scan_chunked_ref(ta, tb, tc, th, chunk)
    assert torch.equal(y, ry) and torch.equal(hl, rh)
    fy, fh = ops.ssm_scan(ta, tb, tc, th)
    assert torch.equal(hl, fh), "chunked h_last differs from one scan"
    assert torch.equal(y, fy), "chunked y differs from one scan"


def test_state_carries_across_two_calls():
    """Two calls, the second resuming from the first's h_last, equal one
    call over the whole sequence."""
    a, bb, c, h0 = _t(*_inputs(1, 32, 16, 4))
    h0 = torch.zeros_like(h0)
    y_full, h_full = ops.ssm_scan(a, bb, c, h0)
    y1, h1 = ops.ssm_scan(a[:, :16], bb[:, :16], c[:, :16], h0)
    y2, h2 = ops.ssm_scan(a[:, 16:], bb[:, 16:], c[:, 16:], h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y_full)
    assert torch.equal(h2, h_full)


@pytest.mark.parametrize("chunk", [8, 13, 32])
def test_engine_chunked_prefill_is_chunk_invariant(chunk):
    """A prefill split the way the engine splits it: one ``ssm_scan_chunked``
    call per dispatch of ``chunk`` positions, each resuming from the last
    call's h_last, the ragged last dispatch padded to ``chunk`` positions
    with masked steps (a = 1, b = 0, as ``mamba1_chunk`` makes them) --
    equals one call over the whole prompt bit for bit."""
    t = 30
    a, bb, c, h0 = _t(*_inputs(1, t, 16, 8, seed=3))
    y_full, h_full = ops.ssm_scan_chunked(a, bb, c, h0, chunk=t)
    ys, h = [], h0
    for s in range(0, t, chunk):
        at, bt, ct = a[:, s:s + chunk], bb[:, s:s + chunk], c[:, s:s + chunk]
        pad = chunk - at.shape[1]
        at = torch.cat([at, torch.ones((1, pad, 16, 8))], dim=1)
        bt = torch.cat([bt, torch.zeros((1, pad, 16, 8))], dim=1)
        ct = torch.cat([ct, torch.ones((1, pad, 8))], dim=1)
        y, h = ops.ssm_scan_chunked(at, bt, ct, h, chunk=chunk)
        ys.append(y[:, :chunk - pad])
    assert torch.equal(torch.cat(ys, dim=1), y_full)
    assert torch.equal(h, h_full)


def test_identity_steps_leave_the_state_unchanged():
    """A masked prompt position reaches the scan as a = exp(0 * A) = 1 and
    b = 0 exactly, and leaves the state bitwise as it was."""
    a, bb, c, h0 = _t(*_inputs(1, 6, 16, 8))
    dt = torch.zeros((1, 3, 16))
    a_log = torch.log(torch.arange(1, 9, dtype=torch.float32)).expand(16, 8)
    ident = torch.exp(dt[..., None] * -torch.exp(a_log))
    assert torch.equal(ident, torch.ones_like(ident))
    pad_a = torch.cat([a, ident], dim=1)
    pad_b = torch.cat([bb, dt[..., None] * bb[:, :3]], dim=1)
    pad_c = torch.cat([c, c[:, :3]], dim=1)
    _, h = ops.ssm_scan(a, bb, c, h0)
    _, hp = ops.ssm_scan(pad_a, pad_b, pad_c, h0)
    assert torch.equal(h, hp)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a, bb, c, h0 = _t(*_inputs(1, 4, 8, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        k7.ssm_scan_kernel(*(x.to("meta") for x in (a, bb, c, h0)))
    with pytest.raises(TypeError):
        k7.ssm_scan_kernel(a.double(), bb, c, h0)
    with pytest.raises(ValueError, match="power of two"):
        k7.ssm_scan_kernel(*_t(*_inputs(1, 4, 8, 6)))
    with pytest.raises(ValueError, match="power of two"):
        k7.ssm_scan_kernel(*_t(*_inputs(1, 4, 8, 64)))
    with pytest.raises(ValueError):
        k7.ssm_scan_kernel(a, bb, c[:, :2], h0)
    strided = torch.cat([a, a], dim=-1)[..., ::2]      # a's shape, stride 2
    with pytest.raises(ValueError, match="contiguous"):
        k7.ssm_scan_kernel(strided, strided, c, h0)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssm_scan_chunked(a, bb, c, h0, chunk=0)


# -- the gradient ------------------------------------------------------------

def _grads(b, t, d, n, seed, with_dh):
    rng = np.random.default_rng(seed + 100)
    dy = rng.normal(size=(b, t, d)).astype(np.float32)
    dh = rng.normal(size=(b, d, n)).astype(np.float32) if with_dh else None
    return dy, dh


@pytest.mark.parametrize("t,chunk,with_dh", [(1, 8, True), (19, 8, True),
                                             (32, 8, True), (24, 8, False),
                                             (40, 16, True)])
def test_bwd_ref_matches_jax_vjp(t, chunk, with_dh):
    """The plain backward against ``jax.vjp`` of the reference's chunked
    selective scan (associative scans inside ``chunk``-step chunks, a
    ragged tail padded): da, db, dc and dh0 for cotangents dy and dh_last
    (zero when absent), nonzero h0, within MODULE_TOL of the reference's
    largest value."""
    b, d, n = 2, 16, 8
    a, bb, c, h0 = _inputs(b, t, d, n, seed=t)
    dy, dh = _grads(b, t, d, n, t, with_dh)
    jargs = tuple(map(jnp.asarray, (a, bb, c, h0)))
    (jy, jh), vjp = jax.vjp(
        lambda *xs: jmamba._chunked_selective_scan(*xs, chunk), *jargs)
    want = vjp((jnp.asarray(dy), jnp.zeros_like(jh) if dh is None
                else jnp.asarray(dh)))
    got = ref.ssm_scan_bwd_ref(*_t(a, bb, c, h0, dy),
                               None if dh is None else torch.from_numpy(dh))
    for name, g, w in zip(("da", "db", "dc", "dh0"), got, want):
        _close(g, w, MODULE_TOL)


def test_ckpt_scan_is_the_scan_with_its_window_states():
    """The checkpointing forward gives the scan's bits and the states
    before steps 0, WINDOW, 2 WINDOW, ... (ckpt[:, 0] = h0); T = 0 has no
    window."""
    t = 2 * k7.WINDOW + 3
    a, bb, c, h0 = _t(*_inputs(2, t, 8, 4, seed=5))
    y, hl, ckpt = k7.ssm_scan_ckpt_kernel(a, bb, c, h0)
    fy, fh = k7.ssm_scan_kernel(a, bb, c, h0)
    assert torch.equal(y, fy) and torch.equal(hl, fh)
    assert ckpt.shape == (2, k7.windows(t), 8, 4) == (2, 3, 8, 4)
    for w in range(3):
        _, hw = ref.ssm_scan_ref(a[:, :w * k7.WINDOW], bb[:, :w * k7.WINDOW],
                                 c[:, :w * k7.WINDOW], h0)
        assert torch.equal(ckpt[:, w], hw)
    _, h_empty, none = k7.ssm_scan_ckpt_kernel(a[:, :0], bb[:, :0],
                                               c[:, :0], h0)
    assert torch.equal(h_empty, h0) and none.shape == (2, 0, 8, 4)
    da, db, dc, dh0 = k7.ssm_scan_bwd_kernel(
        a[:, :0], bb[:, :0], c[:, :0], none, torch.zeros((2, 0, 8)), h0)
    assert da.shape == (2, 0, 8, 4) and dc.shape == (2, 0, 4)
    assert torch.equal(dh0, h0)


@pytest.mark.parametrize("with_dh", [True, False])
def test_ssm_scan_fn_equals_autograd_of_the_plain_scan(with_dh):
    """``ops.ssm_scan`` on tensors that need a gradient goes through
    ``SSMScanFn`` and gives autograd's gradients of the plain sequential
    scan; a loss that reads y alone hands its backward no dh_last."""
    t = 2 * k7.WINDOW + 5
    xs = _t(*_inputs(2, t, 8, 4, seed=7))
    dy, dh = _t(*_grads(2, t, 8, 4, 7, True))
    got_in = [x.clone().requires_grad_() for x in xs]
    want_in = [x.clone().requires_grad_() for x in xs]
    y, hl = ops.ssm_scan_chunked(*got_in, chunk=8)
    assert y.grad_fn is not None and "SSMScanFn" in type(y.grad_fn).__name__
    ry, rh = ref.ssm_scan_ref(*want_in)
    assert torch.equal(y, ry) and torch.equal(hl, rh)
    loss = (y * dy).sum() + ((hl * dh).sum() if with_dh else 0)
    rloss = (ry * dy).sum() + ((rh * dh).sum() if with_dh else 0)
    got = torch.autograd.grad(loss, got_in)
    want = torch.autograd.grad(rloss, want_in)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_bwd_plain_faults_move_the_gradient():
    """The planted faults ``chip_smoke.py`` holds the kernel's gate to, on
    the plain backward: dh_last ignored, h_t in place of h_{t-1} in da,
    and one block of d (256 / N of them) left out of dc."""
    a, bb, c, h0 = _t(*_inputs(1, 12, 64, 8, seed=9))
    dy, dh = _t(*_grads(1, 12, 64, 8, 9, True))
    da, db, dc, dh0 = ref.ssm_scan_bwd_ref(a, bb, c, h0, dy, dh)
    assert not torch.equal(ref.ssm_scan_bwd_ref(a, bb, c, h0, dy)[1], db)
    assert not torch.equal(ref.ssm_scan_bwd_ref(
        a, bb, c, h0, dy, dh, prev_state=False)[0], da)
    fdc = ref.ssm_scan_bwd_ref(a, bb, c, h0, dy, dh, drop_d=(32, 64))[2]
    assert ref.row_rel_err(fdc, dc)[1] > 1e-2


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take():
    a, bb, c, h0 = _t(*_inputs(1, 20, 8, 4))
    _, _, ckpt = k7.ssm_scan_ckpt_kernel(a, bb, c, h0)
    dy = torch.zeros((1, 20, 8))
    with pytest.raises(ValueError, match="ckpt"):
        k7.ssm_scan_bwd_kernel(a, bb, c, ckpt[:, :1], dy)
    with pytest.raises(ValueError, match="dy"):
        k7.ssm_scan_bwd_kernel(a, bb, c, ckpt, dy[:, :3])
    with pytest.raises(ValueError, match="dh_last"):
        k7.ssm_scan_bwd_kernel(a, bb, c, ckpt, dy, h0.double())
    with pytest.raises(ValueError, match="unsupported device"):
        k7.ssm_scan_bwd_kernel(*(x.to("meta") for x in (a, bb, c, ckpt, dy)))


# -- the fused entries ---------------------------------------------------------

def _fused_inputs(b, t, d, n, seed=0, dtype=torch.float32):
    """dt after softplus (0.01-0.7), A_log = log(1..N) as the layer's init
    (plus noise), B, C and x in ``dtype``, a non-zero h0 (numpy-made)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, d)) - 2.0)).astype(np.float32)
    a_log = (np.log(np.arange(1, n + 1))[None, :]
             + rng.normal(size=(d, n)) * 0.1).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    c = rng.normal(size=(b, t, n)).astype(np.float32)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    h0 = (rng.normal(size=(b, d, n)) * 0.1).astype(np.float32)
    tdt, ta_log, tbm, tc, tx, th0 = _t(dt, a_log, bm, c, x, h0)
    return (tdt, ta_log, tbm.to(dtype), tc.to(dtype), tx.to(dtype), th0)


def _fused_args(dt, a_log, bm, c, x, h0):
    return dt, -torch.exp(a_log), bm, c, x, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,n", [(1, 16, 16), (19, 32, 8), (40, 8, 4),
                                   (7, 12, 1)])
def test_fused_plain_forward_is_discretise_then_scan(t, d, n, dtype):
    """The fused scan's plain version (what the CPU runs and what the card's
    kernel is held to) equals the layer's ``_discretise`` followed by the
    plain scan bit for bit, through every entry (with and without
    checkpoints, ``ops``), in f32 and with bf16 B, C and x."""
    dt, a_log, bm, c, x, h0 = _fused_inputs(2, t, d, n, seed=t, dtype=dtype)
    a, bb = tmb._discretise(dt, a_log, bm, x)
    want = ref.ssm_scan_ref(a, bb, c.float(), h0)
    args = _fused_args(dt, a_log, bm, c, x, h0)
    for got in (ref.ssm_scan_fused_ref(*args), ops.ssm_scan_fused(*args),
                k7.ssm_scan_fused_kernel(*args),
                k7.ssm_scan_fused_ckpt_kernel(*args)[:2]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    _, _, ckpt = k7.ssm_scan_fused_ckpt_kernel(*args)
    assert torch.equal(ckpt, ref.ssm_scan_ckpt_ref(a, bb, c.float(), h0,
                                                   k7.WINDOW)[2])


@pytest.mark.parametrize("t,d,n", [(16, 32, 8), (1, 64, 16), (33, 16, 4)])
def test_fused_forward_matches_jax_discretise_and_kernel(t, d, n):
    """The port's fused scan against the JAX package's discretisation (as
    its ``mamba1_forward`` writes it) followed by its Pallas kernel in
    interpret mode and by its sequential oracle."""
    dt, a_log, bm, c, x, h0 = _fused_inputs(2, t, d, n, seed=11)
    y, hl = ops.ssm_scan_fused(*_fused_args(dt, a_log, bm, c, x, h0))
    jdt, ja_log, jbm, jc, jx, jh0 = (jnp.asarray(v.numpy())
                                     for v in (dt, a_log, bm, c, x, h0))
    ja = jnp.exp(jdt[..., None] * -jnp.exp(ja_log)[None, None])
    jb = jdt[..., None] * jbm[:, :, None, :] * jx[..., None]
    jy, jh = jops.ssm_scan(ja, jb, jc, jh0, block_d=min(32, d))
    ry, rh = jax.vmap(jref.ssm_scan_ref)(ja, jb, jc, jh0)
    for got, want in ((y, jy), (hl, jh), (y, ry), (hl, rh)):
        _close(got, want)


def test_fused_masked_steps_and_chunks_are_bitwise_one_call():
    """A masked prompt position (dt = 0) is the identity step, and a prefill
    split as the engine splits it (one call a chunk resuming from the last
    call's h_last, the ragged tail masked) equals one call bit for bit."""
    t, chunk = 30, 8
    dt, a_log, bm, c, x, h0 = _fused_inputs(1, t, 16, 8, seed=3)
    A = -torch.exp(a_log)
    y_full, h_full = ops.ssm_scan_fused(dt, A, bm, c, x, h0)
    ys, h = [], h0
    for s in range(0, t, chunk):
        sl = slice(s, s + chunk)
        pad = chunk - dt[:, sl].shape[1]
        ext = lambda v: torch.cat(  # noqa: E731
            [v[:, sl], torch.randn((1, pad) + tuple(v.shape[2:]))], dim=1)
        dtc = torch.cat([dt[:, sl], torch.zeros((1, pad, 16))], dim=1)
        y, h = ops.ssm_scan_fused(dtc, A, ext(bm), ext(c), ext(x), h)
        ys.append(y[:, :chunk - pad])
    assert torch.equal(torch.cat(ys, dim=1), y_full)
    assert torch.equal(h, h_full)


def _fused_loss_grads(args, dy, dh, fn):
    ins = [v.clone().requires_grad_() for v in args]
    y, hl = fn(*ins)
    loss = (y * dy).sum() + ((hl * dh).sum() if dh is not None else 0)
    return (y, hl), torch.autograd.grad(loss, ins)


def _composition(dt, A, bm, c, x, h0):
    return ref.ssm_scan_ref(*ref.ssm_discretise_ref(dt, A, bm, x),
                            c.float(), h0)


FUSED_GRAD_NAMES = ("d(dt)", "dA", "dB", "dC", "dx", "dh0")


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("t,d,n", [(1, 16, 8), (2 * k7.WINDOW + 5, 8, 4),
                                   (20, 24, 16), (9, 8, 1)])
def test_fused_bwd_ref_matches_autograd_of_the_composition(t, d, n, with_dh):
    """The fused plain backward (the discretisation's chain rule written out
    after the scan's) against autograd of ``_discretise`` then the plain
    scan: d(dt), dA, dB, dC, dx and dh0 within 1e-6 of each gradient's
    largest value (the two sum over n, d and (b, t) in other orders)."""
    dt, a_log, bm, c, x, h0 = _fused_inputs(2, t, d, n, seed=t + d)
    args = _fused_args(dt, a_log, bm, c, x, h0)
    dy, dh = _t(*_grads(2, t, d, n, t, True))
    dh = dh if with_dh else None
    _, want = _fused_loss_grads(args, dy, dh, _composition)
    got = ref.ssm_scan_fused_bwd_ref(*args, dy, dh)
    for name, g, w in zip(FUSED_GRAD_NAMES, got, want):
        assert g.dtype == w.dtype, name
        _close(g, w.numpy(), 1e-6)


@pytest.mark.parametrize("with_dh", [True, False])
def test_ssm_scan_fused_fn_equals_autograd_of_the_composition(with_dh):
    """``ops.ssm_scan_fused`` on tensors that need a gradient goes through
    ``SSMScanFusedFn``: the plain forward's bits, and autograd's gradients
    of the composition (1e-6), each in its input's dtype; a loss that reads
    y alone hands its backward no dh_last."""
    t = 2 * k7.WINDOW + 5
    dt, a_log, bm, c, x, h0 = _fused_inputs(2, t, 8, 4, seed=7)
    args = _fused_args(dt, a_log, bm, c, x, h0)
    dy, dh = _t(*_grads(2, t, 8, 4, 7, True))
    dh = dh if with_dh else None
    (y, hl), got = _fused_loss_grads(args, dy, dh, ops.ssm_scan_fused)
    assert "SSMScanFusedFn" in type(y.grad_fn).__name__
    (ry, rh), want = _fused_loss_grads(args, dy, dh, _composition)
    assert torch.equal(y, ry) and torch.equal(hl, rh)
    for name, g, w in zip(FUSED_GRAD_NAMES, got, want):
        assert g.dtype == w.dtype, name
        _close(g, w.numpy(), 1e-6)


@pytest.mark.parametrize("t,chunk", [(19, 8), (32, 16)])
def test_fused_bwd_ref_matches_jax_vjp(t, chunk):
    """The fused plain backward against ``jax.vjp`` of the reference's own
    composition: its discretisation (``mamba1_forward``'s lines) and its
    chunked associative scan, for every input, within MODULE_TOL."""
    b, d, n = 2, 16, 8
    dt, a_log, bm, c, x, h0 = _fused_inputs(b, t, d, n, seed=t)
    A = -torch.exp(a_log)
    dy, dh = _grads(b, t, d, n, t, True)

    def jfn(jdt, ja, jbm, jc, jx, jh0):
        ja_ = jnp.exp(jdt[..., None] * ja[None, None])
        jb_ = jdt[..., None] * jbm[:, :, None, :] * jx[..., None]
        return jmamba._chunked_selective_scan(ja_, jb_, jc, jh0, chunk)
    jargs = tuple(jnp.asarray(v.numpy()) for v in (dt, A, bm, c, x, h0))
    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ref.ssm_scan_fused_bwd_ref(dt, A, bm, c, x, h0,
                                     torch.from_numpy(dy),
                                     torch.from_numpy(dh))
    for name, g, w in zip(FUSED_GRAD_NAMES, got, want):
        _close(g, w, MODULE_TOL)


def test_fused_ckpt_and_bwd_entries_at_t0():
    """T = 0: no window, h_last = h0, every step gradient empty, dA zero
    and dh0 = dh_last."""
    dt, a_log, bm, c, x, h0 = _fused_inputs(2, 0, 8, 4)
    args = _fused_args(dt, a_log, bm, c, x, h0)
    y, hl, ckpt = k7.ssm_scan_fused_ckpt_kernel(*args)
    assert y.shape == (2, 0, 8) and ckpt.shape == (2, 0, 8, 4)
    assert torch.equal(hl, h0)
    ddt, dA, dB, dC, dx, dh0 = k7.ssm_scan_fused_bwd_kernel(
        *args[:5], ckpt, torch.zeros((2, 0, 8)), h0)
    assert ddt.shape == dx.shape == (2, 0, 8) and dB.shape == (2, 0, 4)
    assert torch.equal(dA, torch.zeros((8, 4))) and torch.equal(dh0, h0)


def test_fused_bwd_plain_faults_move_the_gradient():
    """The planted faults ``chip_smoke.py`` holds the fused backward's gate
    to, on the plain version: one lane's term left out of d(dt), one batch
    row left out of dA, one block of d (256 / N of them) left out of dB."""
    dt, a_log, bm, c, x, h0 = _fused_inputs(2, 12, 64, 8, seed=9)
    args = _fused_args(dt, a_log, bm, c, x, h0)
    dy, dh = _t(*_grads(2, 12, 64, 8, 9, True))
    good = ref.ssm_scan_fused_bwd_ref(*args, dy, dh)
    for kw, i in ((dict(drop_n=3), 0), (dict(drop_b=1), 1),
                  (dict(drop_d=(32, 64)), 2)):
        bad = ref.ssm_scan_fused_bwd_ref(*args, dy, dh, **kw)
        assert ref.row_rel_err(bad[i], good[i])[1] > 1e-2, kw
        assert all(torch.equal(bad[j], good[j]) for j in range(6) if j != i)


def test_fused_wrappers_refuse_what_the_kernels_do_not_take():
    dt, a_log, bm, c, x, h0 = _fused_inputs(1, 4, 8, 4)
    A = -torch.exp(a_log)
    with pytest.raises(ValueError, match="unsupported device"):
        k7.ssm_scan_fused_kernel(*(v.to("meta")
                                   for v in (dt, A, bm, c, x, h0)))
    with pytest.raises(TypeError, match="float32"):
        k7.ssm_scan_fused_kernel(dt.double(), A, bm, c, x, h0)
    with pytest.raises(TypeError, match="one dtype"):
        k7.ssm_scan_fused_kernel(dt, A, bm.bfloat16(), c, x, h0)
    with pytest.raises(TypeError, match="one dtype"):
        k7.ssm_scan_fused_kernel(dt, A, bm.half(), c.half(), x.half(), h0)
    with pytest.raises(ValueError, match="power of two"):
        k7.ssm_scan_fused_kernel(*_fused_args(*_fused_inputs(1, 4, 8, 6)))
    with pytest.raises(ValueError, match="power of two"):
        k7.ssm_scan_fused_kernel(*_fused_args(*_fused_inputs(1, 4, 8, 64)))
    with pytest.raises(ValueError, match="expected"):
        k7.ssm_scan_fused_kernel(dt, A, bm[:, :2], c, x, h0)
    with pytest.raises(ValueError, match="expected"):
        k7.ssm_scan_fused_kernel(dt, A[:4], bm, c, x, h0)
    strided = torch.cat([bm, bm], dim=-1)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        k7.ssm_scan_fused_kernel(dt, A, strided, c, x, h0)
    with pytest.raises(ValueError, match="contiguous"):
        k7.ssm_scan_fused_kernel(dt.transpose(1, 2).contiguous()
                                 .transpose(1, 2), A, bm, c, x, h0)
    # a slice of the layer's projection is taken as it is
    proj = torch.randn((1, 4, 3 + 2 * 4))
    y, _ = k7.ssm_scan_fused_kernel(dt, A, proj[..., 3:7], proj[..., 7:],
                                    x, h0)
    want, _ = ref.ssm_scan_fused_ref(dt, A, proj[..., 3:7].contiguous(),
                                     proj[..., 7:].contiguous(), x, h0)
    assert torch.equal(y, want)
    _, _, ckpt = k7.ssm_scan_fused_ckpt_kernel(dt, A, bm, c, x, h0)
    dy = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="ckpt"):
        k7.ssm_scan_fused_bwd_kernel(dt, A, bm, c, x, ckpt[:, :0], dy)
    with pytest.raises(ValueError, match="dy"):
        k7.ssm_scan_fused_bwd_kernel(dt, A, bm, c, x, ckpt, dy[:, :3])
    with pytest.raises(ValueError, match="dh_last"):
        k7.ssm_scan_fused_bwd_kernel(dt, A, bm, c, x, ckpt, dy, h0.double())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_scan_kernel_matches_plain_version_on_cuda(cuda):
    """K7 against its plain version at a decode and a ragged chunked shape;
    the chunked result equals the plain chunked oracle and one launch bit
    for bit, and each call of either entry launches once."""
    for b, t, d, n, chunk in ((8, 1, 256, 16, 1), (1, 300, 512, 16, 256),
                              (2, 19, 40, 8, 8)):
        ta, tb, tc, th = (x.to(cuda) for x in _t(*_inputs(b, t, d, n)))
        n0 = k7.launches
        y, h = ops.ssm_scan(ta, tb, tc, th)
        torch.cuda.synchronize()
        assert k7.launches == n0 + 1
        ry, rh = ref.ssm_scan_ref(ta, tb, tc, th)
        assert ref.row_rel_err(y, ry)[1] <= ref.ROW_TOL[torch.float32]
        assert ref.row_rel_err(h, rh)[1] <= ref.ROW_TOL[torch.float32]
        cy, ch = ops.ssm_scan_chunked(ta, tb, tc, th, chunk=chunk)
        torch.cuda.synchronize()
        assert k7.launches == n0 + 2
        assert torch.equal(cy, y) and torch.equal(ch, h)
        oy, oh = ref.ssm_scan_chunked_ref(ta, tb, tc, th, chunk)
        assert torch.equal(cy, oy) and torch.equal(ch, oh)


@pytest.mark.gpu
def test_scan_backward_kernel_matches_plain_version_on_cuda(cuda):
    """K7's backward against the plain backward: da, db and dh0 bit for
    bit (the same rounding, step for step), dc row by row (its sum over d
    in another order); two launches bitwise equal; each call counts one
    backward launch, and the checkpointing forward one forward launch."""
    for b, t, d, n in ((2, 37, 40, 8), (1, 1, 64, 16), (2, 33, 64, 1),
                       (2, 33, 64, 32), (1, 300, 512, 16)):
        ta, tb, tc, th = (x.to(cuda) for x in _t(*_inputs(b, t, d, n)))
        dy, dh = (x.to(cuda) for x in _t(*_grads(b, t, d, n, 0, True)))
        n0, b0 = k7.launches, k7.bwd_launches
        _, _, ckpt = k7.ssm_scan_ckpt_kernel(ta, tb, tc, th)
        got = k7.ssm_scan_bwd_kernel(ta, tb, tc, ckpt, dy, dh)
        again = k7.ssm_scan_bwd_kernel(ta, tb, tc, ckpt, dy, dh)
        torch.cuda.synchronize()
        assert (k7.launches, k7.bwd_launches) == (n0 + 1, b0 + 2)
        want = ref.ssm_scan_bwd_ref(ta, tb, tc, th, dy, dh)
        for g, g2, w in zip(got, again, want):
            assert torch.equal(g, g2)
        for i in (0, 1, 3):
            assert torch.equal(got[i], want[i])
        assert ref.row_rel_err(got[2], want[2])[1] \
            <= ref.ROW_TOL[torch.float32]


@pytest.mark.gpu
def test_fused_scan_kernel_matches_plain_version_on_cuda(cuda):
    """The fused forward against its plain version (the discretisation in
    torch ops on the card, then the plain scan), in f32 and with bf16 B, C
    and x, B and C slices of one projection: y and h_last row by row; two
    launches bitwise; a prefill split into masked chunks bitwise one launch;
    each call launches once and the checkpointing entry gives the same bits
    and the plain checkpoints' states."""
    tol = ref.ROW_TOL[torch.float32]
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, d, n in ((8, 1, 256, 16), (1, 300, 512, 16), (2, 19, 40, 8),
                           (2, 33, 64, 1), (2, 33, 64, 32)):
            dt, a_log, bm, c, x, h0 = (v.to(cuda) for v in _fused_inputs(
                b, t, d, n, seed=t, dtype=dtype))
            proj = torch.cat([bm, c], dim=-1)
            bm, c = proj[..., :n], proj[..., n:]
            args = _fused_args(dt, a_log, bm, c, x, h0)
            n0 = k7.launches
            y, h = ops.ssm_scan_fused(*args)
            y2, h2 = ops.ssm_scan_fused(*args)
            yk, hk, ckpt = k7.ssm_scan_fused_ckpt_kernel(*args)
            torch.cuda.synchronize()
            assert k7.launches == n0 + 3
            assert torch.equal(y, y2) and torch.equal(h, h2)
            assert torch.equal(y, yk) and torch.equal(h, hk)
            ry, rh = ref.ssm_scan_fused_ref(*args)
            assert ref.row_rel_err(y, ry)[1] <= tol
            assert ref.row_rel_err(h, rh)[1] <= tol
            a, bb = ref.ssm_discretise_ref(dt, args[1], bm, x)
            rk = ref.ssm_scan_ckpt_ref(a, bb, c.float(), h0, k7.WINDOW)[2]
            assert ref.row_rel_err(ckpt, rk)[1] <= tol
            ys, hc = [], h0
            for s in range(0, t, 256):
                sl = slice(s, s + 256)
                pad = 256 - dt[:, sl].shape[1]
                ext = lambda v: torch.cat(  # noqa: E731
                    [v[:, sl], v.new_ones((b, pad) + tuple(v.shape[2:]))],
                    dim=1)
                dtc = torch.cat([dt[:, sl], dt.new_zeros((b, pad, d))], dim=1)
                yc, hc = ops.ssm_scan_fused(dtc, args[1], ext(bm), ext(c),
                                            ext(x), hc)
                ys.append(yc[:, :256 - pad])
            assert torch.equal(torch.cat(ys, dim=1), y)
            assert torch.equal(hc, h)


@pytest.mark.gpu
def test_fused_scan_backward_kernel_matches_plain_version_on_cuda(cuda):
    """The fused backward against ``ref.ssm_scan_fused_bwd_ref`` on the card:
    d(dt), dA, dB, dC, dx and dh0 row by row (f32 limits, bf16 ones for the
    bf16 outputs), with and without dh_last; two launches bitwise; each call
    counts one backward launch."""
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, d, n in ((2, 37, 40, 8), (1, 1, 64, 16), (2, 33, 64, 1),
                           (2, 33, 64, 32), (1, 300, 512, 16)):
            dt, a_log, bm, c, x, h0 = (v.to(cuda) for v in _fused_inputs(
                b, t, d, n, seed=t, dtype=dtype))
            args = _fused_args(dt, a_log, bm, c, x, h0)
            dy, dh = (v.to(cuda) for v in _t(*_grads(b, t, d, n, 0, True)))
            _, _, ckpt = k7.ssm_scan_fused_ckpt_kernel(*args)
            for dhl in (dh, None):
                b0 = k7.bwd_launches
                got = k7.ssm_scan_fused_bwd_kernel(*args[:5], ckpt, dy, dhl)
                again = k7.ssm_scan_fused_bwd_kernel(*args[:5], ckpt, dy, dhl)
                torch.cuda.synchronize()
                assert k7.bwd_launches == b0 + 2
                want = ref.ssm_scan_fused_bwd_ref(*args, dy, dhl)
                for name, g, g2, w in zip(FUSED_GRAD_NAMES, got, again, want):
                    assert torch.equal(g, g2), name
                    assert g.dtype == w.dtype, name
                    assert ref.row_rel_err(g, w)[1] <= ref.ROW_TOL[w.dtype], \
                        name
