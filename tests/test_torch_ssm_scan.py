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
The tests marked ``gpu`` hold the CUDA kernels against the plain versions
on a card and skip without one.
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
