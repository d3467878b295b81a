"""The port's kernel wrappers against the JAX package.

On the CPU the wrappers run their plain versions (a CUDA tensor would
launch the kernel); JAX runs its Pallas kernels in interpret mode
(``repro.kernels.ops``) and its jnp oracles (``repro.kernels.ref``).  The
paged-attention grid is the one of ``tests/test_paged_attention.py``, the
matmul sweep the one of ``tests/test_kernels.py``.  Tests marked ``gpu``
hold the CUDA kernels against the plain versions on a card and
skip without one.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.kernels.matmul import matmul_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
F32_TOL = 2e-5
BF16_TOL = 5e-2


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def _pool(b, m, bs, kv, hd, seed=0, n_extra=2, bf16=False):
    rng = np.random.default_rng(seed)
    n = b * m + 1 + n_extra
    k = (rng.normal(size=(n, bs, kv, hd)) * 0.4).astype(np.float32)
    v = (rng.normal(size=(n, bs, kv, hd)) * 0.4).astype(np.float32)
    tables = rng.permutation(np.arange(1, n))[:b * m].reshape(b, m) \
        .astype(np.int32)
    return k, v, tables, rng


def _both(a, bf16=False):
    """(jax array, torch tensor) of one numpy input, bf16-rounded alike."""
    if bf16:
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))) \
            .to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _decode_case(b, m, bs, h, kv, hd, lens, seed, pages_per_fetch=1,
                 null_from=None, bf16=False):
    k, v, tables, rng = _pool(b, m, bs, kv, hd, seed=seed)
    if null_from is not None:
        for i, u in enumerate(null_from):
            tables[i, u:] = 0
    q = (rng.normal(size=(b, 1, h, hd)) * 0.4).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, bf16) for x in (q, k, v))
    jl, tl = jnp.asarray(lens, jnp.int32), torch.tensor(lens, dtype=torch.int32)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    tol = BF16_TOL if bf16 else F32_TOL
    got = ops.paged_attention(tq, tk, tv, tt, tl,
                              pages_per_fetch=pages_per_fetch)
    assert got.dtype == tq.dtype
    _close(got, jops.paged_attention(jq, jk, jv, jt, jl,
                                     pages_per_fetch=pages_per_fetch), tol)
    _close(got, jref.paged_attention_ref(jq, jk, jv, jt, jl), tol)
    _close(ref.paged_attention_ref(tq, tk, tv, tt, tl),
           jref.paged_attention_ref(jq, jk, jv, jt, jl), tol)


@pytest.mark.parametrize("pages_per_fetch", [1, 2, 3, 4])
def test_decode_ragged_lens(pages_per_fetch):
    _decode_case(4, 4, 8, 8, 2, 32, [1, 7, 16, 29], seed=0,
                 pages_per_fetch=pages_per_fetch)


def test_decode_null_block_padding():
    used = [1, 2, 3]
    _decode_case(3, 4, 8, 4, 2, 32, [u * 8 - 3 for u in used], seed=1,
                 null_from=used)


def test_decode_single_block_requests():
    _decode_case(2, 1, 8, 4, 4, 16, [1, 5], seed=2)


@pytest.mark.parametrize("bs", [3, 5, 7])
def test_decode_non_divisible_block_sizes(bs):
    _decode_case(2, 5, bs, 4, 2, 16, [bs + 1, 3 * bs - 2], seed=3,
                 pages_per_fetch=2)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
def test_decode_gqa_ratios(h, kv):
    _decode_case(2, 3, 4, h, kv, 16, [5, 12], seed=4)


def test_decode_bf16_pages():
    _decode_case(2, 3, 8, 4, 2, 32, [9, 20], seed=5, bf16=True)


@pytest.mark.parametrize("start,bf16", [(0, False), (8, False), (11, False),
                                        (11, True)])
def test_chunk_offsets(start, bf16):
    b, m, bs, h, kv, hd, c = 1, 4, 8, 4, 2, 32, 8
    k, v, tables, rng = _pool(b, m, bs, kv, hd, seed=6)
    q = (rng.normal(size=(b, c, h, hd)) * 0.4).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, bf16) for x in (q, k, v))
    cpos = np.arange(start, start + c, dtype=np.int32)
    kvl = np.asarray([start + c], np.int32)
    tol = BF16_TOL if bf16 else F32_TOL
    got = ops.paged_attention_chunk(tq, tk, tv, torch.from_numpy(tables),
                                    torch.from_numpy(cpos),
                                    torch.from_numpy(kvl))
    args = (jnp.asarray(tables), jnp.asarray(cpos), jnp.asarray(kvl))
    _close(got, jops.paged_attention_chunk(jq, jk, jv, *args), tol)
    _close(got, jref.paged_attention_chunk_ref(jq, jk, jv, *args), tol)


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 1)])
def test_chunk_gqa_ratios(h, kv):
    """One query head per KV head (the hybrid's shared block) hands the
    kernel a q that must still be contiguous after the per-KV-head
    grouping; several query heads per KV head as well."""
    b, m, bs, hd, c = 1, 3, 4, 16, 5
    k, v, tables, rng = _pool(b, m, bs, kv, hd, seed=7)
    q = (rng.normal(size=(b, c, h, hd)) * 0.4).astype(np.float32)
    cpos = np.arange(2, 2 + c, dtype=np.int32)
    kvl = np.asarray([2 + c], np.int32)
    got = ops.paged_attention_chunk(*(torch.from_numpy(x) for x in (
        q, k, v, tables, cpos, kvl)))
    _close(got, jref.paged_attention_chunk_ref(*(jnp.asarray(x) for x in (
        q, k, v, tables, cpos, kvl))), F32_TOL)


@pytest.mark.parametrize("d", [64, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_rmsnorm_matches_jax(d, bf16):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, bf16), _both(w, bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    got = ops.rmsnorm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jops.rmsnorm(jx, jw, eps=1e-6), tol)
    _close(got, jref.rmsnorm_ref(jx, jw, 1e-6), tol)
    _close(tlayers.rms_norm(tx, tw, 1e-6), jlayers.rms_norm(jx, jw, 1e-6), tol)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128),
                                   (384, 256, 512)])
@pytest.mark.parametrize("bf16", [False, True])
def test_matmul_matches_jax(m, k, n, bf16):
    """K4's wrapper (its plain version on the CPU) against the Pallas
    ``matmul_kernel`` in interpret mode and the jnp oracle."""
    rng = np.random.default_rng(42)
    (ja, ta), (jb, tb) = (_both((rng.normal(size=s) * 0.5)
                                .astype(np.float32), bf16)
                          for s in ((m, k), (k, n)))
    got = ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    want = jops.matmul(ja, jb, block_m=128, block_n=128, block_k=128)
    tol = ref.ROW_TOL[torch.bfloat16 if bf16 else torch.float32]
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert ref.row_rel_err(got.float(), want_t)[1] <= tol
    oracle = torch.from_numpy(np.array(jref.matmul_ref(ja, jb)
                                       .astype(jnp.float32)))
    assert ref.row_rel_err(ref.matmul_ref(ta, tb).float(), oracle)[1] <= tol


def test_matmul_takes_shapes_the_tpu_kernel_asserts_on():
    """The TPU kernel's block divisibility is not part of the function: K4
    takes ragged shapes (M = 1, the decode term's) and any block-free call."""
    g = torch.Generator().manual_seed(0)
    for m, k, n in ((1, 128, 2048), (100, 128, 128), (37, 100, 77), (5, 0, 3)):
        a, b = torch.randn((m, k), generator=g), torch.randn((k, n), generator=g)
        got = ops.matmul(a, b.t().contiguous().t())
        assert got.shape == (m, n)
        torch.testing.assert_close(got, a.double().mm(b.double()).float(),
                                   rtol=1e-5, atol=1e-5)


def test_wrappers_raise_instead_of_falling_back():
    """A device the kernels do not serve is refused, not computed on the
    CPU; bad shapes and types are refused before any launch."""
    q = torch.empty((1, 2, 2, 16), device="meta")
    pages = torch.empty((3, 4, 2, 16), device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_kernel(q, pages, pages, torch.empty((1, 2), **i32),
                               torch.empty((1, 2), **i32),
                               torch.empty((1,), **i32))
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_kernel(torch.zeros(1, 1, 1, 12),
                               torch.zeros(2, 4, 1, 12),
                               torch.zeros(2, 4, 1, 12),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.rmsnorm(torch.zeros(2, 8, dtype=torch.float16),
                    torch.ones(8, dtype=torch.float16))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm(torch.empty(2, 8, device="meta"),
                    torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        matmul_kernel(torch.empty(2, 8, device="meta"),
                      torch.empty(8, 4, device="meta"))
    with pytest.raises(TypeError):
        matmul_kernel(torch.zeros(2, 8), torch.zeros(8, 4).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        matmul_kernel(torch.zeros(2, 8), torch.zeros(4, 8).t())
    with pytest.raises(ValueError):
        matmul_kernel(torch.zeros(2, 8), torch.zeros(7, 4))


def test_launch_hygiene_in_the_sources():
    """The CUDA entry point returns the launch status, the wrapper raises
    on a non-zero one (itself, or through the package's shared
    ``kernels.launch``, which raises), and no ``except`` in the kernels
    package or in chip_smoke.py can fall back to a plain version."""
    assert "sm_90a" in (KERNELS / "build.py").read_text()

    def raises_on_status(tree):
        return [n for n in ast.walk(tree) if isinstance(n, ast.If)
                and "err != 0" in ast.unparse(n.test)
                and any(isinstance(s, ast.Raise) for s in n.body)]
    shared = ast.parse((KERNELS / "__init__.py").read_text())
    launch = [f for f in shared.body if isinstance(f, ast.FunctionDef)
              and f.name == "launch"]
    assert launch and raises_on_status(launch[0])
    for name in ("paged_attention", "rmsnorm", "matmul", "lora", "ssm_scan",
                 "flash_attention"):
        cu = (KERNELS / "csrc" / f"{name}.cu").read_text()
        assert "return cudaGetLastError();" in cu
        wrapper = ast.parse((KERNELS / f"{name}.py").read_text())
        calls_launch = [n for n in ast.walk(wrapper) if isinstance(n, ast.Call)
                        and ast.unparse(n.func) == "launch"]
        assert raises_on_status(wrapper) or calls_launch, \
            f"{name}: wrapper must raise on a non-zero launch status"
    for f in sorted(KERNELS.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(f.read_text())
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        assert not handlers, f"{f.name}: except clause at line " \
                             f"{handlers[0].lineno}"


def test_build_load_keeps_one_function_per_symbol(monkeypatch):
    """One source that exports two entry points (``csrc/lora.cu``: shrink
    and expand) hands out each under its own symbol, each with its own
    ``argtypes``, and a second call of either returns the cached one."""
    import ctypes
    from repro_torch.kernels import build

    class Fn:
        pass

    class FakeLib:
        def __init__(self, path):
            self.repro_lora_shrink = Fn()
            self.repro_lora_expand = Fn()

    monkeypatch.setattr(build, "_FNS", {})
    monkeypatch.setattr(build, "build", lambda *names: None)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    shrink = build.load("lora", "repro_lora_shrink", [ctypes.c_int])
    expand = build.load("lora", "repro_lora_expand", [ctypes.c_void_p])
    assert shrink is not expand
    assert shrink.argtypes == [ctypes.c_int]
    assert expand.argtypes == [ctypes.c_void_p]
    assert build.load("lora", "repro_lora_shrink", []) is shrink
    assert build.load("lora", "repro_lora_expand", []) is expand


def test_kernel_modules_import_without_triton_or_nvcc():
    import sys
    from repro_torch.kernels import build, rmsnorm  # noqa: F401
    assert "triton" not in sys.modules
    assert build._FNS == {}


def _decode_span_case(dtype, seed=0):
    """chip_smoke.py's decode inputs: B=8, H=16, KV=8, hd=128, bs=16, spans
    1..2048 in null-padded tables."""
    b, h, kv, hd, bs, m = 8, 16, 8, 128, 16, 128
    lens = [1, 17, 255, 512, 1000, 1537, 2000, 2048]
    g = torch.Generator().manual_seed(seed)
    n = b * m + 1
    kp = (torch.randn((n, bs, kv, hd), generator=g) * 0.5).to(dtype)
    vp = (torch.randn((n, bs, kv, hd), generator=g) * 0.5).to(dtype)
    tables = (torch.randperm(b * m, generator=g).reshape(b, m) + 1).int()
    for i, ln in enumerate(lens):
        tables[i, -(-ln // bs):] = 0
    q = (torch.randn((b, 1, h, hd), generator=g) * 0.5).to(dtype)
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32), bs


def test_row_gate_passes_bf16_rounding_and_rejects_planted_faults():
    """The per-row gate that holds each kernel against its plain version,
    at chip_smoke.py's decode shape in bf16: the kernel's own arithmetic (p
    rounded to bf16 before the PV product, output rounded once) passes it,
    and two faults that the old gate, normalised by the largest output of
    the whole tensor, let through fail it."""
    q, kp, vp, tables, lens, bs = _decode_span_case(torch.bfloat16)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens)
    tol = ref.ROW_TOL[torch.bfloat16]
    b, _, h, hd = q.shape
    kv = kp.shape[2]
    kg = kp[tables.long()].reshape(b, -1, kv, hd).float()
    vg = vp[tables.long()].reshape(b, -1, kv, hd).float()
    s = torch.einsum("bkrd,bskd->bkrs",
                     q.reshape(b, kv, h // kv, hd).float(), kg) / hd ** 0.5
    live = torch.arange(kg.shape[1])[None, None, None, :] \
        < lens[:, None, None, None]
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    honest = torch.einsum("bkrs,bskd->bkrd", p.bfloat16().float(), vg) \
        / p.sum(-1, keepdim=True)
    assert ref.row_rel_err(honest.reshape(q.shape).bfloat16(), want)[1] <= tol

    def old_gate(got):
        err = float((got.float() - want.float()).abs().max())
        return err / max(1.0, float(want.float().abs().max()))

    zeroed = want.clone()
    zeroed[lens > 255] = 0
    skipped = ref.paged_attention_ref(
        q, kp, vp, tables, torch.where(lens > bs, (lens - 1) // bs * bs, lens))
    for fault in (zeroed, skipped):
        assert ref.row_rel_err(fault, want)[1] > 4 * tol
    assert old_gate(zeroed) <= BF16_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_cuda(cuda, dtype):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = ref.ROW_TOL[dtype]
    for bs, hd, h, kv in ((16, 128, 16, 8), (5, 80, 4, 1), (3, 16, 4, 4)):
        b, m = 3, 7
        pages = [torch.randn((b * m + 1, bs, kv, hd), generator=gen,
                             device=cuda).to(dtype) for _ in range(2)]
        tables = torch.randperm(b * m, generator=gen, device=cuda) \
            .reshape(b, m).to(torch.int32) + 1
        lens = torch.tensor([1, bs + 2, m * bs], dtype=torch.int32,
                            device=cuda)
        q = torch.randn((b, 1, h, hd), generator=gen, device=cuda).to(dtype)
        n0 = pa.launches
        got = ops.paged_attention(q, *pages, tables, lens)
        assert pa.launches == n0 + 1
        want = ref.paged_attention_ref(q, *pages, tables, lens)
        assert ref.row_rel_err(got, want)[1] <= tol
        cpos = torch.arange(2, 2 + 9, dtype=torch.int32, device=cuda)
        kvl = torch.tensor([11], dtype=torch.int32, device=cuda)
        qc = torch.randn((1, 9, h, hd), generator=gen, device=cuda).to(dtype)
        got = ops.paged_attention_chunk(qc, *pages, tables[:1], cpos, kvl)
        want = ref.paged_attention_chunk_ref(qc, *pages, tables[:1], cpos, kvl)
        assert ref.row_rel_err(got, want)[1] <= tol
    # spans at the split-KV kernel's split boundaries (512 keys), qwen3's
    # and a group-8 layout; two launches bitwise equal; each row alone
    # bitwise equal to its row in the batch
    lens_list = [511, 512, 513, 1025, 2048]
    for h, kv, hd in ((16, 8, 128), (32, 4, 128), (32, 32, 80)):
        b, bs, m = len(lens_list), 16, 128
        pages = [torch.randn((b * m + 1, bs, kv, hd), generator=gen,
                             device=cuda).to(dtype) for _ in range(2)]
        tables = torch.randperm(b * m, generator=gen, device=cuda) \
            .reshape(b, m).to(torch.int32) + 1
        lens = torch.tensor(lens_list, dtype=torch.int32, device=cuda)
        q = torch.randn((b, 1, h, hd), generator=gen, device=cuda).to(dtype)
        got = ops.paged_attention(q, *pages, tables, lens)
        want = ref.paged_attention_ref(q, *pages, tables, lens)
        assert ref.row_rel_err(got, want)[1] <= tol
        assert torch.equal(got, ops.paged_attention(q, *pages, tables, lens))
        for i in range(b):
            alone = ops.paged_attention(q[i:i + 1], *pages, tables[i:i + 1],
                                        lens[i:i + 1])
            assert torch.equal(alone, got[i:i + 1])
    x = torch.randn((37, 1000), generator=gen, device=cuda).to(dtype)
    w = torch.randn((1000,), generator=gen, device=cuda).to(dtype)
    n0 = rn.launches
    got = ops.rmsnorm(x, w)
    assert rn.launches == n0 + 1
    want = ref.rmsnorm_ref(x, w)
    assert ref.row_rel_err(got, want)[1] <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain_version_on_cuda(cuda, dtype):
    from repro_torch.kernels import matmul as mm
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = ref.ROW_TOL[dtype]
    # the compile path's shapes (the skinny decode terms split K, the MLP's
    # tiles split K), ragged and unaligned shapes on every kernel (M < 16
    # or not), K = 0; two launches bitwise equal
    for m, k, n in ((1, 128, 2048), (1, 2048, 128), (256, 128, 2048),
                    (256, 1024, 3072), (256, 3072, 1024), (15, 4096, 64),
                    (4, 1000, 77), (37, 100, 77), (65, 33, 129),
                    (16, 4104, 520), (3, 0, 5), (40, 0, 8)):
        a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
        n0 = mm.launches
        got = ops.matmul(a, b)
        torch.cuda.synchronize()
        assert mm.launches == n0 + 1
        want = ref.matmul_ref(a, b)
        if k == 0:
            assert torch.equal(got, want)
        else:
            assert ref.row_rel_err(got, want)[1] <= tol
        assert torch.equal(got, ops.matmul(a, b))


# ---------------------------------------------------------------------------
# The redesigned kernels' algorithms, in plain PyTorch, against Pallas
# ---------------------------------------------------------------------------

def _rows_case(b, m, bs, kv, r, hd, lens, qpos, seed, null_from=None,
               bf16=False):
    """Kernel-interface inputs (q (B,KV,R,hd), per-row q_pos) as a
    (jax, torch) pair each."""
    k, v, tables, rng = _pool(b, m, bs, kv, hd, seed=seed)
    if null_from is not None:
        for i, u in enumerate(null_from):
            tables[i, u:] = 0
    q = (rng.normal(size=(b, kv, r, hd)) * 0.4).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, bf16) for x in (q, k, v))
    qpos = np.asarray(qpos, np.int32).reshape(b, r)
    lens = np.asarray(lens, np.int32)
    return ((jq, jk, jv, jnp.asarray(tables), jnp.asarray(qpos),
             jnp.asarray(lens)),
            (tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(qpos),
             torch.from_numpy(lens)))


def _pallas_rows(jargs, pages_per_fetch=1):
    from repro.kernels.paged_attention import paged_attention_kernel as pk
    out = pk(*jargs, pages_per_fetch=pages_per_fetch, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# (B, M, bs, KV, R, hd, lens, q_pos, null_from, bf16): the decode grid of
# the tests above (ragged, null-padded, block sizes that divide nothing,
# GQA groups, bf16 pages) and chunk-like rows whose q_pos differ
_SPLIT_GRID = {
    "ragged": (4, 4, 8, 2, 4, 32, [1, 7, 16, 29],
               [[0] * 4, [6] * 4, [15] * 4, [28] * 4], None, False),
    "null_padding": (3, 4, 8, 2, 2, 32, [5, 13, 21],
                     [[4] * 2, [12] * 2, [20] * 2], [1, 2, 3], False),
    "block_size_5": (2, 5, 5, 2, 2, 16, [6, 13], [[5] * 2, [12] * 2],
                     None, False),
    "group_8": (2, 3, 4, 1, 8, 16, [5, 12], [[4] * 8, [11] * 8], None,
                False),
    "chunk_rows": (1, 4, 8, 2, 6, 16, [27],
                   [[3, 9, 16, 21, 25, 26]], None, False),
    "bf16": (2, 3, 8, 2, 2, 32, [9, 20], [[8] * 2, [19] * 2], None, True),
}


@pytest.mark.parametrize("split", [4, 8, 16])
@pytest.mark.parametrize("case", sorted(_SPLIT_GRID))
def test_split_kv_combine_matches_pallas(case, split):
    """K1's split-KV algorithm (per-split m, l, acc merged in split order)
    against the Pallas kernel in interpret mode on the decode grid, with
    splits short enough that every span is cut several times."""
    b, m, bs, kv, r, hd, lens, qpos, null_from, bf16 = _SPLIT_GRID[case]
    jargs, targs = _rows_case(b, m, bs, kv, r, hd, lens, [qpos], seed=11,
                              null_from=null_from, bf16=bf16)
    want = _pallas_rows(jargs)
    got = ref.paged_attention_split_ref(*targs, split=split)
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert ref.row_rel_err(got.to(dtype), want)[1] <= ref.ROW_TOL[dtype]


@pytest.mark.parametrize("bf16", [False, True])
def test_split_kv_at_split_boundaries(bf16):
    """Spans one short of, at and one past the kernel's split length
    (512), two splits and a position (1,025 keys: three), and rows whose
    q_pos stop in different splits; dropping the middle split is a fault
    the per-row gate rejects."""
    lens = [511, 512, 513, 1025]
    b, bs, kv, r, hd = len(lens), 16, 1, 2, 16
    m = -(-max(lens) // bs)
    qpos = [[ln - 1, min(ln - 1, 600)] for ln in lens]
    jargs, targs = _rows_case(b, m, bs, kv, r, hd, lens, qpos, seed=12,
                              bf16=bf16)
    want = _pallas_rows(jargs, pages_per_fetch=8)
    dtype = torch.bfloat16 if bf16 else torch.float32
    tol = ref.ROW_TOL[dtype]
    got = ref.paged_attention_split_ref(*targs)
    assert ref.row_rel_err(got.to(dtype), want)[1] <= tol
    assert ref.row_rel_err(ref.paged_attention_rows_ref(*targs).to(dtype),
                           want)[1] <= tol
    dropped = ref.paged_attention_split_ref(*targs, drop=1)
    assert ref.row_rel_err(dropped[3:, :, :1].to(dtype),
                           want[3:, :, :1])[1] > 4 * tol
    # spans of one split are untouched by it
    assert torch.equal(dropped[:2], got[:2])


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128),
                                   (384, 256, 512), (16, 768, 256)])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("bf16", [False, True])
def test_split_k_reduction_matches_pallas(m, k, n, splits, bf16):
    """K4's split-K (f32 partials of equal K slices summed in slice order,
    one cast) against the Pallas ``matmul_kernel`` in interpret mode; with
    a middle slice dropped it fails the gate."""
    from repro.kernels.matmul import matmul_kernel as pallas_mm
    rng = np.random.default_rng(k + n)
    (ja, ta), (jb, tb) = (_both((rng.normal(size=s) * 0.5)
                                .astype(np.float32), bf16)
                          for s in ((m, k), (k, n)))
    want = torch.from_numpy(np.array(
        pallas_mm(ja, jb, block_m=min(m, 128), block_n=128, block_k=128,
                  interpret=True).astype(jnp.float32)))
    dtype = torch.bfloat16 if bf16 else torch.float32
    tol = ref.ROW_TOL[dtype]
    got = ref.matmul_split_k_ref(ta, tb, splits)
    assert got.dtype == dtype
    assert ref.row_rel_err(got, want)[1] <= tol
    if splits >= 3:
        dropped = ref.matmul_split_k_ref(ta, tb, splits, drop=1)
        assert ref.row_rel_err(dropped, want)[1] > 4 * tol


def test_split_k_of_an_empty_depth_is_zero():
    got = ref.matmul_split_k_ref(torch.ones(3, 0), torch.ones(0, 5), 4)
    assert torch.equal(got, torch.zeros(3, 5))


def test_library_key_follows_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every header it includes by
    a quoted ``#include``: editing a shared header rebuilds each library
    that includes it, and none that does not."""
    from repro_torch.kernels import build
    for name in ("matmul", "paged_attention", "flash_attention"):
        assert KERNELS / "csrc" / "sm90_mma.cuh" in build.sources(name)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cuda_runtime.h>\nint b;\n")
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "g.cuh").write_text("// two\n")
    assert build.library_path("a") != before["a"]
    assert build.library_path("b") == before["b"]
