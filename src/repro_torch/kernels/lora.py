"""Wrappers of the CUDA C++ segmented LoRA kernels (``csrc/lora.cu``).

Replace the Pallas TPU kernels ``lora_shrink_kernel`` (K5) and
``lora_expand_kernel`` (K6) of ``src/repro/kernels/lora.py``; the source
file's header says how the kernels are laid out and what bounds them.
Three entry points share one device code: the shrink, the expand, and the
delta that fuses the two (and adds the base) in one launch, which is what
the model calls once per adapted projection.  Every sequence of a batch
applies its own adapter, selected from a slab of per-tenant factors by a
per-sequence slot id: ``ids`` (B,) int32 over T = B * ``rows_per_seq``
rows, row t reading ``ids[t // rows_per_seq]``; ``rows_per_seq`` 1 is the
per-row API.  A base row (id -1) comes out as exact zeros (base + 0 with a
base).  Ragged ranks share one slab: an adapter of lower rank is
zero-padded to the slab's rank, and its padding contributes exactly zero.

The shrink sums in f32 in an order fixed by d, the rank, the dtype and the
regime (``tensor_core_rows``); so the fused delta equals
``expand(shrink(x))`` (+ base) bit for bit, and a sequence's rows do not
depend on the rest of the batch.

Each wrapper checks what it is given and raises on anything its kernel does
not take, allocates the output with ``torch.empty`` and launches on the
current CUDA stream.  Tensors that lie on the CPU take the plain versions
(``ref.lora_shrink_ref`` / ``ref.lora_expand_ref`` / ``ref.lora_delta_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count, launch, ref, refuse_grad

# kernel launches since the last reset (chip_smoke.py reads and zeroes them)
shrink_launches = 0
expand_launches = 0
delta_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# repro_lora_shrink(x, a, ids, h, T, d, R, S, rows_per_seq, dtype, stream)
_SHRINK_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
# repro_lora_expand(h, b, ids, y, T, R, O, block_out, S, rows_per_seq,
#                   dtype, stream)
_EXPAND_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]
# repro_lora_delta(x, a, b, ids, base, y, T, d, R, O, block_out, S,
#                  rows_per_seq, dtype, stream)
_DELTA_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]
MAX_RANK = 64         # csrc/lora.cu's MAX_RANK
SLICES = 8            # csrc/lora.cu's P: blocks a cluster, slices of d
TC_MIN_ROWS = 16      # csrc/lora.cu's TC_MIN_ROWS
_MAX_TILES = 65535    # the expand grid's y axis
_INT_MAX = 2**31 - 1


def tensor_core_rows(dtype: torch.dtype, d: int, rows_per_seq: int) -> bool:
    """Whether the shrink of ``d`` features takes the tensor-core tile
    (else the CUDA cores): bf16, ``rows_per_seq`` >= 16 and d a multiple of
    8.  The two regimes round h differently, so a row's bits depend on this
    rule, which depends on nothing else."""
    return (dtype == torch.bfloat16 and rows_per_seq >= TC_MIN_ROWS
            and d % 8 == 0)


def load_kernels():
    """The three C entry points (shrink, expand, delta), built from
    ``csrc/lora.cu`` at the first call."""
    return (build.load("lora", "repro_lora_shrink", _SHRINK_ARGTYPES),
            build.load("lora", "repro_lora_expand", _EXPAND_ARGTYPES),
            build.load("lora", "repro_lora_delta", _DELTA_ARGTYPES))


def _check_common(what, act, slab, ids, rank_axis, rows_per_seq):
    if act.device != slab.device or ids.device != slab.device:
        raise ValueError(f"{what}: all inputs must share one device")
    if ids.dtype != torch.int32:
        raise TypeError(f"{what}: ids must be int32, got {ids.dtype}")
    if slab.dtype not in _DTYPES:
        raise TypeError(f"{what}: slab must be float32 or bfloat16, got "
                        f"{slab.dtype}")
    if act.dim() != 2 or slab.dim() != 3 or ids.dim() != 1:
        raise ValueError(f"{what}: want rows (T,·), slab (S,·,·) and ids "
                         f"(B,), got {tuple(act.shape)}, {tuple(slab.shape)}"
                         f" and {tuple(ids.shape)}")
    t = act.shape[0]
    if rows_per_seq < 1 or t % rows_per_seq:
        raise ValueError(f"{what}: rows_per_seq {rows_per_seq} does not "
                         f"divide the {t} rows")
    if ids.shape[0] != t // rows_per_seq:
        raise ValueError(f"{what}: want {t // rows_per_seq} ids for {t} rows "
                         f"of {rows_per_seq} a sequence, got {ids.shape[0]}")
    r = slab.shape[rank_axis]
    if r % 8 or not 8 <= r <= MAX_RANK:
        raise ValueError(f"{what}: rank {r} must be a multiple of 8 in "
                         f"[8, {MAX_RANK}]")
    if slab.shape[0] < 1 or max(act.numel(), slab.numel()) > _INT_MAX:
        raise ValueError(f"{what}: slab {tuple(slab.shape)} or rows "
                         f"{tuple(act.shape)} out of the kernel's range")
    if not (act.is_contiguous() and slab.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")


def _check_shrink(what, x, a_slab, rows_per_seq):
    """Checks of the shrink's inputs; returns whether they lie on the CPU
    (the plain version's), raising on a device the kernels do not serve."""
    if x.dtype != a_slab.dtype:
        raise TypeError(f"{what}: x and a_slab must share a dtype, got "
                        f"{x.dtype} and {a_slab.dtype}")
    if x.shape[1] != a_slab.shape[1]:
        raise ValueError(f"{what}: x feature dim {x.shape[1]} != slab "
                         f"{a_slab.shape[1]}")
    kind = x.device.type
    if kind == "cuda":
        if a_slab.data_ptr() % 16:
            raise ValueError(f"{what}: a_slab must be 16-byte aligned")
        if tensor_core_rows(x.dtype, x.shape[1], rows_per_seq) \
                and x.data_ptr() % 16:
            raise ValueError(f"{what}: x must be 16-byte aligned for the "
                             "tensor-core tile")
        return False
    return _on_cpu(what, x)


def _on_cpu(what, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cpu"


def _rows(ids, rows_per_seq):
    """Per-sequence ids as per-row ids (the plain versions' indexing)."""
    return ids if rows_per_seq == 1 else ids.repeat_interleave(rows_per_seq)


def lora_shrink_kernel(x: torch.Tensor, a_slab: torch.Tensor,
                       ids: torch.Tensor, rows_per_seq: int = 1
                       ) -> torch.Tensor:
    """x (T, d); a_slab (S, d, R); ids (T / rows_per_seq,) int32 slot per
    sequence, -1 = no adapter -> (T, R) float32.  x and the slab share a
    dtype."""
    refuse_grad("lora_shrink", x, a_slab)
    rows_per_seq = int(rows_per_seq)
    _check_common("lora_shrink", x, a_slab, ids, 2, rows_per_seq)
    on_cpu = _check_shrink("lora_shrink", x, a_slab, rows_per_seq)
    t, d = x.shape
    s, _, r = a_slab.shape
    if on_cpu:
        return ref.lora_shrink_ref(x, a_slab, _rows(ids, rows_per_seq))
    out = torch.empty((t, r), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    launch("lora_shrink", x.device, load_kernels()[0], x.data_ptr(),
           a_slab.data_ptr(), ids.data_ptr(), out.data_ptr(), t, d, r, s,
           rows_per_seq, _DTYPES[x.dtype])
    count(globals(), "shrink_launches")
    return out


def _check_block_out(what, block_out, o):
    block_out = int(block_out)
    if block_out < 1 or -(-o // block_out) > _MAX_TILES:
        raise ValueError(f"{what}: block_out {block_out} gives more than "
                         f"{_MAX_TILES} tiles of {o} outputs, or is < 1")
    return block_out


def lora_expand_kernel(h: torch.Tensor, b_slab: torch.Tensor,
                       ids: torch.Tensor, block_out: int = 256,
                       rows_per_seq: int = 1) -> torch.Tensor:
    """h (T, R) float32; b_slab (S, R, O); ids (T / rows_per_seq,) int32 ->
    (T, O) in the slab's dtype.  ``block_out`` is the output-feature tile
    one block covers; the result is bitwise the same for every value."""
    refuse_grad("lora_expand", h, b_slab)
    rows_per_seq = int(rows_per_seq)
    _check_common("lora_expand", h, b_slab, ids, 1, rows_per_seq)
    if h.dtype != torch.float32:
        raise TypeError(f"lora_expand: h must be float32, got {h.dtype}")
    t, r = h.shape
    s, r2, o = b_slab.shape
    if r != r2:
        raise ValueError(f"lora_expand: h rank {r} != slab {r2}")
    block_out = _check_block_out("lora_expand", block_out, o)
    if _on_cpu("lora_expand", h):
        return ref.lora_expand_ref(h, b_slab, _rows(ids, rows_per_seq),
                                   b_slab.dtype)
    out = torch.empty((t, o), dtype=b_slab.dtype, device=h.device)
    if t == 0 or o == 0:
        return out
    launch("lora_expand", h.device, load_kernels()[1], h.data_ptr(),
           b_slab.data_ptr(), ids.data_ptr(), out.data_ptr(), t, r, o,
           block_out, s, rows_per_seq, _DTYPES[b_slab.dtype])
    count(globals(), "expand_launches")
    return out


def lora_delta_kernel(x: torch.Tensor, a_slab: torch.Tensor,
                      b_slab: torch.Tensor, ids: torch.Tensor,
                      rows_per_seq: int = 1, block_out: int = 256,
                      base: torch.Tensor = None) -> torch.Tensor:
    """The shrink and the expand in one launch, h kept on chip: x (T, d),
    a_slab (S, d, R), b_slab (S, R, O), ids (T / rows_per_seq,) int32 ->
    (T, O) in x's dtype, plus ``base`` (T, O) when given.  All share x's
    dtype.  Bitwise ``expand(shrink(x))`` (+ base, added as PyTorch adds
    two tensors of that dtype)."""
    refuse_grad("lora_delta", x, a_slab, b_slab, base)
    rows_per_seq = int(rows_per_seq)
    _check_common("lora_delta", x, a_slab, ids, 2, rows_per_seq)
    on_cpu = _check_shrink("lora_delta", x, a_slab, rows_per_seq)
    dev, dtype = x.device, x.dtype
    (t, d), (s, r, o) = x.shape, b_slab.shape
    if b_slab.dtype != dtype or b_slab.device != dev:
        raise TypeError(f"lora_delta: b_slab must share x's dtype and "
                        f"device, got {b_slab.dtype} on {b_slab.device}")
    if s != a_slab.shape[0] or r != a_slab.shape[2] \
            or not b_slab.is_contiguous() or b_slab.numel() > _INT_MAX:
        raise ValueError(f"lora_delta: slabs {tuple(a_slab.shape)} and "
                         f"{tuple(b_slab.shape)} disagree on slots or rank, "
                         "or b_slab is not contiguous or out of range")
    if base is not None:
        if base.dtype != dtype or base.device != dev:
            raise TypeError(f"lora_delta: base must share x's dtype and "
                            f"device, got {base.dtype} on {base.device}")
        if base.shape != (t, o) or not base.is_contiguous():
            raise ValueError(f"lora_delta: base must be a contiguous "
                             f"({t}, {o}), got {tuple(base.shape)}")
    block_out = _check_block_out("lora_delta", block_out, o)
    if on_cpu:
        return ref.lora_delta_ref(x, a_slab, b_slab,
                                  _rows(ids, rows_per_seq), base)
    out = torch.empty((t, o), dtype=dtype, device=dev)
    if t == 0 or o == 0:
        return out
    launch("lora_delta", dev, load_kernels()[2], x.data_ptr(),
           a_slab.data_ptr(), b_slab.data_ptr(), ids.data_ptr(),
           None if base is None else base.data_ptr(), out.data_ptr(), t, d,
           r, o, block_out, s, rows_per_seq, _DTYPES[dtype])
    count(globals(), "delta_launches")
    return out
