"""Codegen (§3.3): extracted/scheduled plans -> executable PyTorch callables.

The paper emits C++ instantiating NTT μkernels; here the μkernels are the
port's hand-written CUDA kernels, so codegen means:

  * ``compile_term``  — walk an extracted Term (possibly packed) and build a
    python callable over named torch tensors.  Logical ``matmul`` runs the
    hand-written matmul kernel (``use_kernels=True``; its plain version for
    CPU tensors) or ``@``; ``packed_matmul`` over blocked operands is one
    ``torch.einsum``, as the reference leaves it to the framework.
  * ``kernel_plan``   — convert an Auto Schedule result into concrete kernel
    tile sizes, aligned to the :class:`Hardware` record's tiles.
  * buffer planning   — ``repro_torch.core.buffer_schedule`` supplies the
    offsets; PyTorch's caching allocator owns real allocation, so the plan
    is a memory report.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.hardware import H100, Hardware
from repro_torch.core.schedule.minlp import Schedule
from repro_torch.core.tensor_ir import Term, term_shape


def _pack_array(x, lanes, axes):
    """Blocked layout: dims (.., d*lane, ..) -> (.., d, .., lane0, lane1)."""
    shape = list(x.shape)
    new_shape = []
    lane_dims = []
    for i, d in enumerate(shape):
        if i in axes:
            lane = lanes[axes.index(i)]
            new_shape.extend([d // lane, lane])
            lane_dims.append(len(new_shape) - 1)
        else:
            new_shape.append(d)
    y = x.reshape(new_shape)
    outer = [i for i in range(len(new_shape)) if i not in lane_dims]
    return y.permute(outer + lane_dims)


def _unpack_array(x, lanes, axes, n_logical):
    nl = n_logical
    y = x
    # move lane dims back next to their outer dims
    for j, ax in enumerate(sorted(axes)):
        lane_dim = nl + j
        perm = list(range(y.dim()))
        perm.remove(lane_dim)
        perm.insert(ax + 1 + j, lane_dim)
        y = y.permute(perm)
    shape = []
    i = 0
    dims = list(y.shape)
    k = 0
    while i < len(dims):
        if k in axes:
            shape.append(dims[i] * dims[i + 1])
            i += 2
        else:
            shape.append(dims[i])
            i += 1
        k += 1
    return y.reshape(shape)


_UNARY = {
    "exp": torch.exp, "silu": F.silu, "relu": torch.relu,
    "neg": torch.neg,
    # the reference's gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(torch.relu(x)),
}
_BINARY = {"add": torch.add, "mul": torch.mul, "sub": torch.sub}


def compile_term(term: Term, use_kernels: bool = False) -> Callable:
    """Returns f(**inputs) evaluating the term over torch tensors.  Logical
    ``matmul`` runs the hand-written matmul kernel when ``use_kernels`` is
    set (CUDA tensors launch it, CPU tensors take its plain version) and
    ``@`` otherwise."""

    def ev(t: Term, env, cache):
        if t in cache:
            return cache[t]
        ch = [ev(c, env, cache) for c in t.children]
        op = t.op
        if op == "input":
            r = env[t.attr("name")]
        elif op == "matmul":
            if use_kernels:
                from repro_torch.kernels import ops as kops
                r = kops.matmul(ch[0], ch[1])
            else:
                r = ch[0] @ ch[1]
        elif op == "packed_matmul":
            # children are blocked (M', K', lm, lk) x (K', N', lk, ln)
            r = torch.einsum("mkab,knbc->mnac", ch[0], ch[1])
        elif op in ("unary", "packed_unary"):
            r = _UNARY[t.attr("kind")](ch[0])
        elif op in ("binary", "packed_binary"):
            r = _BINARY[t.attr("kind")](ch[0], ch[1])
        elif op == "transpose":
            r = ch[0].permute(t.attr("perm"))
        elif op == "pack":
            r = _pack_array(ch[0], t.attr("lanes"), t.attr("axes"))
        elif op == "unpack":
            n_logical = len(term_shape(t))
            r = _unpack_array(ch[0], t.attr("lanes"), t.attr("axes"), n_logical)
        else:
            raise ValueError(f"codegen: unknown op {op}")
        cache[t] = r
        return r

    def fn(**inputs):
        return ev(term, inputs, {})

    return fn


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Concrete kernel tile sizes derived from an Auto Schedule result.
    Defaults are the H100 record's (``hardware.H100``, which says how each
    was sized)."""
    block_m: int = H100.block_m
    block_n: int = H100.block_n
    block_k: int = H100.block_k
    block_q: int = H100.block_q            # attention q tile
    block_kv: int = H100.block_kv          # attention kv tile
    # paged attention streams whole KV pages, so its kv tile is aligned to
    # the page granularity (``fine_align``) rather than the matrix tile
    paged_block_kv: int = H100.paged_block_kv
    # segmented LoRA (gather-BGMV): output-dim tile per block and the
    # rank-slot granularity the adapter slab is padded to
    lora_block_out: int = H100.lora_block_out
    lora_block_rank: int = H100.lora_block_rank


def kernel_plan(schedule: Schedule, group: int = 0,
                hw: Hardware = H100) -> KernelPlan:
    """Map MINLP tiles to kernel tile sizes, aligned down to
    ``hw.tile_align`` (``hw.fine_align`` for pages and ranks); a loop the
    schedule does not name keeps ``hw``'s default.

    The schedule names loops by the bridge's ``l0, l1, ...`` while this
    looks up ``i, j, k, l``, as the reference does: a plan built from a
    ``tile_graph_from_term`` schedule therefore equals ``hw``'s defaults
    (ROADMAP C0)."""
    tiles = schedule.tiles.get(group, {})

    def pick(name, default, align=hw.tile_align):
        v = tiles.get(name, default)
        v = max(align, (v // align) * align)
        return v

    return KernelPlan(
        block_m=pick("i", hw.block_m),
        block_n=pick("j", hw.block_n),
        block_k=pick("k", hw.block_k),
        block_q=pick("i", hw.block_q),
        block_kv=pick("l", hw.block_kv),
        paged_block_kv=pick("l", hw.paged_block_kv, align=hw.fine_align),
        lora_block_out=pick("j", hw.lora_block_out),
        lora_block_rank=pick("k", hw.lora_block_rank, align=hw.fine_align),
    )


def paged_pages_per_fetch(plan: KernelPlan, block_size: int,
                          max_blocks_per_seq: int) -> int:
    """Map the schedule's kv-span tile (``paged_block_kv`` tokens) to whole
    KV pages per fetch of the paged-attention kernel.  This is how the serve
    engine turns the compiler's tiling decision into the kernel's streaming
    granularity instead of hand-picking a constant."""
    if block_size <= 0:
        return 1
    pages = max(1, plan.paged_block_kv // block_size)
    return max(1, min(pages, max_blocks_per_seq))


def lora_tiles(plan: KernelPlan, out_dim: int, max_rank: int
               ) -> "tuple[int, int]":
    """Map the schedule's tiles to the segmented-LoRA kernel's granularity:
    ``(block_out, rank_pad)``.  ``block_out`` is the output-feature tile one
    expand block covers (never wider than the projection itself);
    ``rank_pad`` is the rank-slot size adapter slabs are padded to, so a mix
    of ranks shares one slab shape."""
    block_out = max(1, min(plan.lora_block_out, out_dim))
    rank_pad = max(8, ((max_rank + plan.lora_block_rank - 1)
                       // plan.lora_block_rank) * plan.lora_block_rank)
    return block_out, rank_pad
