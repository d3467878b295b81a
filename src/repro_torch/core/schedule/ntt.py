"""NTT (nncase Tensor Template) micro-kernel registry and timing model
(§3.3.2).

The paper's NTT is a C++20 header library of register-level μkernels; the
port's counterparts are the hand-written kernels of ``repro_torch.kernels``.
This module is the *registry + analytical timing model* used by the Auto
Schedule MINLP (Eq. 15): each μkernel has a linear latency model
``t(n) = alpha + n / throughput`` whose unit throughputs and clock come
from the :class:`Hardware` record (default: the H100 SXM's tensor cores
and CUDA cores).

μkernels are the *atomic scheduling units*: MCTS/MINLP never schedule below
the μkernel tile (the paper's fix for the scalar-granularity mismatch).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

from repro_torch.core.hardware import H100, Hardware


@dataclasses.dataclass(frozen=True)
class MicroKernel:
    name: str
    unit: str                # "matrix" | "vector"
    tile: Tuple[int, ...]    # minimal hardware tile
    alpha_cycles: float      # fixed issue overhead
    throughput: float        # elements (or MACs) per cycle
    impl: str                # dotted path of the module that implements it


@functools.lru_cache(maxsize=None)
def micro_kernels(hw: Hardware = H100) -> Dict[str, MicroKernel]:
    """The registry with unit throughputs of ``hw``.  Per-op issue overheads
    and work per element are properties of the op, not of the device."""
    mm, vec = hw.matrix_macs_per_cycle, hw.vector_elems_per_cycle
    vt = tuple(hw.vector_tile)
    return {
        "matmul": MicroKernel("matmul", "matrix", tuple(hw.matrix_tile), 20.0,
                              mm, "repro_torch.kernels.matmul"),
        "exp": MicroKernel("exp", "vector", vt, 8.0, vec / 4,
                           "repro_torch.core.codegen"),
        "silu": MicroKernel("silu", "vector", vt, 8.0, vec / 6,
                            "repro_torch.core.codegen"),
        "add": MicroKernel("add", "vector", vt, 4.0, vec,
                           "repro_torch.core.codegen"),
        "mul": MicroKernel("mul", "vector", vt, 4.0, vec,
                           "repro_torch.core.codegen"),
        "rmsnorm": MicroKernel("rmsnorm", "vector", vt, 16.0, vec / 3,
                               "repro_torch.kernels.rmsnorm"),
        "softmax_row": MicroKernel("softmax_row", "vector", vt, 24.0, vec / 8,
                                   "repro_torch.kernels.paged_attention"),
        "ssm_step": MicroKernel("ssm_step", "vector", vt, 12.0, vec / 4,
                                "repro_torch.models"),
    }


MICRO_KERNELS: Dict[str, MicroKernel] = micro_kernels(H100)


def ukernel_time(name: str, work_elems: int, hw: Hardware = H100) -> float:
    """μKernelTime (Eq. 15): linear model, seconds for `work_elems` units
    (MACs for matrix kernels, elements for vector kernels) on ``hw``."""
    k = micro_kernels(hw)[name]
    cycles = k.alpha_cycles + work_elems / k.throughput
    return cycles / hw.clock_hz


def op_ukernel(op: str, kind: str = None) -> str:
    if op in ("matmul", "packed_matmul"):
        return "matmul"
    if kind in MICRO_KERNELS:
        return kind
    return "add"
