"""Serve knobs the port honours (a subset of ``src/repro/perf.py``).

  REPRO_PAGED_ATTN     auto | kernel | gather
      auto   — paged decode/prefill attention launches the CUDA paged-
               attention kernel for CUDA tensors and takes the dense-gather
               path for CPU tensors (what the JAX package's "auto" does on
               its CPU backend)
      kernel — the kernel wrapper (``repro_torch.kernels.ops``); on CPU
               tensors the wrapper runs its plain PyTorch version
      gather — the dense pages[tables] gather path, also on CUDA (an
               explicit opt-in, never a fallback)
  REPRO_KV_SWAP        1 | 0
      1 — preemption parks a request's KV blocks on the pinned host tier
          and restores them on re-admission; 0 — drop and restart
  REPRO_SERVE_DEADLINE_MS, REPRO_SERVE_MAX_QUEUE, REPRO_SERVE_SHED_PRESSURE,
  REPRO_SERVE_MAX_CRASHES
      deadlines, bounded queue, load shedding and the degraded threshold of
      the serve engine (same meaning as in ``src/repro/perf.py``)
  REPRO_FAULT, REPRO_FAULT_SEED
      fault-injection spec and seed (``repro_torch.serve.faults``)
  REPRO_LORA_MAX_ADAPTERS  int (8)
      device-slot capacity of the serve engine's AdapterStore: at most this
      many LoRA adapters resident in the device slab at once.  Loading past
      the cap LRU-evicts an idle (refcount-0, unpinned) adapter to the host
      tier; if every slot is busy the load fails and the request is
      rejected rather than silently degrading a live tenant.
  REPRO_LORA_RANK      int (8)
      rank of adapters synthesized from their name (any declared tenant is
      servable without a checkpoint).  Explicitly supplied weights keep
      their own rank.
  REPRO_LORA_ALPHA     float (16)
      LoRA alpha of synthesized adapters; the alpha/rank scale is folded
      into the B slab at load time so the kernels stay scale-free.

``REPRO_NORM_F32=0`` (rms_norm in the activation dtype) is not ported: the
port's rms_norm always reduces in f32, and setting the knob raises.
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    paged_attn: str = "auto"
    kv_swap: bool = True
    serve_deadline_ms: int = 0
    serve_max_queue: int = 0
    serve_shed_pressure: float = 0.0
    serve_max_crashes: int = 3
    fault_spec: str = ""
    fault_seed: int = 0
    lora_max_adapters: int = 8
    lora_rank: int = 8
    lora_alpha: float = 16.0


def require_norm_f32() -> None:
    """Raise if ``REPRO_NORM_F32=0`` asks for a reduction the port lacks."""
    if os.environ.get("REPRO_NORM_F32", "1") != "1":
        raise NotImplementedError(
            "REPRO_NORM_F32=0 (rms_norm in the activation dtype) is not "
            "ported to repro_torch yet; see ROADMAP.md")


def perf() -> PerfConfig:
    require_norm_f32()
    mode = os.environ.get("REPRO_PAGED_ATTN", "auto")
    if mode not in ("auto", "kernel", "gather"):
        raise ValueError(f"bad REPRO_PAGED_ATTN {mode!r}")
    return PerfConfig(
        paged_attn=mode,
        kv_swap=os.environ.get("REPRO_KV_SWAP", "1") == "1",
        serve_deadline_ms=int(os.environ.get("REPRO_SERVE_DEADLINE_MS", "0")),
        serve_max_queue=int(os.environ.get("REPRO_SERVE_MAX_QUEUE", "0")),
        serve_shed_pressure=float(
            os.environ.get("REPRO_SERVE_SHED_PRESSURE", "0")),
        serve_max_crashes=int(os.environ.get("REPRO_SERVE_MAX_CRASHES", "3")),
        fault_spec=os.environ.get("REPRO_FAULT", ""),
        fault_seed=int(os.environ.get("REPRO_FAULT_SEED", "0")),
        lora_max_adapters=int(
            os.environ.get("REPRO_LORA_MAX_ADAPTERS", "8")),
        lora_rank=int(os.environ.get("REPRO_LORA_RANK", "8")),
        lora_alpha=float(os.environ.get("REPRO_LORA_ALPHA", "16")),
    )

