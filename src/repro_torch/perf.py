"""Serve and train knobs the port honours (a subset of ``src/repro/perf.py``).

  REPRO_REMAT_POLICY   dots | nothing
      what a rematerialised layer of ``transformer.forward_hidden(remat=
      True)`` keeps for the backward: dots — the outputs of its matrix
      products without batch dims (``aten.mm``/``addmm``: every projection
      and MLP product), so only the norms, attention and elementwise ops run
      again; nothing — only the layer's input, everything runs again
  REPRO_OPT_STATE      f32 | int8
      AdamW's moments when the trainer builds its optimizer without an
      explicit config: int8 stores them block-quantized (block 256, f32
      scales), ~2.03 B a parameter instead of 8
  REPRO_ATTN_CHUNK     int (1024)
      the q chunk of the plain ``multi_head_attention`` path when its
      caller passes the default: queries longer than twice the chunk that
      it divides go in chunks, so the score tensor never exceeds
      (B, H, chunk, S_kv).  It changes memory, not values.

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
``REPRO_SERVE_MESH`` (anything but "0", "" or "off") and
``REPRO_SERVE_TP=1`` (a sharded serve engine) are not ported either: the
port's ``ServeEngine`` raises when either is set (ROADMAP A10).
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
    remat_policy: str = "dots"
    opt_state: str = "f32"
    attn_chunk: int = 1024


def require_norm_f32() -> None:
    """Raise if ``REPRO_NORM_F32=0`` asks for a reduction the port lacks."""
    if os.environ.get("REPRO_NORM_F32", "1") != "1":
        raise NotImplementedError(
            "REPRO_NORM_F32=0 (rms_norm in the activation dtype) is not "
            "ported to repro_torch yet; see ROADMAP.md")


def require_single_device_serve() -> None:
    """Raise if ``REPRO_SERVE_MESH`` or ``REPRO_SERVE_TP`` asks for a
    sharded serve engine, which the port lacks (the reference builds one
    from them when no mesh is passed)."""
    mesh = os.environ.get("REPRO_SERVE_MESH", "0")
    if mesh not in ("0", "", "off"):
        raise NotImplementedError(
            f"REPRO_SERVE_MESH={mesh!r} (a serve engine sharded over a "
            "mesh) is not ported to repro_torch yet; see ROADMAP.md A10")
    if os.environ.get("REPRO_SERVE_TP", "0") == "1":
        raise NotImplementedError(
            "REPRO_SERVE_TP=1 (tensor-parallel serving) is not ported to "
            "repro_torch yet; see ROADMAP.md A10")


def perf() -> PerfConfig:
    require_norm_f32()
    mode = os.environ.get("REPRO_PAGED_ATTN", "auto")
    if mode not in ("auto", "kernel", "gather"):
        raise ValueError(f"bad REPRO_PAGED_ATTN {mode!r}")
    remat = os.environ.get("REPRO_REMAT_POLICY", "dots")
    if remat not in ("dots", "nothing"):
        raise ValueError(f"bad REPRO_REMAT_POLICY {remat!r}")
    opt_state = os.environ.get("REPRO_OPT_STATE", "f32")
    if opt_state not in ("f32", "int8"):
        raise ValueError(f"bad REPRO_OPT_STATE {opt_state!r}")
    attn_chunk = int(os.environ.get("REPRO_ATTN_CHUNK", "1024"))
    if attn_chunk < 1:
        raise ValueError(f"bad REPRO_ATTN_CHUNK {attn_chunk}")
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
        remat_policy=remat,
        opt_state=opt_state,
        attn_chunk=attn_chunk,
    )

