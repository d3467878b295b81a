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
  REPRO_MOE_DECODE     gather | dispatch
      how an MoE layer runs a decode step: gather — each token gathers
      its selected experts' weights and runs them (the default); dispatch —
      the batch's decode tokens are dispatched to the experts as one group
      with a capacity, as prefill dispatches a sequence

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
  REPRO_GATEWAY_IDLE_MS  int (2)
      how long the async engine's stepper thread parks when the engine has
      drained (a submit, cancel or stop wakes it at once)
  REPRO_GATEWAY_MAX_NEW  int (128)
      the gateway's ceiling on a request's ``max_tokens``
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

  REPRO_SERVE_MESH     0 | auto | N
      a ``ServeEngine`` built with ``mesh=None`` shards its KV block pool
      on the kv-heads axis over the ranks of the initialized
      ``torch.distributed`` process group: "auto" over all of them, N over
      a group of exactly N ranks ("0", "" or "off": one device).  Without
      an initialized group of that size the engine raises
      (``repro_torch.launch.mesh.make_serve_mesh``)
  REPRO_SERVE_TP       0 | 1
      1 — a mesh engine built with ``tp=None`` also stores the weights
          tensor-parallel, each rank its 1/n shard, with the partition
          rules Auto Distribution's SBP cost model emits
          (``repro_torch.distributed.param_sharding``).  Unlike the
          reference, which ignores it without a mesh, the port raises when
          no mesh is set (a TP request never serves on one device quietly)
  REPRO_TP_REDUCE_SCATTER  0 | 1
      0 — each TP weight is all-gathered at its use, so the arithmetic is
          the single device's, bit for bit
      1 — compute follows the stored layout: column-parallel q/k/v and
          MLP in-projections on the rank's heads and features, row-parallel
          output projections as partial sums with one all_reduce each, the
          vocab-sharded embedding as a masked lookup plus an all_reduce and
          the logits all-gathered over vocab; fp32-close, not bitwise
  REPRO_TRAIN_SHARDING  fsdp_tp | dp
      the layout ``repro_torch.distributed.sharding``'s spec functions
      give a training mesh: FSDP over the data axes and TP over "model",
      or pure data parallelism (weights replicated, moments ZeRO-sharded)

  REPRO_NORM_F32       1 | 0
      rms_norm's reduction and scale in f32 (1, the default) or in the
      activation dtype (0), as the reference's ``rms_norm``: the plain
      version and K2 (forward, pair and backward) both take the mode
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
    gateway_idle_ms: int = 2
    gateway_max_new: int = 128
    lora_max_adapters: int = 8
    lora_rank: int = 8
    lora_alpha: float = 16.0
    remat_policy: str = "dots"
    opt_state: str = "f32"
    attn_chunk: int = 1024
    moe_decode: str = "gather"
    serve_mesh: str = "0"
    serve_tp: bool = False
    tp_reduce_scatter: bool = False
    train_sharding: str = "fsdp_tp"
    norm_f32: bool = True


def norm_f32() -> bool:
    """REPRO_NORM_F32 alone: ``perf().norm_f32`` without the other knobs'
    parsing (rms_norm reads it at every call, 85 times a qwen3-0.6b model
    call, where ``perf()`` takes tens of microseconds of host)."""
    return os.environ.get("REPRO_NORM_F32", "1") == "1"


def perf() -> PerfConfig:
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
    moe_decode = os.environ.get("REPRO_MOE_DECODE", "gather")
    if moe_decode not in ("gather", "dispatch"):
        raise ValueError(f"bad REPRO_MOE_DECODE {moe_decode!r}")
    serve_mesh = os.environ.get("REPRO_SERVE_MESH", "0")
    if serve_mesh not in ("0", "", "off", "auto") and not (
            serve_mesh.isdigit() and int(serve_mesh) >= 1):
        raise ValueError(f"bad REPRO_SERVE_MESH {serve_mesh!r}")
    train_sharding = os.environ.get("REPRO_TRAIN_SHARDING", "fsdp_tp")
    if train_sharding not in ("fsdp_tp", "dp"):
        raise ValueError(f"bad REPRO_TRAIN_SHARDING {train_sharding!r}")
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
        gateway_idle_ms=int(os.environ.get("REPRO_GATEWAY_IDLE_MS", "2")),
        gateway_max_new=int(os.environ.get("REPRO_GATEWAY_MAX_NEW", "128")),
        lora_max_adapters=int(
            os.environ.get("REPRO_LORA_MAX_ADAPTERS", "8")),
        lora_rank=int(os.environ.get("REPRO_LORA_RANK", "8")),
        lora_alpha=float(os.environ.get("REPRO_LORA_ALPHA", "16")),
        remat_policy=remat,
        opt_state=opt_state,
        attn_chunk=attn_chunk,
        moe_decode=moe_decode,
        serve_mesh=serve_mesh,
        serve_tp=os.environ.get("REPRO_SERVE_TP", "0") == "1",
        tp_reduce_scatter=os.environ.get("REPRO_TP_REDUCE_SCATTER",
                                         "0") == "1",
        train_sharding=train_sharding,
        norm_f32=norm_f32(),
    )

