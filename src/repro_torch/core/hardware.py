"""The hardware record every pass of the port's compiler reads.

One frozen :class:`Hardware` holds what the cost model, Auto Vectorize,
Auto Distribution, Auto Schedule and codegen need to know about the device:
peak rates, memory tiers, the micro-kernel timing model, the blocked-layout
lane widths, tile alignments and the default kernel tile sizes.  It is
threaded explicitly (``CompileTarget.hardware`` and ``hw=`` keywords), never
read from mutable module state, so two compiles for two devices can share a
process and a cache.

``H100`` is the default: an NVIDIA H100 SXM 80 GB.  Rates are the data
sheet's (dense, no sparsity, at the 700 W limit); every derived value says
how it was derived.  None of them was measured by this package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    # --- rates (cost model, schedule and distribution) ---------------------
    matrix_flops: float          # dense matrix-unit rate, FLOP/s
    vector_flops: float          # elementwise-unit rate, FLOP/s
    mem_bw: float                # device memory bytes/s
    link_bw: float               # device-to-device bytes/s, one direction
    alpha: float                 # fixed latency of one collective, seconds
    # efficiency of a product / elementwise op left in the logical layout
    # (not blocked to the lanes below): what drives Auto Vectorize
    unpacked_matrix_eff: float
    unpacked_vector_eff: float
    # --- on-chip tier (Auto Schedule's capacity constraint) ----------------
    onchip_bytes: int            # fast memory one kernel's tiles may hold
    double_buffer: int           # resident copies of each streamed tile
    # --- micro-kernel timing model (schedule/ntt.py) -----------------------
    clock_hz: float
    matrix_macs_per_cycle: float
    vector_elems_per_cycle: float
    matrix_tile: Tuple[int, int, int]   # smallest (m, n, k) a unit issues
    vector_tile: Tuple[int, int]
    # --- blocked layouts (Auto Vectorize) -----------------------------------
    matrix_lanes: Tuple[int, int]       # (rows, depth) of a packed matmul block
    vector_lanes: Tuple[int, int]       # (rows, cols) of a packed elementwise block
    # --- tile alignment (schedule candidates and kernel plans) --------------
    tile_align: int              # GEMM / attention tiles are multiples of this
    fine_align: int              # page and rank tiles are multiples of this
    # --- kernel plan defaults, used where the schedule names no tile --------
    block_m: int
    block_n: int
    block_k: int
    block_q: int
    block_kv: int
    paged_block_kv: int
    lora_block_out: int
    lora_block_rank: int
    # --- a cluster of these devices (the dry run's roofline) ---------------
    hbm_bytes: int               # device memory capacity, bytes
    node_devices: int            # devices a node joins at link_bw
    net_bw: float                # bytes/s a device sends between nodes


# device memory of an H100 80GB HBM3 as the card reports it
# (torch.cuda.get_device_properties(0).total_memory, read on the card by
# chip_smoke.py's dryrun_calib line)
HBM_BYTES_H100 = 85_017_493_504

# H100 SXM 80 GB.  Data sheet: 989 TFLOP/s bf16 dense on the tensor cores,
# 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM3, 900 GB/s NVLink (450 GB/s
# each way), 132 SMs, 227 KB (232,448 B) of shared memory per block.
_SMS = 132
# 4 tensor cores per SM, 512 dense bf16 multiply-adds per clock each
_TC_MACS_PER_CYCLE = _SMS * 4 * 512            # 270,336
# 128 f32 lanes per SM
_FP32_LANES = _SMS * 128                       # 16,896

H100 = Hardware(
    name="H100 SXM 80GB",
    matrix_flops=989e12,
    # elementwise work runs on the CUDA cores, at the f32 rate
    vector_flops=67e12,
    mem_bw=3.35e12,
    link_bw=450e9,
    # modelling value: an NCCL collective between cards of one NVLink host
    # costs a few microseconds before its payload moves
    alpha=5e-6,
    # a product left unblocked reaches the tensor cores only through masked,
    # partly empty 64-row tiles; a quarter of peak is the modelling value.
    # Unblocked elementwise loses coalescing: half the rate.
    unpacked_matrix_eff=0.25,
    unpacked_vector_eff=0.5,
    onchip_bytes=232_448,
    double_buffer=2,
    # the clock at which 270,336 MACs per cycle give 989 TFLOP/s:
    # 989e12 / (2 * 270,336) = 1.829 GHz
    clock_hz=989e12 / (2 * _TC_MACS_PER_CYCLE),
    matrix_macs_per_cycle=_TC_MACS_PER_CYCLE,
    vector_elems_per_cycle=_FP32_LANES,
    # a warpgroup's wgmma is m64 x n(8..256) x k16 in bf16
    matrix_tile=(64, 64, 16),
    # one warp, 16 bytes (8 bf16) per thread: 256 contiguous elements
    vector_tile=(1, 256),
    # 64-row blocks (one warpgroup's wgmma) by 64-deep k slices (a 128-byte
    # bf16 row, the widest shared-memory swizzle)
    matrix_lanes=(64, 64),
    vector_lanes=(1, 256),
    tile_align=64,
    # 8 bf16 = one 16-byte vector load per thread
    fine_align=8,
    # GEMM CTA tile 128 x 128 with a 64-deep k step: A and B tiles are 16 KB
    # each in bf16, so four pipeline stages take 128 KB of the 227 KB
    block_m=128,
    block_n=128,
    block_k=64,
    # attention: 128 query rows (two warpgroups) against 128-key tiles; at
    # head_dim 128 in bf16, Q plus two stages of K and V take 160 KB
    block_q=128,
    block_kv=128,
    # paged attention streams the same 128-key span, at page resolution
    paged_block_kv=128,
    # segmented LoRA: one CTA's output tile, and ranks padded to one bf16
    # wgmma k step
    lora_block_out=128,
    lora_block_rank=16,
    hbm_bytes=HBM_BYTES_H100,
    # eight cards on one NVLink switch (an HGX H100 board)
    node_devices=8,
    # one 400 Gb/s NDR InfiniBand link a card between nodes
    net_bw=50e9,
)
