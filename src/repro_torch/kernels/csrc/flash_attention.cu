// Flash attention for Hopper (sm_90a), CUDA C++: forward and backward.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`), reached from
// `ops.flash_attention`.  Same function, with grouped-query attention read
// in the kernel: q (B*H, Sq, hd), k and v (B*KV, Skv, hd), all contiguous,
// group = (B*H) / (B*KV); query head bh reads KV head bh / group (right
// because both are flattened as b * heads + head).  Scale 1/sqrt(hd); with
// `causal`, query row i (at absolute position q_offset + i) sees key j iff
// q_offset + i >= j.  The forward writes o (B*H, Sq, hd) in q's dtype and
// the per-row log-sum-exp lse (B*H, Sq) in f32 (scaled scores), which the
// backward reuses.  The TPU kernel has no backward; this file adds one
// (FlashAttention-2's recompute):
//   D = rowsum(dO * O);  P = exp(S * scale - lse);  dV = P^T dO;
//   dP = dO V^T;  dS = P * (dP - D);  dK = scale dS^T Q;  dQ = scale dS K.
// dK and dV of a KV head sum over the `group` query heads that read it.
//
// What differs from the TPU kernel, and why.  Its grid walks the kv blocks
// in order and carries (m, l, acc) in scratch between grid steps; here one
// thread block owns a tile of query rows of one head and walks the kv tiles
// in a loop, keeping m, l and acc in registers.  Any Sq and Skv are taken:
// ragged tails are masked (the TPU kernel asserts that its block sizes
// divide both).  Tiles past the causal horizon are never read, as the TPU
// kernel's `pl.when` skips them.
//
// bf16: tensor cores.  The forward, dK/dV and dQ kernels are
// FlashAttention-2 designs on warp-level `mma.sync.m16n8k16` (bf16 inputs,
// f32 accumulation), fed by `ldmatrix` from shared memory:
// - Q, K, V and dO stay bf16 in shared memory, each row padded by 16 bytes
//   (row stride hd_tile + 8 elements), so the eight 16-byte rows of one
//   `ldmatrix` phase start four banks apart and never conflict.
// - K and V tiles (Q, dO, lse and D tiles in the dK/dV kernel) arrive
//   through a two-stage `cp.async` ring of 16-byte copies: the next tile's
//   load is in flight while the current one is multiplied.  Rows past the
//   sequence are zero-filled by the copy (src-size 0); a head_dim that is
//   not a multiple of 16 is padded with zero columns once.
// - Scores, probabilities and the O, dQ, dK, dV accumulators live in the
//   mma accumulator fragments in registers.  The softmax state (m, l) is
//   two rows a thread, reduced over the four lanes of a quad.  P, and dS in
//   the backward, become bf16 only as the A operand of the next product:
//   the accumulator fragment of two n8 tiles is the A fragment of one k16
//   step, so they never touch shared memory.
// - Forward and dQ: 4 warps own 64 query rows (16 each) and walk kv tiles
//   of 64 keys (32 at head_dim > 128).  dK/dV: one block per (64-key tile,
//   KV head); 4 warps own 16 keys each and walk the group's query heads
//   and, within each, their 64-row query tiles in a fixed order, so the
//   sum over the group is taken in registers, without atomics.  At
//   head_dim > 128, 32-row query tiles and 8 warps: two per key block,
//   each holding half of head_dim's dK/dV columns (the scores are computed
//   by both).  A warp skips a tile that the causal mask hides from all of
//   its rows.  `tools/k3_tune.py` times other tile shapes.
// - Kernels are instantiated for head_dim tiles of 64, 80, 128 and 256; a
//   shorter head_dim runs the tile's width over zero columns, so the mma
//   loops carry no run-time branch.
//
// Where accuracy is lost: S, the softmax and every sum are f32 (products of
// bf16 inputs are exact in f32); P (forward, dV) and dS (dK, dQ) are
// rounded to bf16 as the A operand of their product (relative 2^-9 an
// element), and o, dq, dk, dv are rounded to bf16 once at the end.
//
// What bounds it.  At the training shape (qwen3-0.6b: B 8 x 16 heads over
// 8 KV heads, S 512, hd 128, causal, bf16) the forward must move q, k, v
// (at the KV heads) and o, about 50 MB: 0.015 ms at 3.35 TB/s; its 8.6
// GFLOP take 0.0087 ms at the full bf16 tensor-core rate (989 TFLOP/s,
// `wgmma`).  So it is bound by bytes, and `mma.sync`, whose ceiling on
// Hopper is lower than `wgmma`'s, still leaves it bound by bytes at that
// ceiling; `wgmma` fed by TMA (a producer warp, an mbarrier ring, Q held
// across a 64-row warpgroup) is the next step only once this design
// reaches that ceiling.  The backward moves about twice the bytes for 2.5x
// the flops, and is bound the same way.
//
// f32: CUDA cores.  Tensor cores in f32 would be TF32 (10-bit mantissa),
// which the f32 gates and the f64 witness are there to refuse, so the f32
// kernels do every product on the CUDA cores in f32: 256 threads as a
// 16 x 16 grid, each a (BQ/16) x (BK/16) micro-tile of the score tile from
// Q and K tiles staged as f32 (row stride hd + 1); 64 x 64 tiles at
// hd <= 128, 32 x 32 above.  The dtype chooses the kernel; nothing falls
// back from one to the other.
//
// The backward runs three kernels in both types: D (one warp a row); dK and
// dV (one block per kv tile and KV head, looping over the group's query
// heads and their q tiles); dQ (one block per q tile, looping over kv
// tiles).  Each output element is summed by one thread in a fixed order: no
// float atomics, so the backward is bitwise deterministic from run to run
// (checkpoint/restart replays the same losses, and rematerialisation does
// not change a gradient).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int THREADS = 256;  // the f32 kernels: 16 x 16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes of a half-warp (lanes sharing one ty)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct Shape {
  int Sq, Skv, hd, causal, q_offset, group;
  float scale;
};

__device__ __forceinline__ bool visible(int r, int c, const Shape& s) {
  return r < s.Sq && c < s.Skv && (!s.causal || c <= s.q_offset + r);
}

// The causal horizon of a q tile: keys [0, end) can be visible to its rows.
__device__ __forceinline__ int kv_end(int q0, int BQ, const Shape& s) {
  return s.causal ? min(s.Skv, s.q_offset + min(q0 + BQ, s.Sq)) : s.Skv;
}

// Whether some (row, key) of a (q tile, kv tile) pair is not visible.
__device__ __forceinline__ bool needs_mask(int q0, int BQ, int k0, int BK,
                                           const Shape& s) {
  return q0 + BQ > s.Sq || k0 + BK > s.Skv ||
         (s.causal && k0 + BK - 1 > s.q_offset + q0);
}

// The first q tile (of BQ rows) with a row that sees key k0.
__device__ __forceinline__ int first_q_tile(int k0, int BQ, const Shape& s) {
  return s.causal ? max(0, k0 - s.q_offset) / BQ * BQ : 0;
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

// Stage rows [r0, r0 + B) of one (S, hd) slice as f32, row stride ld; rows
// at or past S read as zeros.
template <typename T, int B>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int r0,
                                          int S, int hd) {
  for (int i = threadIdx.x; i < B * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    dst[r * ld + d] =
        r0 + r < S ? to_f32(src[(size_t)(r0 + r) * hd + d]) : 0.f;
  }
}

// acc[i][j] += sum_d a[(ty + 16 i) * ld + d] * b[(tx + 16 j) * ld + d]: one
// thread's micro-tile of A B^T over hd.
template <int RA, int RB>
__device__ __forceinline__ void dot_tile(float (&acc)[RA][RB],
                                         const float* a, const float* b,
                                         int ld, int hd, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    float av[RA], bv[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < RB; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n w[n * wld + (ty + 16 i) (or rows, see `trans`)] *
// x[n * ld + tx + 16 j] for n < N: a thread's rows of W^T X (trans) or of
// W X (!trans), W a (BQ, BK) tile in shared memory with row stride wld, X an
// hd-wide tile.
template <bool TRANS, int R, int DC>
__device__ __forceinline__ void acc_tile(float (&acc)[R][DC], const float* w,
                                         int wld, const float* x, int ld,
                                         int N, int hd, int tx, int ty) {
  for (int n = 0; n < N; ++n) {
    float wv[R], xv[DC];
#pragma unroll
    for (int i = 0; i < R; ++i)
      wv[i] = TRANS ? w[n * wld + ty + 16 * i] : w[(ty + 16 * i) * wld + n];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      xv[j] = d < hd ? x[n * ld + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
  }
}

// Forward: one block per (q tile, bh).
template <typename T, int BQ, int BK, int DC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int ld = s.hd + 1, pld = BK + 1;
  float* q_s = smem;             // [BQ][ld]
  float* k_s = q_s + BQ * ld;    // [BK][ld]
  float* v_s = k_s + BK * ld;    // [BK][ld]
  float* p_s = v_s + BK * ld;    // [BQ][BK + 1]
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qb = (size_t)bh * s.Sq * s.hd;
  const size_t kb = (size_t)(bh / s.group) * s.Skv * s.hd;

  load_tile<T, BQ>(q_s, ld, q + qb, q0, s.Sq, s.hd);
  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int end = kv_end(q0, BQ, s);
  for (int k0 = 0; k0 < end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BK>(k_s, ld, k + kb, k0, s.Skv, s.hd);
    load_tile<T, BK>(v_s, ld, v + kb, k0, s.Skv, s.hd);
    __syncthreads();
    float sc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
    dot_tile<RQ, RK>(sc, q_s, k_s, ld, s.hd, tx, ty);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        sc[i][j] = visible(r, k0 + tx + 16 * j, s) ? sc[i][j] * s.scale
                                                   : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p =
            visible(r, k0 + tx + 16 * j, s) ? expf(sc[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * pld + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    acc_tile<false, RQ, DC>(acc, p_s, pld, v_s, ld, BK, s.hd, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < s.hd) o[qb + (size_t)r * s.hd + d] = from_f32<T>(acc[i][j] / denom);
    }
    if (tx == 0) lse[(size_t)bh * s.Sq + r] = m[i] + logf(l[i]);
  }
}

// Backward 1 (both types): D = rowsum(dO * O), one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ D, long rows, int hd) {
  const long row = ((long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(dout[row * hd + d]), to_f32(o[row * hd + d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) D[row] = acc;
}

// P (and dP) micro-tile of one (q tile, kv tile) pair: rows ty + 16 i of
// q_s/do_s, keys tx + 16 j of k_s/v_s; writes P into p_s (when non-null)
// and dS = P (dP - D) into ds_s.
template <int RQ, int RK>
__device__ __forceinline__ void probs_and_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    float* p_s, float* ds_s, int ld, int pld, const float* __restrict__ lse,
    const float* __restrict__ D, size_t rb, int q0, int k0, const Shape& s,
    int tx, int ty) {
  float sc[RQ][RK], dp[RQ][RK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) sc[i][j] = dp[i][j] = 0.f;
  dot_tile<RQ, RK>(sc, q_s, k_s, ld, s.hd, tx, ty);
  dot_tile<RQ, RK>(dp, do_s, v_s, ld, s.hd, tx, ty);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    const float lr = r < s.Sq ? lse[rb + r] : 0.f;
    const float dr = r < s.Sq ? D[rb + r] : 0.f;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int c = tx + 16 * j;
      const float p =
          visible(r, k0 + c, s) ? expf(sc[i][j] * s.scale - lr) : 0.f;
      if (p_s) p_s[(ty + 16 * i) * pld + c] = p;
      ds_s[(ty + 16 * i) * pld + c] = p * (dp[i][j] - dr);
    }
  }
}

// Backward 2: dK and dV, one block per (kv tile, KV head), looping over the
// group's query heads in order and, within each, over its q tiles.
template <typename T, int BQ, int BK, int DC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, Shape s) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int ld = s.hd + 1, pld = BK + 1;
  float* k_s = smem;              // [BK][ld]
  float* v_s = k_s + BK * ld;     // [BK][ld]
  float* q_s = v_s + BK * ld;     // [BQ][ld]
  float* do_s = q_s + BQ * ld;    // [BQ][ld]
  float* p_s = do_s + BQ * ld;    // [BQ][BK + 1]
  float* ds_s = p_s + BQ * pld;   // [BQ][BK + 1]
  const int kvh = blockIdx.y, k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kb = (size_t)kvh * s.Skv * s.hd;

  load_tile<T, BK>(k_s, ld, k + kb, k0, s.Skv, s.hd);
  load_tile<T, BK>(v_s, ld, v + kb, k0, s.Skv, s.hd);
  float dk_acc[RK][DC], dv_acc[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int first = first_q_tile(k0, BQ, s);
  for (int g = 0; g < s.group; ++g) {
    const int bh = kvh * s.group + g;
    const size_t qb = (size_t)bh * s.Sq * s.hd, rb = (size_t)bh * s.Sq;
    for (int q0 = first; q0 < s.Sq; q0 += BQ) {
      __syncthreads();
      load_tile<T, BQ>(q_s, ld, q + qb, q0, s.Sq, s.hd);
      load_tile<T, BQ>(do_s, ld, dout + qb, q0, s.Sq, s.hd);
      __syncthreads();
      probs_and_ds<RQ, RK>(q_s, do_s, k_s, v_s, p_s, ds_s, ld, pld, lse, D,
                           rb, q0, k0, s, tx, ty);
      __syncthreads();
      acc_tile<true, RK, DC>(dv_acc, p_s, pld, do_s, ld, BQ, s.hd, tx, ty);
      acc_tile<true, RK, DC>(dk_acc, ds_s, pld, q_s, ld, BQ, s.hd, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= s.Skv) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d >= s.hd) continue;
      dk[kb + (size_t)c * s.hd + d] = from_f32<T>(s.scale * dk_acc[i][j]);
      dv[kb + (size_t)c * s.hd + d] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// Backward 3: dQ, one block per (q tile, bh).
template <typename T, int BQ, int BK, int DC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq,
                    Shape s) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int ld = s.hd + 1, pld = BK + 1;
  float* q_s = smem;              // [BQ][ld]
  float* do_s = q_s + BQ * ld;    // [BQ][ld]
  float* k_s = do_s + BQ * ld;    // [BK][ld]
  float* v_s = k_s + BK * ld;     // [BK][ld]
  float* ds_s = v_s + BK * ld;    // [BQ][BK + 1]
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qb = (size_t)bh * s.Sq * s.hd;
  const size_t kb = (size_t)(bh / s.group) * s.Skv * s.hd;
  const size_t rb = (size_t)bh * s.Sq;

  load_tile<T, BQ>(q_s, ld, q + qb, q0, s.Sq, s.hd);
  load_tile<T, BQ>(do_s, ld, dout + qb, q0, s.Sq, s.hd);
  float acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int end = kv_end(q0, BQ, s);
  for (int k0 = 0; k0 < end; k0 += BK) {
    __syncthreads();
    load_tile<T, BK>(k_s, ld, k + kb, k0, s.Skv, s.hd);
    load_tile<T, BK>(v_s, ld, v + kb, k0, s.Skv, s.hd);
    __syncthreads();
    probs_and_ds<RQ, RK>(q_s, do_s, k_s, v_s, nullptr, ds_s, ld, pld, lse, D,
                         rb, q0, k0, s, tx, ty);
    __syncthreads();
    acc_tile<false, RQ, DC>(acc, ds_s, pld, k_s, ld, BK, s.hd, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.Sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < s.hd) dq[qb + (size_t)r * s.hd + d] = from_f32<T>(s.scale * acc[i][j]);
    }
  }
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async; the helpers
// and fragment maps are in sm90_mma.cuh)
// ===========================================================================

// Rows [r0, r0 + ROWS) of one (S, hd) bf16 slice into dst (row stride LD)
// by 16-byte cp.async; rows at or past S are zero-filled.  Columns past hd
// are left alone (zero_pad writes them once).
template <int ROWS, int LD, int NT>
__device__ __forceinline__ void load_async(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, int S, int hd) {
  const int cpr = hd / 8;
  for (int i = threadIdx.x; i < ROWS * cpr; i += NT) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * hd + c,
               ok ? 16 : 0);
  }
}

// Query rows of the forward and dQ blocks: 4 warps of 16.
constexpr int MMA_BQ = 64;

// Forward: one block of 4 warps per (q tile of 64 rows, bh); warp w owns
// rows 16 w .. 16 w + 15 and walks the kv tiles of BK keys.
template <int HD, int BK>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Shape s) {
  constexpr int BQ = MMA_BQ, LD = HD + 8, NT = 128, NB = BK / 8, DB = HD / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fa_smem);  // [BQ][LD]
  bf16* k_s = q_s + BQ * LD;                      // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]
  const int nqt = (s.Sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int bh = blockIdx.y;
  const bf16* qg = q + (size_t)bh * s.Sq * s.hd;
  const bf16* kg = k + (size_t)(bh / s.group) * s.Skv * s.hd;
  const bf16* vg = v + (size_t)(bh / s.group) * s.Skv * s.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  zero_pad<HD, LD, NT>(q_s, BQ + 4 * BK, s.hd);  // q_s, k_s, v_s adjoin
  const int end = kv_end(q0, BQ, s);
  const int ntiles = (end + BK - 1) / BK;
  load_async<BQ, LD, NT>(q_s, qg, q0, s.Sq, s.hd);
  load_async<BK, LD, NT>(k_s, kg, 0, s.Skv, s.hd);
  load_async<BK, LD, NT>(v_s, vg, 0, s.Skv, s.hd);
  cp_async_commit();

  float acc[DB][4];
  zero_acc(acc);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = s.scale * LOG2E;
  const int row0 = q0 + warp * 16;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK, st = j & 1;
    if (j + 1 < ntiles) {
      load_async<BK, LD, NT>(k_s + (st ^ 1) * BK * LD, kg, k0 + BK, s.Skv,
                             s.hd);
      load_async<BK, LD, NT>(v_s + (st ^ 1) * BK * LD, vg, k0 + BK, s.Skv,
                             s.hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // a warp whose rows all lie before the tile's first key skips it
    if (!s.causal || k0 <= s.q_offset + row0 + 15) {
      float sc[NB][4];
      zero_acc(sc);
      mma_abt<HD, LD, NB>(sc, q_s + warp * 16 * LD, k_s + st * BK * LD,
                          lane);

      // online softmax in log2 units: rows row0 + g (h = 0) and + 8
      const bool mask = needs_mask(q0, BQ, k0, BK, s);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * sl2;
          if (mask && !visible(row0 + g + 8 * (e / 2),
                               k0 + n * 8 + 2 * t + (e & 1), s))
            x = NEG_INF;
          sc[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        alpha[h] = fast_exp2(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = fast_exp2(sc[n][e] - m[e / 2]);
          rs[e / 2] += sc[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(FULL, rs[h], 1);
        rs[h] += __shfl_xor_sync(FULL, rs[h], 2);
        l[h] = l[h] * alpha[h] + rs[h];
      }
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
      mma_px<LD, NB, DB>(acc, sc, v_s + st * BK * LD, 0, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  store_rows<DB>(o + (size_t)bh * s.Sq * s.hd, acc, inv, row0, s.Sq, 0, s.hd,
                 lane);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r < s.Sq) lse[(size_t)bh * s.Sq + r] = (m[h] + log2f(l[h])) * LN2;
    }
}

// dQ: one block of 4 warps per (q tile of 64 rows, bh), walking kv tiles
// of BK keys; warp w owns rows 16 w .. 16 w + 15.
template <int HD, int BK>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, bf16* __restrict__ dq,
                        Shape s) {
  constexpr int BQ = MMA_BQ, LD = HD + 8, NT = 128, NB = BK / 8, DB = HD / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fa_smem);  // [BQ][LD]
  bf16* do_s = q_s + BQ * LD;                     // [BQ][LD]
  bf16* k_s = do_s + BQ * LD;                     // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]
  const int nqt = (s.Sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const size_t qb = (size_t)bh * s.Sq * s.hd, rb = (size_t)bh * s.Sq;
  const bf16* kg = k + (size_t)(bh / s.group) * s.Skv * s.hd;
  const bf16* vg = v + (size_t)(bh / s.group) * s.Skv * s.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  zero_pad<HD, LD, NT>(q_s, 2 * BQ + 4 * BK, s.hd);
  const int end = kv_end(q0, BQ, s);
  const int ntiles = (end + BK - 1) / BK;
  load_async<BQ, LD, NT>(q_s, q + qb, q0, s.Sq, s.hd);
  load_async<BQ, LD, NT>(do_s, dout + qb, q0, s.Sq, s.hd);
  load_async<BK, LD, NT>(k_s, kg, 0, s.Skv, s.hd);
  load_async<BK, LD, NT>(v_s, vg, 0, s.Skv, s.hd);
  cp_async_commit();

  const int row0 = q0 + warp * 16;
  // lse (log2 units) and D of the thread's rows row0 + g + 8 h
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    lr[h] = r < s.Sq ? lse[rb + r] * LOG2E : 0.f;
    dr[h] = r < s.Sq ? D[rb + r] : 0.f;
  }
  float acc[DB][4];
  zero_acc(acc);
  const float sl2 = s.scale * LOG2E;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK, st = j & 1;
    if (j + 1 < ntiles) {
      load_async<BK, LD, NT>(k_s + (st ^ 1) * BK * LD, kg, k0 + BK, s.Skv,
                             s.hd);
      load_async<BK, LD, NT>(v_s + (st ^ 1) * BK * LD, vg, k0 + BK, s.Skv,
                             s.hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (!s.causal || k0 <= s.q_offset + row0 + 15) {
      const bf16* ks = k_s + st * BK * LD;
      float sc[NB][4], dp[NB][4];
      zero_acc(sc);
      zero_acc(dp);
      mma_abt<HD, LD, NB>(sc, q_s + warp * 16 * LD, ks, lane);
      mma_abt<HD, LD, NB>(dp, do_s + warp * 16 * LD, v_s + st * BK * LD,
                          lane);
      const bool mask = needs_mask(q0, BQ, k0, BK, s);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const bool live = !mask || visible(row0 + g + 8 * h,
                                             k0 + n * 8 + 2 * t + (e & 1), s);
          const float p = live ? fast_exp2(sc[n][e] * sl2 - lr[h]) : 0.f;
          sc[n][e] = p * (dp[n][e] - dr[h]);  // dS
        }
      mma_px<LD, NB, DB>(acc, sc, ks, 0, lane);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const float sc2[2] = {s.scale, s.scale};
  store_rows<DB>(dq + qb, acc, sc2, row0, s.Sq, 0, s.hd, lane);
}

// dK and dV: one block per (kv tile of 64 keys, KV head).  Warp w owns keys
// 16 (w % 4) .. + 15 and the head_dim columns [(w / 4) HW, + HW) of their
// dK and dV (HS = 2 splits head_dim between two warps at HD 256); every
// warp walks the group's query heads and their q tiles of BQ rows in the
// same fixed order, double-buffered.
template <int HD, int BQ, int HS>
__global__ void __launch_bounds__(128 * HS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Shape s) {
  constexpr int BK = 64, LD = HD + 8, NT = 128 * HS, NB = BQ / 8;
  constexpr int HW = HD / HS, DB = HW / 8;
  static_assert(NT >= 2 * BQ, "one thread a row loads lse and D");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(fa_smem);  // [BK][LD]
  bf16* v_s = k_s + BK * LD;                      // [BK][LD]
  bf16* q_s = v_s + BK * LD;                      // [2][BQ][LD]
  bf16* do_s = q_s + 2 * BQ * LD;                 // [2][BQ][LD]
  float* l_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][BQ]
  float* d_s = l_s + 2 * BQ;                                  // [2][BQ]
  const int kvh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t kb = (size_t)kvh * s.Skv * s.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + (warp % 4) * 16, d0 = (warp / 4) * HW;

  zero_pad<HD, LD, NT>(k_s, 2 * BK + 4 * BQ, s.hd);
  load_async<BK, LD, NT>(k_s, k + kb, k0, s.Skv, s.hd);
  load_async<BK, LD, NT>(v_s, v + kb, k0, s.Skv, s.hd);

  // iteration i: query head kvh * group + i / nq, q tile first + (i % nq) BQ
  const int first = first_q_tile(k0, BQ, s);
  const int nq = first < s.Sq ? (s.Sq - first + BQ - 1) / BQ : 0;
  const int iters = s.group * nq;
  auto load_q = [&](int i, int st) {
    const int bh = kvh * s.group + i / nq, q0 = first + (i % nq) * BQ;
    const size_t qb = (size_t)bh * s.Sq * s.hd, rb = (size_t)bh * s.Sq;
    load_async<BQ, LD, NT>(q_s + st * BQ * LD, q + qb, q0, s.Sq, s.hd);
    load_async<BQ, LD, NT>(do_s + st * BQ * LD, dout + qb, q0, s.Sq, s.hd);
    const int x = threadIdx.x;
    if (x < 2 * BQ) {
      const int r = q0 + x % BQ;
      const bool ok = r < s.Sq;
      const float* src = (x < BQ ? lse : D) + rb + (ok ? r : 0);
      cp_async4((x < BQ ? l_s : d_s) + st * BQ + x % BQ, src, ok ? 4 : 0);
    }
  };
  if (iters > 0) load_q(0, 0);
  cp_async_commit();

  float dk_acc[DB][4], dv_acc[DB][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  const float sl2 = s.scale * LOG2E;

  for (int i = 0; i < iters; ++i) {
    const int st = i & 1, q0 = first + (i % nq) * BQ;
    if (i + 1 < iters) load_q(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp, unless
    // every query of the tile lies before the warp's first key
    if (!s.causal || key0 <= s.q_offset + q0 + BQ - 1) {
      const bf16* qs = q_s + st * BQ * LD;
      const bf16* dos = do_s + st * BQ * LD;
      const float* ls = l_s + st * BQ;
      const float* ds = d_s + st * BQ;
      float sc[NB][4], dp[NB][4];
      zero_acc(sc);
      zero_acc(dp);
      mma_abt<HD, LD, NB>(sc, k_s + (key0 - k0) * LD, qs, lane);
      mma_abt<HD, LD, NB>(dp, v_s + (key0 - k0) * LD, dos, lane);
      const bool mask = needs_mask(q0, BQ, k0, BK, s);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);  // query within the tile
          const bool live =
              !mask || visible(q0 + qc, key0 + g + 8 * (e / 2), s);
          const float p =
              live ? fast_exp2(sc[n][e] * sl2 - ls[qc] * LOG2E) : 0.f;
          sc[n][e] = p;                       // P^T
          dp[n][e] = p * (dp[n][e] - ds[qc]);  // dS^T
        }
      mma_px<LD, NB, DB>(dv_acc, sc, dos, d0, lane);  // dV += P^T dO
      mma_px<LD, NB, DB>(dk_acc, dp, qs, d0, lane);   // dK += dS^T Q
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f}, sc2[2] = {s.scale, s.scale};
  store_rows<DB>(dk + kb, dk_acc, sc2, key0, s.Skv, d0, s.hd, lane);
  store_rows<DB>(dv + kb, dv_acc, one, key0, s.Skv, d0, s.hd, lane);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *lse, *dq, *dk, *dv, *D;
  int BH, BKV;
  Shape s;
  cudaStream_t stream;
};

template <typename T, int BQ, int BK, int DC>
cudaError_t launch_fwd(const Args& a) {
  const int ld = a.s.hd + 1;
  const size_t smem = (size_t)((BQ + 2 * BK) * ld + BQ * (BK + 1)) * 4;
  auto kern = flash_fwd_kernel<T, BQ, BK, DC>;
  static size_t allowed = 0;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s.Sq + BQ - 1) / BQ, a.BH);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dot(const Args& a) {
  const long rows = (long)a.BH * a.s.Sq;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows * 32 + THREADS - 1) / THREADS),
                            THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.D), rows, a.s.hd);
  return cudaGetLastError();
}

template <typename T, int BQ, int BK, int DC>
cudaError_t launch_bwd(const Args& a) {
  const int ld = a.s.hd + 1;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* D = static_cast<float*>(a.D);
  cudaError_t e = launch_dot<T>(a);
  if (e != cudaSuccess) return e;

  const size_t smem_kv =
      (size_t)((2 * BQ + 2 * BK) * ld + 2 * BQ * (BK + 1)) * 4;
  auto kv_kern = flash_bwd_dkdv_kernel<T, BQ, BK, DC>;
  static size_t kv_allowed = 0;
  if ((e = allow_smem(kv_kern, smem_kv, kv_allowed)) != cudaSuccess) return e;
  kv_kern<<<dim3((a.s.Skv + BK - 1) / BK, a.BKV), THREADS, smem_kv,
            a.stream>>>(q, k, v, dout, lse, D, static_cast<T*>(a.dk),
                        static_cast<T*>(a.dv), a.s);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem_q = (size_t)((2 * BQ + 2 * BK) * ld + BQ * (BK + 1)) * 4;
  auto q_kern = flash_bwd_dq_kernel<T, BQ, BK, DC>;
  static size_t q_allowed = 0;
  if ((e = allow_smem(q_kern, smem_q, q_allowed)) != cudaSuccess) return e;
  q_kern<<<dim3((a.s.Sq + BQ - 1) / BQ, a.BH), THREADS, smem_q, a.stream>>>(
      q, k, v, dout, lse, D, static_cast<T*>(a.dq), a.s);
  return cudaGetLastError();
}

// bf16 forward: q tiles of 64 rows, kv tiles of BK keys.
template <int HD, int BK>
cudaError_t launch_fwd_mma(const Args& a) {
  const size_t smem = (size_t)(MMA_BQ + 4 * BK) * (HD + 8) * 2;
  auto kern = flash_fwd_mma_kernel<HD, BK>;
  static size_t allowed = 0;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.s.Sq + MMA_BQ - 1) / MMA_BQ, a.BH), 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), a.s);
  return cudaGetLastError();
}

// bf16 dK/dV: kv tiles of 64 keys, q tiles of BQ rows, head_dim split
// between HS warps.
template <int HD, int BQ, int HS>
cudaError_t launch_dkdv_mma(const Args& a) {
  const size_t smem =
      (size_t)(2 * 64 + 4 * BQ) * (HD + 8) * 2 + 4 * BQ * sizeof(float);
  auto kern = flash_bwd_dkdv_mma_kernel<HD, BQ, HS>;
  static size_t allowed = 0;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.s.Skv + 63) / 64, a.BKV), 128 * HS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.s);
  return cudaGetLastError();
}

// bf16 dQ: as the forward's tiles.
template <int HD, int BK>
cudaError_t launch_dq_mma(const Args& a) {
  const size_t smem = (size_t)(2 * MMA_BQ + 4 * BK) * (HD + 8) * 2;
  auto kern = flash_bwd_dq_mma_kernel<HD, BK>;
  static size_t allowed = 0;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.s.Sq + MMA_BQ - 1) / MMA_BQ, a.BH), 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<bf16*>(a.dq), a.s);
  return cudaGetLastError();
}

// bf16 backward: D, then dK/dV (q tiles of KBQ rows), then dQ (kv tiles
// of BK keys).
template <int HD, int KBQ, int HS, int BK>
cudaError_t launch_bwd_mma(const Args& a) {
  cudaError_t e = launch_dot<bf16>(a);
  if (e != cudaSuccess) return e;
  if ((e = launch_dkdv_mma<HD, KBQ, HS>(a)) != cudaSuccess) return e;
  return launch_dq_mma<HD, BK>(a);
}

// f32, CUDA cores: hd <= 128 takes 64 x 64 tiles, 8 accumulator columns a
// thread; hd <= 256 takes 32 x 32 tiles, 16 columns (the backward's four
// staged tiles fit in 227 KB).
cudaError_t dispatch_f32(const Args& a, bool bwd) {
  if (a.s.hd <= 128)
    return bwd ? launch_bwd<float, 64, 64, 8>(a)
               : launch_fwd<float, 64, 64, 8>(a);
  return bwd ? launch_bwd<float, 32, 32, 16>(a)
             : launch_fwd<float, 32, 32, 16>(a);
}

// bf16, tensor cores: head_dim tiles of 64, 80, 128 and 256.  Forward and
// dQ: 4 warps of 16 query rows, kv tiles of 64 keys (32 at 256); dK/dV: 4
// warps of 16 keys, q tiles of 64 rows (32 at 256, with head_dim split
// between two warps for registers).  `tools/k3_tune.py` times the others.
cudaError_t dispatch_bf16(const Args& a, bool bwd) {
  if (a.s.hd <= 64)
    return bwd ? launch_bwd_mma<64, 64, 1, 64>(a) : launch_fwd_mma<64, 64>(a);
  if (a.s.hd <= 80)
    return bwd ? launch_bwd_mma<80, 64, 1, 64>(a) : launch_fwd_mma<80, 64>(a);
  if (a.s.hd <= 128)
    return bwd ? launch_bwd_mma<128, 64, 1, 64>(a)
               : launch_fwd_mma<128, 64>(a);
  return bwd ? launch_bwd_mma<256, 32, 2, 32>(a) : launch_fwd_mma<256, 32>(a);
}

bool bad_shape(int BH, int BKV, int Sq, int Skv, int hd, int q_offset) {
  return BH < 0 || BH > 65535 || BKV <= 0 || BH % BKV != 0 || Sq < 0 ||
         Skv <= 0 || hd <= 0 || hd > 256 || hd % 8 != 0 || q_offset < 0;
}

Shape make_shape(int BH, int BKV, int Sq, int Skv, int hd, int causal,
                 int q_offset) {
  return Shape{Sq,      Skv,      hd,
               causal ? 1 : 0, q_offset, BH / BKV,
               (float)(1.0 / sqrt((double)hd))};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and o are (BH, Sq, hd), k and v
// (BKV, Skv, hd) with BKV dividing BH (query head bh reads KV head
// bh / (BH / BKV)); bf16 pointers must be 16-byte aligned.  Each returns
// the cudaError_t of its launches (0 = success); the kernels run
// asynchronously on `stream`.

// o (BH, Sq, hd) in the input dtype, lse (BH, Sq) f32.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int BH, int BKV, int Sq, int Skv,
                                         int hd, int causal, int q_offset,
                                         int dtype, void* stream) {
  if (bad_shape(BH, BKV, Sq, Skv, hd, q_offset))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse = lse; a.BH = BH; a.BKV = BKV;
  a.s = make_shape(BH, BKV, Sq, Skv, hd, causal, q_offset);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_f32(a, false);
  if (dtype == 1) return (int)dispatch_bf16(a, false);
  return (int)cudaErrorInvalidValue;
}

// dq (BH, Sq, hd), dk and dv (BKV, Skv, hd) in the input dtype; D is
// scratch of BH * Sq floats.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         void* D, int BH, int BKV, int Sq,
                                         int Skv, int hd, int causal,
                                         int q_offset, int dtype,
                                         void* stream) {
  if (bad_shape(BH, BKV, Sq, Skv, hd, q_offset))
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  if (Sq == 0) {  // no query: every key's gradient is zero
    const size_t n = (size_t)BKV * Skv * hd * (dtype == 0 ? 4 : 2);
    cudaError_t e = cudaMemsetAsync(dk, 0, n, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemsetAsync(dv, 0, n, static_cast<cudaStream_t>(stream));
  }
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = const_cast<void*>(lse);
  a.dq = dq; a.dk = dk; a.dv = dv; a.D = D; a.BH = BH; a.BKV = BKV;
  a.s = make_shape(BH, BKV, Sq, Skv, hd, causal, q_offset);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_f32(a, true);
  if (dtype == 1) return (int)dispatch_bf16(a, true);
  return (int)cudaErrorInvalidValue;
}
