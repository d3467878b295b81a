// Flash attention for Hopper (sm_90a), CUDA C++: forward and backward.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`), reached from
// `ops.flash_attention`.  Same contract: q (BH, Sq, hd), k and v (BH, Skv,
// hd), all contiguous; scale 1/sqrt(hd); with `causal`, query row i (at
// absolute position q_offset + i) sees key j iff q_offset + i >= j.  The
// forward writes o (BH, Sq, hd) in q's dtype and the per-row log-sum-exp
// lse (BH, Sq) in f32 (scaled scores), which the backward reuses.  The TPU
// kernel has no backward; this file adds one (FlashAttention-2's recompute):
//   D = rowsum(dO * O);  P = exp(S * scale - lse);  dV = P^T dO;
//   dP = dO V^T;  dS = P * (dP - D);  dK = scale dS^T Q;  dQ = scale dS K.
//
// What differs from the TPU kernel, and why.  Its grid walks the kv blocks
// in order and carries (m, l, acc) in scratch between grid steps; here one
// thread block owns a tile of BQ query rows of one (batch, head) and walks
// the kv tiles in a loop, keeping m, l and acc in registers.  Any Sq and
// Skv are taken: ragged tails are masked (the TPU kernel asserts that its
// block sizes divide both).  Tiles past the causal horizon are never read,
// as the TPU kernel's `pl.when` skips them.  Every intermediate is f32;
// bf16 inputs are widened as they are staged, and P stays f32 for the PV
// product.
//
// Layout of the work.  A block has 256 threads as a 16 x 16 grid (tx, ty).
// Each thread computes a (BQ/16) x (BK/16) micro-tile of the score tile,
// rows ty + 16 i and keys tx + 16 j, from Q and K tiles staged in shared
// memory (row stride hd + 1, so the 16 rows one warp reads at one column
// fall in 16 banks).  The row max and sum are reduced over the 16 lanes of
// a half-warp with shuffles.  Products against hd-wide tiles (PV, dV, dK,
// dQ) give each thread rows (or keys) ty + 16 i and columns tx + 16 j of the
// accumulator.  hd <= 128 takes 64 x 64 tiles, hd <= 256 takes 32 x 32
// (shared memory: the backward stages four hd-wide tiles).
//
// The backward runs three kernels: D (one warp a row); dK and dV (one block
// per kv tile, looping over the q tiles that see it); dQ (one block per q
// tile, looping over kv tiles).  Each output element is summed by one
// thread in a fixed order: no float atomics, so the backward is bitwise
// deterministic from run to run (checkpoint/restart replays the same
// losses, and rematerialisation does not change a gradient).
//
// Bound on the H100: at the training shape (BH 128, S 512, hd 128, bf16)
// the forward moves about 67 MB (q, k, v, o) for 8.6 GFLOP causal, and the
// backward about 134 MB for 2.5x the flops, so both sit under the card's
// bf16 flops/byte balance point (bound by bytes at the tensor-core rate).
// This design does its products on the CUDA cores in f32 (no wgmma, no TMA,
// no double buffering; the shared-memory reads of the micro-tiles limit it
// before the FMA units do), so it is far from that bound; wgmma tiles in
// bf16, TMA loads of K/V with a producer warp, reading KV head h / group
// without the repeat, and a fused dK/dV/dQ backward are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
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
  int Sq, Skv, hd, causal, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible(int r, int c, const Shape& s) {
  return r < s.Sq && c < s.Skv && (!s.causal || c <= s.q_offset + r);
}

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

// The causal horizon of a q tile: keys [0, end) can be visible to its rows.
__device__ __forceinline__ int kv_end(int q0, int BQ, const Shape& s) {
  return s.causal ? min(s.Skv, s.q_offset + min(q0 + BQ, s.Sq)) : s.Skv;
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, bh).
// ---------------------------------------------------------------------------
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
  const size_t qb = (size_t)bh * s.Sq * s.hd, kb = (size_t)bh * s.Skv * s.hd;

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

// ---------------------------------------------------------------------------
// Backward 1: D = rowsum(dO * O), one warp per row.
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// Backward 2: dK and dV, one block per (kv tile, bh).
// ---------------------------------------------------------------------------
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
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qb = (size_t)bh * s.Sq * s.hd, kb = (size_t)bh * s.Skv * s.hd;
  const size_t rb = (size_t)bh * s.Sq;

  load_tile<T, BK>(k_s, ld, k + kb, k0, s.Skv, s.hd);
  load_tile<T, BK>(v_s, ld, v + kb, k0, s.Skv, s.hd);
  float dk_acc[RK][DC], dv_acc[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the first q tile with a row that sees key k0
  const int first = s.causal ? max(0, k0 - s.q_offset) / BQ * BQ : 0;
  for (int q0 = first; q0 < s.Sq; q0 += BQ) {
    __syncthreads();
    load_tile<T, BQ>(q_s, ld, q + qb, q0, s.Sq, s.hd);
    load_tile<T, BQ>(do_s, ld, dout + qb, q0, s.Sq, s.hd);
    __syncthreads();
    probs_and_ds<RQ, RK>(q_s, do_s, k_s, v_s, p_s, ds_s, ld, pld, lse, D, rb,
                         q0, k0, s, tx, ty);
    __syncthreads();
    acc_tile<true, RK, DC>(dv_acc, p_s, pld, do_s, ld, BQ, s.hd, tx, ty);
    acc_tile<true, RK, DC>(dk_acc, ds_s, pld, q_s, ld, BQ, s.hd, tx, ty);
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

// ---------------------------------------------------------------------------
// Backward 3: dQ, one block per (q tile, bh).
// ---------------------------------------------------------------------------
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
  const size_t qb = (size_t)bh * s.Sq * s.hd, kb = (size_t)bh * s.Skv * s.hd;
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

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *lse, *dq, *dk, *dv, *D;
  int BH;
  Shape s;
  cudaStream_t stream;
};

// Raise a kernel's dynamic shared-memory limit to `smem` the first time a
// launch needs more than the last setting (`allowed` is the call site's
// own), so launches captured in a CUDA graph make no attribute call.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem, size_t& allowed) {
  if (smem <= 48 * 1024 || smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

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

template <typename T, int BQ, int BK, int DC>
cudaError_t launch_bwd(const Args& a) {
  const int ld = a.s.hd + 1;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* D = static_cast<float*>(a.D);
  const long rows = (long)a.BH * a.s.Sq;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows * 32 + THREADS - 1) / THREADS),
                            THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), dout, D, rows, a.s.hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_kv =
      (size_t)((2 * BQ + 2 * BK) * ld + 2 * BQ * (BK + 1)) * 4;
  auto kv_kern = flash_bwd_dkdv_kernel<T, BQ, BK, DC>;
  static size_t kv_allowed = 0;
  if ((e = allow_smem(kv_kern, smem_kv, kv_allowed)) != cudaSuccess) return e;
  kv_kern<<<dim3((a.s.Skv + BK - 1) / BK, a.BH), THREADS, smem_kv,
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

// hd <= 128: 64 x 64 tiles, 8 accumulator columns a thread; hd <= 256:
// 32 x 32 tiles, 16 columns (the backward's four staged tiles fit in 227 KB)
template <typename T>
cudaError_t dispatch(const Args& a, bool bwd) {
  if (a.s.hd <= 128)
    return bwd ? launch_bwd<T, 64, 64, 8>(a) : launch_fwd<T, 64, 64, 8>(a);
  return bwd ? launch_bwd<T, 32, 32, 16>(a) : launch_fwd<T, 32, 32, 16>(a);
}

bool bad_shape(int BH, int Sq, int Skv, int hd, int q_offset) {
  return BH < 0 || BH > 65535 || Sq < 0 || Skv <= 0 || hd <= 0 || hd > 256 ||
         hd % 8 != 0 || q_offset < 0;
}

Shape make_shape(int Sq, int Skv, int hd, int causal, int q_offset) {
  return Shape{Sq, Skv, hd, causal ? 1 : 0, q_offset,
               (float)(1.0 / sqrt((double)hd))};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launches (0 = success); the kernels run asynchronously on `stream`.

// o (BH, Sq, hd) in the input dtype, lse (BH, Sq) f32.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int BH, int Sq, int Skv, int hd,
                                         int causal, int q_offset, int dtype,
                                         void* stream) {
  if (bad_shape(BH, Sq, Skv, hd, q_offset)) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse = lse; a.BH = BH;
  a.s = make_shape(Sq, Skv, hd, causal, q_offset);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, false);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, false);
  return (int)cudaErrorInvalidValue;
}

// dq (BH, Sq, hd), dk and dv (BH, Skv, hd) in the input dtype; D is scratch
// of BH * Sq floats.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         void* D, int BH, int Sq, int Skv,
                                         int hd, int causal, int q_offset,
                                         int dtype, void* stream) {
  if (bad_shape(BH, Sq, Skv, hd, q_offset)) return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  if (Sq == 0) {  // no query: every key's gradient is zero
    const size_t n = (size_t)BH * Skv * hd * (dtype == 0 ? 4 : 2);
    cudaError_t e = cudaMemsetAsync(dk, 0, n, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemsetAsync(dv, 0, n, static_cast<cudaStream_t>(stream));
  }
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = const_cast<void*>(lse);
  a.dq = dq; a.dk = dk; a.dv = dv; a.D = D; a.BH = BH;
  a.s = make_shape(Sq, Skv, hd, causal, q_offset);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, true);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, true);
  return (int)cudaErrorInvalidValue;
}
