// Paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` in
// src/repro/kernels/paged_attention.py (body `_paged_kernel`), reached from
// `ops.paged_attention` (decode) and `ops.paged_attention_chunk` (chunked
// prefill).  Same contract: for each batch row b and KV head, R query rows
// attend over b's paged span; key position kpos counts iff
// kpos <= q_pos[b, row] and kpos < kv_lens[b].  Online softmax with f32
// running max / sum / accumulator, scale 1/sqrt(hd), masked score -1e30,
// p rounded to v's dtype before the PV product, l floored at 1e-30, output
// in q's dtype.
//
// Layouts (all contiguous): q and out (B, KV, R, hd); k_pages and v_pages
// (N, bs, KV, hd), the pool's own layout, so page p of head h starts at
// ((p * bs) * KV + h) * hd with a row stride of KV * hd; block_tables (B, M)
// int32; q_pos (B, R) int32; kv_lens (B,) int32 >= 1.
//
// Design: one thread block per (tile of TR query rows, KV head, batch row).
// Each block reads its own block-table entries (the TPU kernel had them
// scalar-prefetched) and walks the span in tiles of KT = 32 key positions;
// a tile may straddle pages, so `bs` need not be a power of two nor divide
// the span.  Tiles stop at min(kv_len, M * bs, max q_pos + 1): pages past
// ceil(kv_len / bs) -- including the null-padded table tail -- are never
// read, and neither are positions every row of the tile masks causally.
// K and V of a tile are staged in shared memory as f32 (K rows padded by one
// float so lane t reading row t is free of bank conflicts); each warp owns
// RPW query rows, lane t scores key t of the tile, and the warp folds the
// tile into its rows' running softmax held in registers.
//
// Bound on the H100: bytes.  Decode reads every live K/V position of a row
// once per KV head for 4 * group * hd flops per position, far below the
// card's ~295 flops/byte balance point; a prefill chunk of C tokens reuses
// each position for 2 * C * group rows and comes closer.
// What this simple design leaves on the table: no tensor cores (scores and
// PV are CUDA-core FMAs), no TMA or cp.async pipelining of page loads, no
// split of the span across blocks -- a decode step at B = 8 with 8 KV heads
// launches only 64 blocks for 132 SMs -- and every row tile of a prefill
// chunk re-reads the span from L2.  wgmma/TMA and split-KV are later work.
//
// `pages_per_fetch` (the TPU kernel's DMA grouping knob) is accepted by the
// Python wrapper for signature parity and not used here: the tile walk
// above replaces the TPU's per-grid-step page fetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KT = 32;            // key positions per tile, one per lane
constexpr int WARPS = 4;          // warps per block
constexpr int RPW = 2;            // query rows per warp
constexpr int TR = WARPS * RPW;   // query rows per block
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// DC = ceil(hd / 32): head dims owned by each lane in the PV accumulator.
template <typename T, int DC>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_lens, T* __restrict__ out,
                       int KV, int R, int hd, int bs, int M, float scale) {
  extern __shared__ float smem[];
  const int ks = hd + 1;                 // padded K row stride
  float* k_s = smem;                     // [KT][hd + 1]
  float* v_s = k_s + KT * ks;            // [KT][hd]
  float* q_s = v_s + KT * hd;            // [TR][hd]

  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_len = kv_lens[b];
  const int* table = block_tables + (size_t)b * M;
  const size_t q_base = ((size_t)b * KV + h) * R;

  for (int i = threadIdx.x; i < TR * hd; i += blockDim.x) {
    const int r = row0 + i / hd;
    q_s[i] = r < R ? to_f32(q[(q_base + r) * hd + i % hd]) : 0.f;
  }
  int horizon = 0;                       // 1 + the largest q_pos of the tile
  for (int r = row0; r < min(row0 + TR, R); ++r)
    horizon = max(horizon, q_pos[(size_t)b * R + r] + 1);
  const int span = min(min(kv_len, M * bs), horizon);

  int qp[RPW];
  float m[RPW], l[RPW], acc[RPW][DC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = row0 + warp * RPW + rr;
    qp[rr] = r < R ? q_pos[(size_t)b * R + r] : -1;
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[rr][c] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KV * hd;
  for (int t0 = 0; t0 < span; t0 += KT) {
    // stage K and V of positions t0 .. t0 + KT - 1; dead positions read 0
    for (int t = warp; t < KT; t += WARPS) {
      const int kpos = t0 + t;
      const bool live = kpos < span;
      const size_t base =
          live ? ((size_t)table[kpos / bs] * bs + kpos % bs) * row_stride +
                     (size_t)h * hd
               : 0;
      for (int d = lane; d < hd; d += 32) {
        k_s[t * ks + d] = live ? to_f32(k_pages[base + d]) : 0.f;
        v_s[t * hd + d] = live ? to_f32(v_pages[base + d]) : 0.f;
      }
    }
    __syncthreads();

    const int kpos = t0 + lane;
    const float* k_row = k_s + lane * ks;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float* q_row = q_s + (warp * RPW + rr) * hd;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(q_row[d], k_row[d], s);
      s *= scale;
      if (!(kpos < span && kpos <= qp[rr])) s = NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      const float p_v = to_f32(from_f32<T>(p));   // p in v's dtype
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[rr][c] *= alpha;
      for (int t = 0; t < KT; ++t) {
        const float pt = __shfl_sync(FULL, p_v, t);
        const float* v_row = v_s + t * hd;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[rr][c] = fmaf(pt, v_row[d], acc[rr][c]);
        }
      }
      m[rr] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = row0 + warp * RPW + rr;
    if (r >= R) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* o = out + (q_base + r) * hd;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[d] = from_f32<T>(acc[rr][c] / denom);
    }
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *block_tables, *q_pos, *kv_lens;
  void* out;
  int B, KV, R, hd, bs, M;
  cudaStream_t stream;
};

template <typename T, int DC>
cudaError_t launch(const Args& a) {
  const dim3 grid((a.R + TR - 1) / TR, a.KV, a.B);
  const size_t smem =
      (size_t)(KT * (a.hd + 1) + KT * a.hd + TR * a.hd) * sizeof(float);
  auto kern = paged_attention_kernel<T, DC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = (float)(1.0 / sqrt((double)a.hd));
  kern<<<grid, WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages),
      static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_lens),
      static_cast<T*>(a.out), a.KV, a.R, a.hd, a.bs, a.M, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 3: return launch<T, 3>(a);
    case 4: return launch<T, 4>(a);
    case 5: return launch<T, 5>(a);
    case 6: return launch<T, 6>(a);
    case 7: return launch<T, 7>(a);
    case 8: return launch<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = success); the kernel runs asynchronously on `stream`.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_tables,
                                     const void* q_pos, const void* kv_lens,
                                     void* out, int B, int KV, int R, int hd,
                                     int bs, int M, int dtype, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || bs <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KV == 0 || R == 0) return 0;
  const Args a{q,  k_pages, v_pages, block_tables, q_pos, kv_lens, out,
               B,  KV,      R,       hd,           bs,    M,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
