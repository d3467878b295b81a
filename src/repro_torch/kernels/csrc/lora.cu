// Segmented LoRA shrink (K5) and expand (K6) for Hopper (sm_90a), CUDA C++.
//
// Replace the Pallas TPU kernels `lora_shrink_kernel` and
// `lora_expand_kernel` in src/repro/kernels/lora.py, reached from
// `ops.lora_shrink` / `ops.lora_expand`, which `models.lora.delta` calls for
// every adapted projection of every layer of a serve dispatch that holds an
// adapter row.  Every row t of a batch applies its own adapter, picked from
// a slab of S slots by idx[t]; rows with idx[t] < 0 (base rows) come out as
// exact zeros, written as such, never a product with zero.
//
//   shrink: h (T, R) f32  = x (T, d) @ A[idx[t]] (d, R)
//   expand: y (T, O)      = h (T, R) @ B[idx[t]] (R, O), f32 sums written
//                           in the slab's dtype
//
// x and A share a dtype, as do B and y: float32 or bfloat16.  Layouts are
// contiguous row-major: A (S, d, R), B (S, R, O).  R is a multiple of 8 up
// to MAX_RANK.  A slot index at or past S makes its row NaN (the indices
// live on the card, so the wrapper cannot check them without a sync).
//
// Design.  The TPU kernels walk one row per sequential grid step with the
// slot index scalar-prefetched to select the weight tile to copy in; here
// each block reads its own row's index.
//   shrink: one block of 256 threads per row.  The threads split d: thread j
//     takes k = j, j + 256, ..., reads x[t, k] and the R contiguous values
//     A[slot, k, :] in 16-byte loads, and keeps R f32 partial sums in
//     registers.  A warp-shuffle reduction and then a sum over the 8 warps'
//     partials in shared memory, in a fixed order, give h[t, :].
//   expand: grid (T, ceil(O / block_out)), 128 threads a block; block (t, j)
//     stages h[t, :] in shared memory and covers output columns
//     [j * block_out, min((j + 1) * block_out, O)), one column per thread at
//     a time, reading B[slot, r, o] coalesced along o.  Each column is one
//     f32 chain of fmaf over r = 0..R-1, so the result is bitwise the same
//     for every block_out.  The ragged last tile is masked, not padded.
//
// Bound on the H100 (data sheet: 3.35 TB/s).  At the serve shapes
// (T = 8 decode rows or a 256-row prefill chunk, d and O in {1024, 2048,
// 3072}, R = 16, bf16) the work is bytes: one (d, R) or (R, O) factor per
// distinct adapter in the batch, plus x, h and y.  A decode shrink at
// d = 1024 moves 16 KB of x and 32 KB per adapter, some 0.05 us; 2*T*d*R
// flops are nothing beside that.  So almost every dispatch is bound by
// launch latency (a few us), far above either bound; 392 of these
// launches ride each adapter-holding decode step or prefill chunk of a
// 28-layer model.  What this first design does about it: one launch per
// projection and kernel, no scratch and no host sync.  What it leaves on the
// table: rows that share an adapter each reread its factor (from L2), the
// 256-row prefill chunk runs on the CUDA cores instead of tensor-core tiles,
// shrink and expand are two launches, and nothing is captured in a CUDA
// graph; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_RANK = 64;
constexpr int SHRINK_THREADS = 256;
constexpr int SHRINK_WARPS = SHRINK_THREADS / 32;
constexpr int EXPAND_THREADS = 128;

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

// Eight consecutive values from a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(SHRINK_THREADS)
lora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const int* __restrict__ idx, float* __restrict__ h, int d,
                   int S) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int slot = idx[t];
  float* hr = h + (size_t)t * R;
  if (slot < 0 || slot >= S) {
    const float fill = slot < 0 ? 0.f : __int_as_float(0x7fc00000);
    for (int r = tid; r < R; r += SHRINK_THREADS) hr[r] = fill;
    return;
  }
  const T* xr = x + (size_t)t * d;
  const T* as = a + (size_t)slot * d * R;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int k = tid; k < d; k += SHRINK_THREADS) {
    const float xv = to_f32(xr[k]);
    const T* ar = as + (size_t)k * R;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += 8) {
      float v[8];
      load8(ar + r0, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r0 + i] = fmaf(xv, v[i], acc[r0 + i]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  __shared__ float part[SHRINK_WARPS][R];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[warp][r] = acc[r];
  }
  __syncthreads();
  for (int r = tid; r < R; r += SHRINK_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SHRINK_WARPS; ++w) s += part[w][r];
    hr[r] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(EXPAND_THREADS)
lora_expand_kernel(const float* __restrict__ h, const T* __restrict__ b,
                   const int* __restrict__ idx, T* __restrict__ y, int R,
                   int O, int block_out, int S) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * block_out;
  const int o1 = min(o0 + block_out, O);
  const int slot = idx[t];
  T* yr = y + (size_t)t * O;
  if (slot < 0 || slot >= S) {
    const T fill = from_f32<T>(slot < 0 ? 0.f : __int_as_float(0x7fc00000));
    for (int o = o0 + tid; o < o1; o += EXPAND_THREADS) yr[o] = fill;
    return;
  }
  __shared__ float hs[MAX_RANK];
  for (int r = tid; r < R; r += EXPAND_THREADS) hs[r] = h[(size_t)t * R + r];
  __syncthreads();
  const T* bs = b + (size_t)slot * R * O;
  for (int o = o0 + tid; o < o1; o += EXPAND_THREADS) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r)
      acc = fmaf(hs[r], to_f32(bs[(size_t)r * O + o]), acc);
    yr[o] = from_f32<T>(acc);
  }
}

template <typename T, int R>
cudaError_t launch_shrink(const void* x, const void* a, const void* idx,
                          void* h, int T_, int d, int S, cudaStream_t stream) {
  lora_shrink_kernel<T, R><<<T_, SHRINK_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const int*>(idx), static_cast<float*>(h), d, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t shrink_rank(const void* x, const void* a, const void* idx,
                        void* h, int T_, int d, int R, int S,
                        cudaStream_t s) {
  switch (R) {
    case 8: return launch_shrink<T, 8>(x, a, idx, h, T_, d, S, s);
    case 16: return launch_shrink<T, 16>(x, a, idx, h, T_, d, S, s);
    case 24: return launch_shrink<T, 24>(x, a, idx, h, T_, d, S, s);
    case 32: return launch_shrink<T, 32>(x, a, idx, h, T_, d, S, s);
    case 40: return launch_shrink<T, 40>(x, a, idx, h, T_, d, S, s);
    case 48: return launch_shrink<T, 48>(x, a, idx, h, T_, d, S, s);
    case 56: return launch_shrink<T, 56>(x, a, idx, h, T_, d, S, s);
    case 64: return launch_shrink<T, 64>(x, a, idx, h, T_, d, S, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_expand(const void* h, const void* b, const void* idx,
                          void* y, int T_, int R, int O, int block_out, int S,
                          cudaStream_t stream) {
  const dim3 grid(T_, (O + block_out - 1) / block_out);
  lora_expand_kernel<T><<<grid, EXPAND_THREADS, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const T*>(b),
      static_cast<const int*>(idx), static_cast<T*>(y), R, O, block_out, S);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and A).  h is float32.  Returns the
// launch's cudaError_t (0 = success); the kernel runs asynchronously on
// `stream`.
extern "C" int repro_lora_shrink(const void* x, const void* a,
                                 const void* idx, void* h, int T, int d,
                                 int R, int S, int dtype, void* stream) {
  if (T < 0 || d < 0 || S < 1 || R < 8 || R > MAX_RANK || R % 8)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)shrink_rank<float>(x, a, idx, h, T, d, R, S, s);
  if (dtype == 1)
    return (int)shrink_rank<__nv_bfloat16>(x, a, idx, h, T, d, R, S, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (of B and y).  h is float32.
extern "C" int repro_lora_expand(const void* h, const void* b,
                                 const void* idx, void* y, int T, int R,
                                 int O, int block_out, int S, int dtype,
                                 void* stream) {
  if (T < 0 || O < 0 || S < 1 || R < 1 || R > MAX_RANK || block_out < 1 ||
      (O + block_out - 1) / block_out > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || O == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_expand<float>(h, b, idx, y, T, R, O, block_out, S, s);
  if (dtype == 1)
    return (int)launch_expand<__nv_bfloat16>(h, b, idx, y, T, R, O,
                                             block_out, S, s);
  return (int)cudaErrorInvalidValue;
}
