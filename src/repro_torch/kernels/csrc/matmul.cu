// Matrix product for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `matmul_kernel` in
// src/repro/kernels/matmul.py, reached from `ops.matmul`, which the
// compiler's codegen calls for every logical `matmul` of a compiled term.
// Same contract: c (M, N) = a (M, K) @ b (K, N) with an f32 accumulator,
// written in a's dtype (float32 or bfloat16; a and b share it).  float32 is
// full precision: plain f32 FMAs, never TF32.  Every shape is taken: ragged
// edges are masked, so M, N and K need not divide the tiles (the TPU
// kernel's divisibility assert came from its on-chip tiling, not from the
// function).
//
// Layouts: a, b and c contiguous row-major.
//
// Design: one thread block of 256 threads per BM x BN = 64 x 64 tile of c.
// The block walks K in steps of BK = 32: it stages the A tile (transposed,
// rows padded by one float so the transposing store is free of bank
// conflicts) and the B tile in shared memory as f32, coalesced along K and
// N respectively, then each thread accumulates a 4 x 4 sub-tile of c in
// registers with CUDA-core FMAs.  Thread (tx, ty) owns rows ty + 16 i and
// columns tx + 16 j, so a warp's shared-memory reads of B are 16
// consecutive words and of A two broadcast words.  Out-of-range elements
// load as 0 and are not stored.
//
// Bound on the H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s
// bf16 on the tensor cores):
//   decode term, (1,128)@(128,2048) in bf16: 528,640 bytes to move against
//     524,288 flops -- bytes, 0.158 us;
//   MLP, (256,1024)@(1024,3072) in f32: 1.61e9 flops against 16.8 MB --
//     operations, 24.0 us.
// What this simple design leaves on the table: no tensor cores (bf16 runs
// on the CUDA cores at the f32 rate), no cp.async/TMA pipelining (each k
// step loads, synchronises, then computes), and a one-row product (decode)
// fills one of the 64 rows of every tile and launches N / 64 blocks, two at
// N = 128, each walking all of K.  wgmma/TMA tiles and split-K are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;            // rows of c per block
constexpr int BN = 64;            // columns of c per block
constexpr int BK = 32;            // depth of one k step
constexpr int TDIM = 16;          // threads per block side
constexpr int TM = BM / TDIM;     // rows per thread
constexpr int TN = BN / TDIM;     // columns per thread
constexpr int THREADS = TDIM * TDIM;
static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0,
              "tile loads split evenly over the threads");

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int M, int N, int K) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TDIM;
  const int ty = tid / TDIM;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f32(a[(size_t)gr * K + gk]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < K && gc < N) ? to_f32(b[(size_t)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], br[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ar[i] = As[kk][ty + TDIM * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) br[j] = Bs[kk][tx + TDIM * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + TDIM * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + TDIM * j;
      if (gc < N) c[(size_t)gr * N + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = success); the kernel runs asynchronously on `stream`.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, b, c, M, N, K, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, b, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
