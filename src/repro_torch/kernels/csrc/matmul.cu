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
// Three kernels, chosen by dtype and M (`plan`):
// - bf16, M >= 16: a tiled GEMM on the tensor cores, `mma.sync.m16n8k16`
//   (bf16 in, f32 accumulate).  A block of 4 warps owns a 64 x 128 tile of
//   c, each warp 64 x 32 (4 x 4 accumulator fragments).  A and B tiles, 64
//   deep, arrive through a 3-stage `cp.async` ring of 16-byte copies
//   (zero-filled past the ragged edges) and are read with `ldmatrix`, B
//   through `.trans` since it is row-major; rows are padded by 16 bytes so
//   no `ldmatrix` phase conflicts.  `wgmma` with TMA would raise the
//   ceiling further; `mma.sync` reuses the fragment maps that K3 proved on
//   the card (sm90_mma.cuh), and the shapes on the compile path are small
//   enough that filling the card (split-K below) matters more than the
//   instruction's peak.
// - f32, M >= 16: CUDA cores (tensor cores would be TF32).  128 threads own
//   a 128 x 64 tile, 8 x 8 outputs a thread (128 x 32 and 8 x 4 where K is
//   short and the wide tiles too few), k steps of 16: the next step's
//   A and B are loaded as float4 into registers while the current one is
//   multiplied out of shared memory, then stored into the other half of a
//   double buffer (A transposed on the way, which `cp.async` cannot do).
// - M < 16 (the decode terms' one-row products), both dtypes: split-K on
//   the CUDA cores.  These products are bound by bytes (b is read once for
//   almost no reuse), so the design is about spreading b's rows over the
//   card: a block of 256 threads owns a strip of 128 (bf16) or 64 (f32)
//   columns and one slice of K; 16 threads cover a row of the strip with
//   16-byte loads, coalesced along N, and 16 such groups walk the slice's
//   rows; the groups' sums meet in shared memory in a fixed order.
//
// Split-K.  Where the M x N tiles alone would leave the card idle, K is cut
// into `split` slices of equal length (whole k steps); each slice's block
// writes its f32 partial tile to a workspace (split, M, N) that the caller
// allocates, and a second kernel sums the partials in split order and
// casts to a's dtype.  No atomics, and `split` depends only on (M, N, K,
// dtype), so two launches give the same bits.  Each split writes and reads
// back an f32 partial of c, so the tensor-core GEMM splits only where its
// tiles leave more than half of the 132 SMs idle (then to one wave); the
// f32 GEMM to two waves of its smaller blocks; the skinny products, whose
// partials are a few rows, to two waves, so that (1, 2048) @ (2048, 128)
// runs 64 blocks.
//
// Alignment.  16-byte copies need K and N to be multiples of 8 (bf16) or 4
// (f32) and 16-byte-aligned pointers; other shapes take the same kernels
// with element loads (`VEC` false), correct and slower.
//
// Bound on the H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s
// bf16 on the tensor cores):
//   decode term, (1,2048)@(2048,128) in bf16: 528,640 bytes to move against
//     524,288 flops -- bytes, 0.158 us;
//   MLP, (256,1024)@(1024,3072) in bf16: 8.4 MB against 1.61e9 flops --
//     bytes 2.5 us, operations 1.6 us; in f32, operations, 24.0 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_mma.cuh"

namespace {

constexpr int NUM_SMS = 132;      // H100 SXM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// bf16, M >= 16: tensor cores
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64, TC_BN = 128, TC_BK = 64, TC_STAGES = 3;
constexpr int TC_WM = 64, TC_MI = TC_WM / 16;   // a warp's rows, m16 tiles
constexpr int TC_THREADS = 128;   // 4 warps along N, 64 x 32 each
constexpr int TC_LDA = TC_BK + 8, TC_LDB = TC_BN + 8;
constexpr size_t TC_SMEM =
    (size_t)TC_STAGES * (TC_BM * TC_LDA + TC_BK * TC_LDB) * sizeof(bf16);

// A rows [m0, m0 + 64) and B rows [k0, k0 + 32) of the block's columns
// into one stage; elements at or past M, N or k_end read 0.
template <bool VEC>
__device__ __forceinline__ void tc_load(bf16* as, bf16* bs,
                                        const bf16* __restrict__ a,
                                        const bf16* __restrict__ b, int M,
                                        int N, int K, int m0, int n0, int k0,
                                        int k_end) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int s = 0; s < TC_BM * TC_BK / 8 / TC_THREADS; ++s) {
      const int i = tid + s * TC_THREADS;
      const int r = i / (TC_BK / 8), cc = (i % (TC_BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + cc < k_end;
      cp_async16(as + r * TC_LDA + cc,
                 ok ? a + (size_t)(m0 + r) * K + k0 + cc : a, ok ? 16 : 0);
    }
#pragma unroll
    for (int s = 0; s < TC_BK * TC_BN / 8 / TC_THREADS; ++s) {
      const int i = tid + s * TC_THREADS;
      const int r = i / (TC_BN / 8), cc = (i % (TC_BN / 8)) * 8;
      const bool ok = k0 + r < k_end && n0 + cc < N;
      cp_async16(bs + r * TC_LDB + cc,
                 ok ? b + (size_t)(k0 + r) * N + n0 + cc : b, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < TC_BM * TC_BK; i += TC_THREADS) {
      const int r = i / TC_BK, cc = i % TC_BK;
      const bool ok = m0 + r < M && k0 + cc < k_end;
      as[r * TC_LDA + cc] = ok ? a[(size_t)(m0 + r) * K + k0 + cc] : zero;
    }
    for (int i = tid; i < TC_BK * TC_BN; i += TC_THREADS) {
      const int r = i / TC_BN, cc = i % TC_BN;
      const bool ok = k0 + r < k_end && n0 + cc < N;
      bs[r * TC_LDB + cc] = ok ? b[(size_t)(k0 + r) * N + n0 + cc] : zero;
    }
  }
}

// One block per (64 x 128 tile of c, K slice z).  With gridDim.z == 1 the
// tile goes to c in bf16, else its f32 partial to ws[z].
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
mm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             bf16* __restrict__ c, float* __restrict__ ws, int M, int N,
             int K, int kslice) {
  extern __shared__ __align__(16) unsigned char mm_smem[];
  bf16* as = reinterpret_cast<bf16*>(mm_smem);      // [STAGES][BM][LDA]
  bf16* bs = as + TC_STAGES * TC_BM * TC_LDA;        // [STAGES][BK][LDB]
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int k_begin = blockIdx.z * kslice;
  const int k_end = min(K, k_begin + kslice);
  const int nkt = (k_end - k_begin + TC_BK - 1) / TC_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * TC_WM, wn = (warp % 4) * 32;

  float acc[TC_MI][4][4];
#pragma unroll
  for (int i = 0; i < TC_MI; ++i) zero_acc(acc[i]);

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nkt)
      tc_load<VEC>(as + s * TC_BM * TC_LDA, bs + s * TC_BK * TC_LDB, a, b, M,
                   N, K, m0, n0, k_begin + s * TC_BK, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile kt has landed; stage (kt - 1) is free
    const int nxt = kt + TC_STAGES - 1;
    if (nxt < nkt) {
      const int st = nxt % TC_STAGES;
      tc_load<VEC>(as + st * TC_BM * TC_LDA, bs + st * TC_BK * TC_LDB, a, b,
                   M, N, K, m0, n0, k_begin + nxt * TC_BK, k_end);
    }
    cp_async_commit();
    const bf16* at = as + (kt % TC_STAGES) * TC_BM * TC_LDA;
    const bf16* bt = bs + (kt % TC_STAGES) * TC_BK * TC_LDB;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t af[TC_MI][4];
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
        ldsm_x4(af[mi], at + (wm + mi * 16 + lane % 16) * TC_LDA + kk * 16 +
                            (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, bt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                TC_LDB +
                           wn + np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < TC_MI; ++mi) {
          mma16816(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma16816(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  const bool direct = gridDim.z == 1;
  float* part = ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + mi * 16 + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        const size_t o = (size_t)r * N + col;
        if (VEC && col < N) {   // N even: the pair is in range and aligned
          if (direct)
            *reinterpret_cast<__nv_bfloat162*>(c + o) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
        } else if (!VEC) {
          if (col < N) {
            if (direct) c[o] = __float2bfloat16(v0); else part[o] = v0;
          }
          if (col + 1 < N) {
            if (direct) c[o + 1] = __float2bfloat16(v1); else part[o + 1] = v1;
          }
        }
      }
    }
}

// ---------------------------------------------------------------------------
// f32, M >= 16: CUDA cores, register-blocked
// ---------------------------------------------------------------------------
constexpr int F_BM = 128, F_BK = 16, F_THREADS = 128;
constexpr int F_LDA = F_BM + 4;   // A stored transposed: [BK][BM + 4]
constexpr int F_NA = F_BM * F_BK / 4 / F_THREADS;   // A float4 a thread
constexpr int F_MIN_STEPS = 16;   // k steps a split slice, at least

// float4 of B a thread (the last may be idle)
template <int BN>
__host__ __device__ constexpr int f32_nb() {
  return (F_BK * BN / 4 + F_THREADS - 1) / F_THREADS;
}

// The thread's share of one k step: F_NA float4 of A (row i / 4, k quad
// (i % 4) * 4) and f32_nb float4 of B (row i / (BN / 4), column quad
// i % (BN / 4)), i = tid + s * 128.
template <int BN, bool VEC>
__device__ __forceinline__ void f32_fetch(float4 (&ra)[F_NA],
                                          float4 (&rb)[f32_nb<BN>()],
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int M,
                                          int N, int K, int m0, int n0,
                                          int k0, int k_end) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < F_NA; ++s) {
    const int i = tid + s * F_THREADS;
    const int r = m0 + i / (F_BK / 4), k = k0 + (i % (F_BK / 4)) * 4;
    if (VEC) {
      ra[s] = (r < M && k < k_end)
                  ? *reinterpret_cast<const float4*>(a + (size_t)r * K + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (r < M && k + j < k_end) ? a[(size_t)r * K + k + j] : 0.f;
      ra[s] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int s = 0; s < f32_nb<BN>(); ++s) {
    const int i = tid + s * F_THREADS;
    const int k = k0 + i / (BN / 4), col = n0 + (i % (BN / 4)) * 4;
    const bool in = i < F_BK * BN / 4 && k < k_end;
    if (VEC) {
      rb[s] = (in && col < N)
                  ? *reinterpret_cast<const float4*>(b + (size_t)k * N + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (in && col + j < N) ? b[(size_t)k * N + col + j] : 0.f;
      rb[s] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int BN>
__device__ __forceinline__ void f32_stash(float* as, float* bs,
                                          const float4 (&ra)[F_NA],
                                          const float4 (&rb)[f32_nb<BN>()]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < F_NA; ++s) {
    const int i = tid + s * F_THREADS;
    const int r = i / (F_BK / 4), k = (i % (F_BK / 4)) * 4;
    as[(k + 0) * F_LDA + r] = ra[s].x;
    as[(k + 1) * F_LDA + r] = ra[s].y;
    as[(k + 2) * F_LDA + r] = ra[s].z;
    as[(k + 3) * F_LDA + r] = ra[s].w;
  }
#pragma unroll
  for (int s = 0; s < f32_nb<BN>(); ++s) {
    const int i = tid + s * F_THREADS;
    if (i < F_BK * BN / 4)
      *reinterpret_cast<float4*>(bs + (i / (BN / 4)) * BN +
                                 (i % (BN / 4)) * 4) = rb[s];
  }
}

// One block per (128 x BN tile of c, K slice z), BN 64 or 32.  Thread
// (tx, ty) = (tid % 8, tid / 8) owns rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns h*32 + tx*4 + {0..3} for h < BN / 32: its float4 reads
// of a k step are conflict-free.
template <int BN, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
mm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, float* __restrict__ ws, int M, int N,
              int K, int kslice) {
  constexpr int CN = BN / 32;       // column groups of 4 a thread
  __shared__ __align__(16) float as[2][F_BK * F_LDA];
  __shared__ __align__(16) float bs[2][F_BK * BN];
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kslice;
  const int k_end = min(K, k_begin + kslice);
  const int nkt = (k_end - k_begin + F_BK - 1) / F_BK;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  float acc[8][4 * CN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CN; ++j) acc[i][j] = 0.f;

  float4 ra[F_NA], rb[f32_nb<BN>()];
  if (nkt > 0) {
    f32_fetch<BN, VEC>(ra, rb, a, b, M, N, K, m0, n0, k_begin, k_end);
    f32_stash<BN>(as[0], bs[0], ra, rb);
  }
  __syncthreads();
  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nkt)   // the next step's loads fly under this step's FMAs
      f32_fetch<BN, VEC>(ra, rb, a, b, M, N, K, m0, n0,
                         k_begin + (kt + 1) * F_BK, k_end);
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float* ak = as[st] + k * F_LDA;
      const float* bk = bs[st] + k * BN;
      const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + ty * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[4 * CN];
#pragma unroll
      for (int h = 0; h < CN; ++h) {
        const float4 b4 = *reinterpret_cast<const float4*>(bk + h * 32 +
                                                           tx * 4);
        bv[4 * h] = b4.x;
        bv[4 * h + 1] = b4.y;
        bv[4 * h + 2] = b4.z;
        bv[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * CN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nkt) f32_stash<BN>(as[st ^ 1], bs[st ^ 1], ra, rb);
    __syncthreads();
  }

  float* out = gridDim.z == 1 ? c : ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < CN; ++h) {
      const int col = n0 + h * 32 + tx * 4;
      float* o = out + (size_t)r * N + col;
      if (VEC) {
        if (col < N)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) o[j] = acc[i][4 * h + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// M < 16: split-K on the CUDA cores, 16-byte loads of b along N
// ---------------------------------------------------------------------------
constexpr int SK_THREADS = 256;
constexpr int SK_GROUPS = 16;     // row groups walking the slice

// One block per (column strip of 16 * V, K slice z); MT >= M rows of a.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(SK_THREADS)
mm_skinny_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ c, float* __restrict__ ws, int M, int N,
                 int K, int kslice) {
  constexpr int V = 16 / sizeof(T);          // columns a thread
  constexpr int SW = 16 * V;                 // columns a block
  __shared__ float red[SK_GROUPS][SW];
  const int cl = threadIdx.x % 16, rg = threadIdx.x / 16;
  const int col = blockIdx.x * SW + cl * V;
  const int k_begin = blockIdx.z * kslice;
  const int k_end = min(K, k_begin + kslice);

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;

  for (int k = k_begin + rg; k < k_end; k += SK_GROUPS) {
    float bv[V];
    if (VEC && col < N) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(b + (size_t)k * N + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) bv[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        bv[j] = col + j < N ? to_f32(b[(size_t)k * N + col + j]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
      const float av = to_f32(a[(size_t)m * K + k]);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[m][j] = fmaf(av, bv[j], acc[m][j]);
    }
  }

  // the 16 groups' sums of each row, added in group order
  const bool direct = gridDim.z == 1;
  float* part = ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < V; ++j) red[rg][cl * V + j] = acc[m][j];
    __syncthreads();
    if (threadIdx.x < SW) {
      float s = red[0][threadIdx.x];
#pragma unroll
      for (int gq = 1; gq < SK_GROUPS; ++gq) s += red[gq][threadIdx.x];
      const int n = blockIdx.x * SW + threadIdx.x;
      if (n < N) {
        if (direct) c[(size_t)m * N + n] = from_f32<T>(s);
        else part[(size_t)m * N + n] = s;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Split-K: the partials summed in split order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ c,
                     size_t mn, int split) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < split; ++z) s += ws[(size_t)z * mn + i];
    c[i] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// Plan and launch
// ---------------------------------------------------------------------------
enum Path { TC = 0, F32 = 1, SKINNY = 2 };

struct Plan {
  Path path;
  int tiles_m, tiles_n, split, kslice;
  int f32_bn;           // the f32 kernel's tile width, 64 or 32
};

// `split` slices of whole `unit`-deep steps, at least `min_units` each,
// enough that tiles * split reaches `target` blocks where K allows (no
// split for a target of 0).
void split_k(Plan& p, int K, int unit, int min_units, int target) {
  const int tiles = p.tiles_m * p.tiles_n;
  const int units = (K + unit - 1) / unit;
  int split = (target + tiles - 1) / tiles;
  split = std::max(1, std::min(split, units / min_units));
  const int per = std::max(1, (units + split - 1) / split);
  p.split = std::max(1, (units + per - 1) / per);
  p.kslice = per * unit;
}

Plan plan(int M, int N, int K, int dtype) {
  Plan p{};
  if (M < 16) {
    p.path = SKINNY;
    p.tiles_m = 1;
    p.tiles_n = (N + 16 * (dtype ? 8 : 4) - 1) / (16 * (dtype ? 8 : 4));
    split_k(p, K, SK_GROUPS, 2, 2 * NUM_SMS);
  } else if (dtype == 1) {
    // each split writes and reads back an f32 partial of c, so split only
    // where the tiles leave more than half of the SMs idle
    p.path = TC;
    p.tiles_m = (M + TC_BM - 1) / TC_BM;
    p.tiles_n = (N + TC_BN - 1) / TC_BN;
    split_k(p, K, TC_BK, 2,
            2 * p.tiles_m * p.tiles_n <= NUM_SMS ? NUM_SMS : 0);
  } else {
    // 128 x 64 tiles; 128 x 32 where those leave more than half of the SMs
    // idle and K is too short to split (a one-block-an-SM kernel cannot
    // hide its loads alone)
    p.path = F32;
    p.tiles_m = (M + F_BM - 1) / F_BM;
    p.f32_bn = 64;
    if (2 * p.tiles_m * ((N + 63) / 64) <= NUM_SMS &&
        K < 2 * F_MIN_STEPS * F_BK)
      p.f32_bn = 32;
    p.tiles_n = (N + p.f32_bn - 1) / p.f32_bn;
    split_k(p, K, F_BK, F_MIN_STEPS, 2 * NUM_SMS);
  }
  return p;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int MT>
cudaError_t launch_skinny(const Plan& p, const T* a, const T* b, T* c,
                          float* ws, int M, int N, int K, bool vec,
                          cudaStream_t s) {
  const dim3 grid(p.tiles_n, 1, p.split);
  if (vec)
    mm_skinny_kernel<T, MT, true><<<grid, SK_THREADS, 0, s>>>(a, b, c, ws, M,
                                                              N, K, p.kslice);
  else
    mm_skinny_kernel<T, MT, false><<<grid, SK_THREADS, 0, s>>>(a, b, c, ws, M,
                                                               N, K, p.kslice);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_skinny_rows(const Plan& p, const T* a, const T* b, T* c,
                               float* ws, int M, int N, int K, bool vec,
                               cudaStream_t s) {
  if (M <= 1) return launch_skinny<T, 1>(p, a, b, c, ws, M, N, K, vec, s);
  if (M <= 2) return launch_skinny<T, 2>(p, a, b, c, ws, M, N, K, vec, s);
  if (M <= 4) return launch_skinny<T, 4>(p, a, b, c, ws, M, N, K, vec, s);
  if (M <= 8) return launch_skinny<T, 8>(p, a, b, c, ws, M, N, K, vec, s);
  return launch_skinny<T, 16>(p, a, b, c, ws, M, N, K, vec, s);
}

template <typename T>
cudaError_t launch(const Plan& p, const void* av, const void* bv, void* cv,
                   void* wsv, int M, int N, int K, cudaStream_t s) {
  const T* a = static_cast<const T*>(av);
  const T* b = static_cast<const T*>(bv);
  T* c = static_cast<T*>(cv);
  float* ws = static_cast<float*>(wsv);
  const int vec_elems = 16 / (int)sizeof(T);
  cudaError_t e;
  if (p.path == SKINNY) {
    const bool vec = N % vec_elems == 0 && aligned16(b);
    e = launch_skinny_rows<T>(p, a, b, c, ws, M, N, K, vec, s);
  } else {
    const bool vec = K % vec_elems == 0 && N % vec_elems == 0 &&
                     aligned16(a) && aligned16(b) && aligned16(c);
    const dim3 grid(p.tiles_n, p.tiles_m, p.split);
    if constexpr (sizeof(T) == 2) {
      static size_t allowed_v = 0, allowed_s = 0;
      if (vec) {
        if ((e = allow_smem(mm_tc_kernel<true>, TC_SMEM, allowed_v)))
          return e;
        mm_tc_kernel<true><<<grid, TC_THREADS, TC_SMEM, s>>>(a, b, c, ws, M, N,
                                                            K, p.kslice);
      } else {
        if ((e = allow_smem(mm_tc_kernel<false>, TC_SMEM, allowed_s)))
          return e;
        mm_tc_kernel<false><<<grid, TC_THREADS, TC_SMEM, s>>>(a, b, c, ws, M,
                                                             N, K, p.kslice);
      }
    } else {
      auto kern = p.f32_bn == 64
                      ? (vec ? mm_f32_kernel<64, true> : mm_f32_kernel<64, false>)
                      : (vec ? mm_f32_kernel<32, true> : mm_f32_kernel<32, false>);
      kern<<<grid, F_THREADS, 0, s>>>(a, b, c, ws, M, N, K, p.kslice);
    }
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || p.split == 1) return e;
  const size_t mn = (size_t)M * N;
  const unsigned blocks =
      (unsigned)std::min((mn + 255) / 256, (size_t)NUM_SMS * 8);
  splitk_reduce_kernel<T><<<blocks, 256, 0, s>>>(ws, c, mn, p.split);
  return cudaGetLastError();
}

bool bad_shape(int M, int N, int K) {
  return M < 0 || N < 0 || K < 0 || (M + 127) / 128 > 65535;
}

}  // namespace

// f32 elements of the split-K workspace that repro_matmul needs for this
// shape (0: none), or -1 for a shape or dtype it refuses.
extern "C" long long repro_matmul_workspace(int M, int N, int K, int dtype) {
  if (bad_shape(M, N, K) || (dtype != 0 && dtype != 1)) return -1;
  if (M == 0 || N == 0) return 0;
  const Plan p = plan(M, N, K, dtype);
  return p.split > 1 ? (long long)p.split * M * N : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  ws: repro_matmul_workspace(...) f32
// elements (may be null when that is 0).  Returns the launches'
// cudaError_t (0 = success); the kernels run asynchronously on `stream`.
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* ws,
                            int M, int N, int K, int dtype, void* stream) {
  if (bad_shape(M, N, K) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Plan p = plan(M, N, K, dtype);
  if (p.split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, a, b, c, ws, M, N, K, s);
  return (int)launch<bf16>(p, a, b, c, ws, M, N, K, s);
}
