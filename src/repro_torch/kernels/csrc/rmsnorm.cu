// RMSNorm (K2) for Hopper (sm_90a), CUDA C++: the forward, over one tensor
// or over two in one launch, and the backward.
//
// Replaces the Pallas TPU kernel `rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py.  Reached from `ops.rmsnorm` (every norm of
// every model of the port: the layer and final norms, Mamba2's gated norm)
// and `ops.rmsnorm_pair` (a layer's q and k norms, `models/attention.py`
// `qkv_project`), and from `RMSNormFn` / `RMSNormPairFn`, whose backward is
// `repro_rmsnorm_bwd`.
//
//   forward:  y  = x * rstd * w,  rstd = rsqrt(mean(x^2) + eps)
//   backward: dx = rstd * (g*w - x_hat * mean(g*w*x_hat)),  x_hat = x*rstd
//             dw = sum over rows of g * x_hat
//
// x, g, y and dx are (R, D) contiguous row-major in one dtype (float32 or
// bfloat16); w and dw are (D,) in float32 or bfloat16.  Every sum, rstd and
// product is f32; y and dx are rounded once to x's dtype, dw to w's.
//
// Narrow mode (f32acc = 0, REPRO_NORM_F32=0, bf16 x only: for an f32 x the
// two modes are one computation) follows the reference's rms_norm computed
// in x's dtype, as XLA compiles it and `ref.rmsnorm_ref(f32=False)` spells
// it out: the sums stay f32 (the square of a bf16 is exact in f32), but the
// mean, mean + eps, rstd, w, x * rstd and (x * rstd) * w are each rounded
// to bf16; the backward rounds x_hat, g * w, their mean term, the
// difference, g * x_hat and dx likewise, and takes mean(g w x_hat) in a
// second sum over the row once rstd is known (the NF template argument).  R >= 0
// and D >= 0 are any values.  A launch covers one or two segments, each with
// its own x, w and outputs and its own R, over one grid (the pair: q and k,
// with their own weights); D, the dtypes and eps are shared.
//
// Layout of a row.  A chunk is 16 bytes of x: V = 4 elements in f32, 8 in
// bf16.  The G threads that own a row take chunks lane, lane + G, ... and
// keep the first REGS / V chunks of each in registers between the read and
// the write (REGS = 16 elements in the forward, 32 of x and 32 of g in the
// backward); chunks past that (D above 4,096 in the forward, 8,192 in the
// backward, at 256 threads a row) are read again for the write.  Loads and
// stores are 16-byte vectors where D is a multiple of V and every pointer
// is 16-byte aligned, else element by element (a ragged D: the last
// chunk's missing elements read as zero and are not written); each kernel
// is built for both (the VEC template argument: a runtime flag kept both
// paths' code in every launch, and was slower at the decode rows), and the
// arithmetic of the two is the same, so the choice changes no bit.
//   G is a function of D and the dtype alone: the power of two that holds
//   the row in registers, that is at least ceil(chunks / (REGS / V)), up to
//   256.
//   - G <= 32 (forward: D <= 512, qwen's q/k norms at 128 take 8 lanes;
//     backward: D <= 1,024): a group of G lanes of one warp a row, 256 / G
//     rows a block of 256 threads.  The row's sum is a butterfly of shuffles
//     over the G lanes.
//   - G > 32 (the forward's 1,024, 2,560, 4,096, 5,120; the backward above
//     1,024): a block of G threads (64 to 256) a row; the warps'
//     butterflies meet in shared memory and every thread adds the warps'
//     sums in warp order.
//   (The forward keeps 16 elements a thread: 32 leaves a decode row's few
//   threads a longer serial chain, 8 starves the training rows of bytes in
//   flight a thread.)
// A thread sums each chunk's V elements, then adds the chunks' sums in
// order, and a butterfly ends with every lane holding the same bits (a + b
// == b + a), so the reduction order is a
// function of D and the dtype alone: a row's bits do not depend on R, on
// the grid, on its neighbours or on the segment it is in.  Decode rows,
// prefill-chunk rows and training rows of one width agree, a row alone
// equals its row in a batch, and each output of a pair equals its single
// launch bit for bit.
//
// Backward, two launches, no atomics (so a relaunch, and the train
// restart's replay, gives the same bits):
//   row pass: the block's groups take RG rows each (rows b*RB + i*NG + grp,
//     NG = groups a block, RB = NG * RG rows a block, a function of D and
//     the dtype alone); a row recomputes rstd from x, takes sum(x^2) and
//     sum(g*w*x) in one read of x and g (rstd and the mean term come from
//     them), writes dx, and adds g * x_hat into per-column f32 registers.
//     The groups' column sums meet in shared memory and are added in group
//     order into the block's row of a scratch `part` (row blocks, D) that
//     the wrapper allocates.
//   column pass: dw[c] = the sum of part[:, c] in block order: 8 warps take
//     every 8th block row, then their sums are added in warp order, cast to
//     w's dtype.  A segment with R = 0 gets dw = 0.
//
// Bound on the H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32): bytes.  The
// forward reads x and writes y (4 flops an element); the backward reads x
// and g and writes dx (about 10 flops an element) and the scratch (1/RB of
// that in f32, 2-6%).  Two orders of magnitude under the flops/byte balance
// point, so the design keeps each row in registers between its one read and
// its one write, uses no tensor cores, and loads 16 bytes a lane.  At the
// serve path's rows (8 to 4,096 rows of 128 to 5,120) every call moves
// 10 kB to 2 MB, 3-600 ns at the memory's rate, under the launch's own
// latency: what helps there is fewer launches, hence the pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;      // group-mode block; block mode's upper bound
constexpr int FWD_REGS = 16;      // forward: x elements a thread keeps
constexpr int BWD_REGS = 32;      // backward: x (and g) elements kept
constexpr int GROUP_ROWS = 2;     // backward: rows a group takes (G <= 32)
constexpr int BLOCK_ROWS = 4;     // backward: rows a block takes (G > 32)
constexpr int COL_SLICES = 8;     // column pass: warps a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// v rounded to T (to nearest even) and widened back: the identity for float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 4) return v;
  else return __bfloat162float(__float2bfloat16(v));
}

// Narrow mode's rstd from a row's f32 sum of squares: the mean (the sum
// times the f32 reciprocal of D), mean + eps and the rsqrt, each rounded to
// T (IEEE sqrt and division: nvcc's defaults without fast math).
template <typename T>
__device__ __forceinline__ float narrow_rstd(float sumsq, int D, float eps) {
  const float var = rnd<T>(sumsq * (1.0f / (float)D));
  return rnd<T>(1.0f / sqrtf(rnd<T>(var + rnd<T>(eps))));
}

// element bits of T: one 32-bit word a float, half a word a bf16
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                       uint16_t>::type;

// A chunk's V elements as f32 (a bf16 is the top half of its f32).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// V f32 values rounded to T (to nearest even), as a chunk.
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))
              << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Chunk c of a row: one 16-byte load, or its elements one by one (zero past
// D).
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int D) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const uint4*>(row) + c);
  constexpr int V = 16 / sizeof(T);
  const Bits<T>* p = reinterpret_cast<const Bits<T>*>(row);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = c * V + j;
    if (i < D)
      w[j * sizeof(T) / 4] |= (uint32_t)p[i] << ((j * 8 * sizeof(T)) % 32);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* row, int c, int D,
                                            const uint4& u) {
  if constexpr (VEC) {
    reinterpret_cast<uint4*>(row)[c] = u;
    return;
  }
  constexpr int V = 16 / sizeof(T);
  Bits<T>* p = reinterpret_cast<Bits<T>*>(row);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = c * V + j;
    if (i < D)
      p[i] = (Bits<T>)(w[j * sizeof(T) / 4] >> ((j * 8 * sizeof(T)) % 32));
  }
}

// The V weights of x's chunk c, as f32: one vector where w has x's element
// size, else element by element.
template <typename TX, typename TW, bool VEC>
__device__ __forceinline__ void load_w(const TW* w, int c, int D, float* f) {
  constexpr int V = 16 / sizeof(TX);
  if constexpr (VEC && sizeof(TW) == sizeof(TX)) {
    unpack<TW>(__ldg(reinterpret_cast<const uint4*>(w) + c), f);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = c * V + j;
    f[j] = i < D ? to_f32(w[i]) : 0.0f;
  }
}

// Sum of v over the G threads of a row (a group of lanes, or the block):
// every thread returns the same bits.  `red` holds 2 * 32 floats.
__device__ __forceinline__ float2 row_sum(float2 v, int G, float* red) {
  const int width = G < 32 ? G : 32;
#pragma unroll 1
  for (int off = width >> 1; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  if (G <= 32) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                      // red may still hold a sum being read
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = v.x;
    red[2 * warp + 1] = v.y;
  }
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
  for (int i = 0; i < G / 32; ++i) {
    t.x += red[2 * i];
    t.y += red[2 * i + 1];
  }
  return t;
}

// One segment of a launch.  The forward writes y; the backward reads g and
// writes y as dx and dw.  `blocks` is the segment's share of the grid.
template <typename TX, typename TW>
struct Seg {
  const TX* x;
  const TW* w;
  const TX* g;
  TX* y;
  TW* dw;
  long long rows;
  long long blocks;
};

template <typename TX, typename TW, bool VEC, bool NF>
__global__ void __launch_bounds__(THREADS, 2)
rmsnorm_fwd_kernel(Seg<TX, TW> s0, Seg<TX, TW> s1, int D, int G, float eps) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int CPT = FWD_REGS / V;
  __shared__ float red[64];
  long long b = blockIdx.x;
  const bool second = b >= s0.blocks;
  const Seg<TX, TW> s = second ? s1 : s0;
  if (second) b -= s0.blocks;
  const int lane = threadIdx.x & (G - 1);
  const long long row = b * (blockDim.x / G) + threadIdx.x / G;
  const bool live = row < s.rows;
  const int nchunks = (D + V - 1) / V;
  const TX* x = s.x + row * D;
  // every load of the row (x and w) leaves before the first use of any:
  // a load inside the guarded sum would wait out its latency chunk by chunk
  uint4 cache[CPT];
  float wc[CPT][V];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * G;
    cache[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && c < nchunks) {
      cache[k] = load_chunk<TX, VEC>(x, c, D);
      load_w<TX, TW, VEC>(s.w, c, D, wc[k]);
      if constexpr (NF) {
#pragma unroll
        for (int j = 0; j < V; ++j) wc[k][j] = rnd<TX>(wc[k][j]);
      }
    }
  }
  // a sum a chunk, then the chunks' sums in order: CPT short chains that
  // run side by side instead of one chain of 32 dependent fmas
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    if (live && lane + k * G < nchunks) {
      float f[V], part = 0.0f;
      unpack<TX>(cache[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j) part = fmaf(f[j], f[j], part);
      acc += part;
    }
  }
  for (int c = lane + CPT * G; live && c < nchunks; c += G) {
    float f[V], part = 0.0f;
    unpack<TX>(load_chunk<TX, VEC>(x, c, D), f);
#pragma unroll
    for (int j = 0; j < V; ++j) part = fmaf(f[j], f[j], part);
    acc += part;
  }
  acc = row_sum(make_float2(acc, 0.0f), G, red).x;
  if (!live) return;
  const float rstd = NF ? narrow_rstd<TX>(acc, D, eps)
                        : rsqrtf(acc / (float)D + eps);
  TX* y = s.y + row * D;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * G;
    if (c < nchunks) {
      float f[V];
      unpack<TX>(cache[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j)
        f[j] = NF ? rnd<TX>(f[j] * rstd) * wc[k][j] : f[j] * rstd * wc[k][j];
      store_chunk<TX, VEC>(y, c, D, pack<TX>(f));
    }
  }
  for (int c = lane + CPT * G; c < nchunks; c += G) {
    float f[V], wf[V];
    unpack<TX>(load_chunk<TX, VEC>(x, c, D), f);
    load_w<TX, TW, VEC>(s.w, c, D, wf);
#pragma unroll
    for (int j = 0; j < V; ++j)
      f[j] = NF ? rnd<TX>(f[j] * rstd) * rnd<TX>(wf[j])
                : f[j] * rstd * wf[j];
    store_chunk<TX, VEC>(y, c, D, pack<TX>(f));
  }
}

// Row pass of the backward.  Dynamic shared memory: NG * D floats (the
// groups' column sums) when a block holds several rows at a time (NG > 1),
// then 64 floats for row_sum.
template <typename TX, typename TW, bool VEC, bool NF>
__global__ void __launch_bounds__(THREADS, 2)
rmsnorm_bwd_rows_kernel(Seg<TX, TW> s0, Seg<TX, TW> s1, int D, int G, int RG,
                        float eps, float* __restrict__ part) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int CPT = BWD_REGS / V;
  extern __shared__ float smem[];
  const int NG = blockDim.x / G;
  float* red = smem + (NG > 1 ? NG * D : 0);
  long long b = blockIdx.x;
  const bool second = b >= s0.blocks;
  const Seg<TX, TW> s = second ? s1 : s0;
  if (second) b -= s0.blocks;
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int nchunks = (D + V - 1) / V;
  float* prow = part + (long long)blockIdx.x * D;
  float col[CPT][V];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) col[k][j] = 0.0f;
  for (int i = 0; i < RG; ++i) {
    const long long row = b * NG * RG + (long long)i * NG + grp;
    const bool live = row < s.rows;
    const TX* x = s.x + row * D;
    const TX* g = s.g + row * D;
    // the row's loads all leave before the first use (as in the forward)
    uint4 xc[CPT], gc[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * G;
      xc[k] = gc[k] = make_uint4(0u, 0u, 0u, 0u);
      if (live && c < nchunks) {
        xc[k] = load_chunk<TX, VEC>(x, c, D);
        gc[k] = load_chunk<TX, VEC>(g, c, D);
      }
    }
    float2 acc = make_float2(0.0f, 0.0f);   // sum x^2, sum g w x
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * G;
      if (live && c < nchunks) {
        float xf[V], gf[V], wf[V];
        unpack<TX>(xc[k], xf);
        unpack<TX>(gc[k], gf);
        load_w<TX, TW, VEC>(s.w, c, D, wf);
        float2 part = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          part.x = fmaf(xf[j], xf[j], part.x);
          if constexpr (!NF) part.y = fmaf(gf[j] * wf[j], xf[j], part.y);
        }
        acc.x += part.x;
        acc.y += part.y;
      }
    }
    for (int c = lane + CPT * G; live && c < nchunks; c += G) {
      float xf[V], gf[V], wf[V];
      unpack<TX>(load_chunk<TX, VEC>(x, c, D), xf);
      unpack<TX>(load_chunk<TX, VEC>(g, c, D), gf);
      load_w<TX, TW, VEC>(s.w, c, D, wf);
      float2 part = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        part.x = fmaf(xf[j], xf[j], part.x);
        if constexpr (!NF) part.y = fmaf(gf[j] * wf[j], xf[j], part.y);
      }
      acc.x += part.x;
      acc.y += part.y;
    }
    acc = row_sum(acc, G, red);
    float rstd, mean;                               // mean(g w x_hat)
    if constexpr (NF) {
      // the rounded x_hat needs rstd: a second sum over the row (every
      // thread of the row takes part in its row_sum, live or not)
      rstd = narrow_rstd<TX>(acc.x, D, eps);
      float s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = lane + k * G;
        if (live && c < nchunks) {
          float xf[V], gf[V], wf[V], part = 0.0f;
          unpack<TX>(xc[k], xf);
          unpack<TX>(gc[k], gf);
          load_w<TX, TW, VEC>(s.w, c, D, wf);
#pragma unroll
          for (int j = 0; j < V; ++j)
            part = fmaf(rnd<TX>(gf[j] * rnd<TX>(wf[j])),
                        rnd<TX>(xf[j] * rstd), part);
          s2 += part;
        }
      }
      for (int c = lane + CPT * G; live && c < nchunks; c += G) {
        float xf[V], gf[V], wf[V], part = 0.0f;
        unpack<TX>(load_chunk<TX, VEC>(x, c, D), xf);
        unpack<TX>(load_chunk<TX, VEC>(g, c, D), gf);
        load_w<TX, TW, VEC>(s.w, c, D, wf);
#pragma unroll
        for (int j = 0; j < V; ++j)
          part = fmaf(rnd<TX>(gf[j] * rnd<TX>(wf[j])),
                      rnd<TX>(xf[j] * rstd), part);
        s2 += part;
      }
      s2 = row_sum(make_float2(s2, 0.0f), G, red).x;
      mean = rnd<TX>(s2 * (1.0f / (float)D));
    } else {
      rstd = rsqrtf(acc.x / (float)D + eps);
      mean = acc.y * rstd / (float)D;
    }
    if (!live) continue;
    TX* dx = s.y + row * D;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = lane + k * G;
      if (c < nchunks) {
        float xf[V], gf[V], wf[V];
        unpack<TX>(xc[k], xf);
        unpack<TX>(gc[k], gf);
        load_w<TX, TW, VEC>(s.w, c, D, wf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if constexpr (NF) {
            const float xh = rnd<TX>(xf[j] * rstd);
            const float gw = rnd<TX>(gf[j] * rnd<TX>(wf[j]));
            col[k][j] += rnd<TX>(gf[j] * xh);
            xf[j] = rstd * rnd<TX>(gw - rnd<TX>(xh * mean));
          } else {
            const float xh = xf[j] * rstd;
            col[k][j] += gf[j] * xh;
            xf[j] = rstd * (gf[j] * wf[j] - xh * mean);
          }
        }
        store_chunk<TX, VEC>(dx, c, D, pack<TX>(xf));
      }
    }
    // past the registers (G > 32 only, so NG = 1 and this thread alone owns
    // these columns of the block's row of part; row 0 of a block is live)
    for (int c = lane + CPT * G; c < nchunks; c += G) {
      float xf[V], gf[V], wf[V];
      unpack<TX>(load_chunk<TX, VEC>(x, c, D), xf);
      unpack<TX>(load_chunk<TX, VEC>(g, c, D), gf);
      load_w<TX, TW, VEC>(s.w, c, D, wf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = c * V + j;
        if constexpr (NF) {
          const float xh = rnd<TX>(xf[j] * rstd);
          const float gw = rnd<TX>(gf[j] * rnd<TX>(wf[j]));
          if (e < D)
            prow[e] = (i == 0 ? 0.0f : prow[e]) + rnd<TX>(gf[j] * xh);
          xf[j] = rstd * rnd<TX>(gw - rnd<TX>(xh * mean));
        } else {
          const float xh = xf[j] * rstd;
          if (e < D) prow[e] = (i == 0 ? 0.0f : prow[e]) + gf[j] * xh;
          xf[j] = rstd * (gf[j] * wf[j] - xh * mean);
        }
      }
      store_chunk<TX, VEC>(dx, c, D, pack<TX>(xf));
    }
  }
  float* dst = NG > 1 ? smem + grp * D : prow;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = lane + k * G;
    if (c < nchunks) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c * V + j < D) dst[c * V + j] = col[k][j];
    }
  }
  if (NG == 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    float t = 0.0f;
    for (int q = 0; q < NG; ++q) t += smem[q * D + e];
    prow[e] = t;
  }
}

// Column pass: dw of segment blockIdx.y from its rows of part.
template <typename TW>
__global__ void __launch_bounds__(32 * COL_SLICES)
rmsnorm_bwd_cols_kernel(const float* __restrict__ part, long long parts0,
                        long long parts1, TW* dw0, TW* dw1, int D) {
  __shared__ float red[COL_SLICES][32];
  const bool second = blockIdx.y == 1;
  const float* p = part + (second ? parts0 * D : 0);
  const long long n = second ? parts1 : parts0;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (c < D) {
#pragma unroll 4
    for (long long q = slice; q < n; q += COL_SLICES) acc += p[q * D + c];
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice != 0 || c >= D) return;
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < COL_SLICES; ++i) t += red[i][lane];
  TW* dw = second ? dw1 : dw0;
  if constexpr (sizeof(TW) == 4) dw[c] = t;
  else dw[c] = __float2bfloat16(t);
}

// Threads a row (G) and threads a block, from D and x's element size.
struct Plan {
  int G, threads;
};

Plan plan(int D, int esize, int regs) {
  const int V = 16 / esize, cpt = regs / V;
  const int need = ((D + V - 1) / V + cpt - 1) / cpt;
  int g = 1;
  while (g < need && g < THREADS) g <<= 1;
  if (g <= 32) return {g, THREADS};
  return {g < 64 ? 64 : g, g < 64 ? 64 : g};
}

long long block_rows(const Plan& p) {
  return p.G <= 32 ? (long long)(p.threads / p.G) * GROUP_ROWS : BLOCK_ROWS;
}

bool aligned(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TW>
Seg<TX, TW> seg(const void* x, const void* w, const void* g, void* y,
                void* dw, long long rows, long long per_block) {
  return Seg<TX, TW>{static_cast<const TX*>(x), static_cast<const TW*>(w),
                     static_cast<const TX*>(g), static_cast<TX*>(y),
                     static_cast<TW*>(dw), rows,
                     (rows + per_block - 1) / per_block};
}

template <typename TX, typename TW>
bool vectors(const Seg<TX, TW>& s) {
  return aligned(s.x) && aligned(s.g) && aligned(s.y) &&
         (sizeof(TW) != sizeof(TX) || aligned(s.w));
}

// 16-byte loads and stores: D a multiple of a chunk, every pointer aligned
template <typename TX, typename TW>
bool vectors(int D, const Seg<TX, TW>& a, const Seg<TX, TW>& b) {
  return D % (16 / (int)sizeof(TX)) == 0 && vectors(a) && vectors(b);
}

template <typename TX, typename TW, bool NF>
cudaError_t fwd(const void* x0, const void* w0, void* y0, long long r0,
                const void* x1, const void* w1, void* y1, long long r1,
                int D, float eps, cudaStream_t stream) {
  const Plan p = plan(D, sizeof(TX), FWD_REGS);
  const long long per = p.threads / p.G;
  const Seg<TX, TW> s0 = seg<TX, TW>(x0, w0, nullptr, y0, nullptr, r0, per);
  const Seg<TX, TW> s1 = seg<TX, TW>(x1, w1, nullptr, y1, nullptr, r1, per);
  const long long grid = s0.blocks + s1.blocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vectors(D, s0, s1))
    rmsnorm_fwd_kernel<TX, TW, true, NF>
        <<<(unsigned)grid, p.threads, 0, stream>>>(s0, s1, D, p.G, eps);
  else
    rmsnorm_fwd_kernel<TX, TW, false, NF>
        <<<(unsigned)grid, p.threads, 0, stream>>>(s0, s1, D, p.G, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW, bool NF>
cudaError_t bwd(const void* x0, const void* w0, const void* g0, void* dx0,
                void* dw0, long long r0, const void* x1, const void* w1,
                const void* g1, void* dx1, void* dw1, long long r1, int D,
                float eps, float* part, long long parts,
                cudaStream_t stream) {
  const Plan p = plan(D, sizeof(TX), BWD_REGS);
  const long long rb = block_rows(p);
  const Seg<TX, TW> s0 = seg<TX, TW>(x0, w0, g0, dx0, dw0, r0, rb);
  const Seg<TX, TW> s1 = seg<TX, TW>(x1, w1, g1, dx1, dw1, r1, rb);
  if (parts != s0.blocks + s1.blocks || parts > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (parts > 0) {
    const int ng = p.threads / p.G;
    const size_t smem = ((ng > 1 ? (size_t)ng * D : 0) + 64) * sizeof(float);
    const int rg = p.G <= 32 ? GROUP_ROWS : BLOCK_ROWS;
    if (vectors(D, s0, s1))
      rmsnorm_bwd_rows_kernel<TX, TW, true, NF>
          <<<(unsigned)parts, p.threads, smem, stream>>>(s0, s1, D, p.G, rg,
                                                         eps, part);
    else
      rmsnorm_bwd_rows_kernel<TX, TW, false, NF>
          <<<(unsigned)parts, p.threads, smem, stream>>>(s0, s1, D, p.G, rg,
                                                         eps, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((D + 31) / 32), dw1 != nullptr ? 2u : 1u);
  rmsnorm_bwd_cols_kernel<TW><<<grid, 32 * COL_SLICES, 0, stream>>>(
      part, s0.blocks, s1.blocks, static_cast<TW*>(dw0),
      static_cast<TW*>(dw1), D);
  return cudaGetLastError();
}

}  // namespace

// The C entry points.  x_bf16 / w_bf16: 0 = float32, 1 = bfloat16 (of x,
// g, y and dx / of w and dw).  f32acc: 1 = the sums and scale in f32, 0 =
// narrow mode (see the header; it changes nothing for a float32 x).  The
// second segment (x1, ...) is optional: null pointers and r1 = 0 for one
// tensor.  Each returns the launch's cudaError_t (0 = success); the
// kernels run asynchronously on `stream`.

extern "C" int repro_rmsnorm_fwd(const void* x0, const void* w0, void* y0,
                                 long long r0, const void* x1,
                                 const void* w1, void* y1, long long r1,
                                 int D, int x_bf16, int w_bf16, int f32acc,
                                 float eps, void* stream) {
  if (r0 < 0 || r1 < 0 || D < 0 || ((x_bf16 | w_bf16 | f32acc) & ~1))
    return (int)cudaErrorInvalidValue;
  if (D == 0 || r0 + r1 == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && !f32acc)
    return (int)(w_bf16 ? fwd<bf16, bf16, true>(x0, w0, y0, r0, x1, w1, y1,
                                                r1, D, eps, s)
                        : fwd<bf16, float, true>(x0, w0, y0, r0, x1, w1, y1,
                                                 r1, D, eps, s));
  if (x_bf16)
    return (int)(w_bf16 ? fwd<bf16, bf16, false>(x0, w0, y0, r0, x1, w1, y1,
                                                 r1, D, eps, s)
                        : fwd<bf16, float, false>(x0, w0, y0, r0, x1, w1, y1,
                                                  r1, D, eps, s));
  return (int)(w_bf16 ? fwd<float, bf16, false>(x0, w0, y0, r0, x1, w1, y1,
                                                r1, D, eps, s)
                      : fwd<float, float, false>(x0, w0, y0, r0, x1, w1, y1,
                                                 r1, D, eps, s));
}

// Rows of one block of the backward's row pass, whose column sums make one
// row of `part`: a segment of R rows takes ceil(R / this) rows of it.
extern "C" long long repro_rmsnorm_bwd_block_rows(int D, int x_bf16) {
  if (D < 0) return -1;
  return block_rows(plan(D, x_bf16 ? 2 : 4, BWD_REGS));
}

// part: (parts, D) float32 scratch, parts = the two segments' row blocks
// (repro_rmsnorm_bwd_block_rows); dw1 is null for one tensor.
extern "C" int repro_rmsnorm_bwd(const void* x0, const void* w0,
                                 const void* g0, void* dx0, void* dw0,
                                 long long r0, const void* x1,
                                 const void* w1, const void* g1, void* dx1,
                                 void* dw1, long long r1, int D, int x_bf16,
                                 int w_bf16, int f32acc, float eps,
                                 void* part, long long parts, void* stream) {
  if (r0 < 0 || r1 < 0 || D < 0 || ((x_bf16 | w_bf16 | f32acc) & ~1))
    return (int)cudaErrorInvalidValue;
  if (D == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (x_bf16 && !f32acc)
    return (int)(w_bf16 ? bwd<bf16, bf16, true>(x0, w0, g0, dx0, dw0, r0, x1,
                                                w1, g1, dx1, dw1, r1, D, eps,
                                                pf, parts, s)
                        : bwd<bf16, float, true>(x0, w0, g0, dx0, dw0, r0,
                                                 x1, w1, g1, dx1, dw1, r1, D,
                                                 eps, pf, parts, s));
  if (x_bf16)
    return (int)(w_bf16 ? bwd<bf16, bf16, false>(x0, w0, g0, dx0, dw0, r0,
                                                 x1, w1, g1, dx1, dw1, r1, D,
                                                 eps, pf, parts, s)
                        : bwd<bf16, float, false>(x0, w0, g0, dx0, dw0, r0,
                                                  x1, w1, g1, dx1, dw1, r1,
                                                  D, eps, pf, parts, s));
  return (int)(w_bf16 ? bwd<float, bf16, false>(x0, w0, g0, dx0, dw0, r0, x1,
                                                w1, g1, dx1, dw1, r1, D, eps,
                                                pf, parts, s)
                      : bwd<float, float, false>(x0, w0, g0, dx0, dw0, r0, x1,
                                                 w1, g1, dx1, dw1, r1, D, eps,
                                                 pf, parts, s));
}
