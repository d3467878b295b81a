// Segmented LoRA for Hopper (sm_90a), CUDA C++: the shrink (K5), the
// expand (K6) and the two fused into one launch, with the base added.
//
// Replace the Pallas TPU kernels `lora_shrink_kernel` and
// `lora_expand_kernel` in src/repro/kernels/lora.py.  `models.lora`
// (`add_delta`, `delta`) calls the fused entry `repro_lora_delta` once per
// adapted projection of every layer of a serve dispatch that holds an
// adapter row; `repro_lora_shrink` and `repro_lora_expand` run the same
// device code for one phase each (`ops.lora_shrink` / `ops.lora_expand`).
//
//   shrink: h (T, R) f32 = x (T, d) @ A[slot] (d, R)
//   expand: y (T, O)     = h (T, R) @ B[slot] (R, O), f32 sums written in
//                          the slab's dtype
//   delta:  out (T, O)   = base + expand(shrink(x)), or the expand alone
//
// Rows come in sequences of `rows_per_seq` (s) consecutive rows that share
// one slot: row t reads ids[t / s] (a decode step: s = 1, one row a
// sequence; a prefill chunk: s = 256).  A slot < 0 (a base row) gives exact
// zeros (so base + 0 with a base), written as such, never a product with
// zero; a slot at or past S gives NaN (the ids live on the card, so the
// wrapper cannot check them without a sync).  x, A, B, base and y share a
// dtype, float32 or bfloat16; h is float32.  Layouts are contiguous
// row-major: A (S, d, R), B (S, R, O).  R is a multiple of 8 up to
// MAX_RANK.
//
// Design.  A tile is up to 8 rows (16 on the tensor cores) of one sequence,
// so one slot.  Each tile is a thread-block cluster of P = 8 blocks that
// split d into P fixed slices.
//   shrink phase: block p sums its slice of d into f32 partials for the
//     tile's rows, in shared memory.  Two regimes, picked by the dtype, s
//     and d alone:
//     - CUDA cores (f32; bf16 with s < 16 or d not a multiple of 8): thread
//       j takes rank octet j % q (q = R/8 rounded up to a power of two) and
//       k = k0 + j / q, k0 + j / q + 128 / q, ... of the slice: one 16-byte
//       load of A[k, octet] (two in f32), used for every row of the tile, so
//       A is read once per tile; then a shuffle butterfly over the k lanes
//       of each warp and a sum over the 4 warps, in that order.
//     - tensor cores (bf16, s >= 16, d a multiple of 8): 16 rows; the
//       slice's k16 steps stream through a cp.async ring of x and A tiles
//       (64 k a stage, one k16 step per warp; 6 stages at R = 16, so a
//       slice of d = 3072 is all in flight at once), each warp runs
//       mma.sync.m16n8k16 over its steps, and the 4 warps' sums are added in
//       order.  bf16 products are exact in f32, as in the TPU kernel's f32
//       dot.  A rank that is not a multiple of 16 is padded with zero
//       columns in shared memory.
//   cluster reduction: each block pushes its partials into slot p of every
//     block's receive area through distributed shared memory (`st.async`,
//     counted on the receiver's mbarrier), then waits on its own mbarrier
//     for the P partials and sums them in slice order, so every block holds
//     the same h.  A block reads only its own shared memory and exits only
//     after all that is sent to it has landed; the one cluster barrier,
//     arrived without ordering memory, only makes every block's mbarrier
//     (and, where the receive area reuses the shrink's, every shrink) ready
//     before the first push: a barrier that orders no memory is much
//     cheaper than the release/acquire one a pull through map_shared_rank
//     needs, and a pull needs a second one before any block may exit.
//   expand phase: block p covers the output tiles p, p + P, ... of width
//     block_out; a thread takes the columns of one 16-byte load (8 in bf16,
//     4 in f32) for up to 8 rows, loads B[r, those columns] once per r (the
//     loads of up to 16 ranks, and their h, issued before the first fmaf)
//     and runs one f32 fmaf chain over r = 0..R-1 per column, so y is
//     bitwise the same for every block_out, and B is read once per tile
//     and row group.  With a base, the
//     epilogue writes base + y with y rounded to the dtype first: the bits
//     of `base + y` in PyTorch.  The ragged last tile is masked, not padded.
// Invariants: h's summation order depends only on d, R, the dtype and the
// regime; a sequence's bits do not depend on the rest of the batch; no
// atomics, so relaunches are bitwise equal; and the fused launch equals
// expand(shrink(x)) (+ base) bit for bit, since each phase is the same code.
//
// Bound on the H100 (data sheet: 3.35 TB/s).  At the serve shapes (a
// decode step of 8 rows or a 256-row prefill chunk, d and O in {1024, 2048,
// 3072}, R = 16, bf16) the work is bytes: x, one (d, R) and one (R, O)
// factor per distinct adapter, the base and y; a decode delta over three
// adapters at d = 1024, O = 3072 moves about 0.5 MB, some 0.15 us, and its
// 2 T R (d + O) flops are nothing beside that.  So every call is bound by
// launch and memory latency, far above either bound.  What the design does about it: one
// launch a projection instead of two (and no h round trip through device
// memory, and no separate add); the shrink's serial chain cut by P = 8 over
// 8 times as many SMs; each factor read once per tile, not once per row.
// What it leaves: rows of different sequences that share a slot in a decode
// batch each read its factors (from L2), and the chunk's products run on
// mma.sync rather than wgmma.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_RANK = 64;
constexpr int P = 8;            // blocks a cluster = slices of d
constexpr int NT = 128;         // threads a block
constexpr int NW = NT / 32;
constexpr int TC_ROWS = 16;     // rows of a tensor-core tile
constexpr int TC_MIN_ROWS = 16; // rows_per_seq from which bf16 takes them
constexpr int KC = 64;          // k of one ring stage: one k16 step a warp
constexpr int LDX = KC + 8;     // x tile row stride (bf16), conflict-free

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive values from a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fc00000);
}

// Distributed shared memory and the cluster's barriers, in PTX.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Four floats into a block of the cluster (addresses from mapa), counted on
// that block's mbarrier as 16 bytes of a transaction.
__device__ __forceinline__ void st_async4(uint32_t addr, const float* v,
                                          uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(mbar)
      : "memory");
}
// This block's mbarrier: one arrival (made here) and `bytes` to come; the
// fence makes the initialisation visible to the cluster's other blocks.
__device__ __forceinline__ void mbar_expect(uint64_t* mbar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(mbar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(mbar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* mbar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(mbar)) : "memory");
  } while (!done);
}
// The cluster barrier, split: arrive (ordering no memory), then wait for
// every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Where a tile's rows lie: tile c of the grid is tile c % tps of sequence
// c / tps, rows [row0, row0 + nrows).
template <int TR>
struct Tile {
  int seq, row0, nrows;
  __device__ Tile(int c, int s, int tps) {
    if constexpr (TR == 1) {  // one row a sequence (rows_per_seq 1)
      seq = row0 = c;
      nrows = 1;
    } else {
      seq = c / tps;
      const int i = (c - seq * tps) * TR;
      row0 = seq * s + i;
      nrows = min(TR, s - i);
    }
  }
};

// ---------------------------------------------------------------------------
// shrink phase, CUDA cores: the partials of slice [k0, k1) for the TR rows
// of the tile (rows at or past nrows read nothing), into part[TR][R].
// scratch holds NW * TR * R floats.
// ---------------------------------------------------------------------------
template <typename T, int TR>
__device__ __forceinline__ void shrink_cc(const T* __restrict__ x,
                                          const T* __restrict__ as, int d,
                                          int R, int row0, int nrows, int k0,
                                          int k1, float* __restrict__ part,
                                          float* __restrict__ scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int oct = R >> 3;
  const int qp = oct > 4 ? 8 : oct > 2 ? 4 : oct;  // a power of two
  const int q = tid & (qp - 1);
  const int step = NT / qp;
  float acc[TR][8];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (q < oct) {
    // U k-steps' loads are issued before their fmas; each (row, rank)
    // partial is still one chain over k = k0 + tid / qp, + step, ...
    constexpr int U = TR == 1 ? 8 : 2;
    const T* xr = x + (size_t)row0 * d;
    for (int kb = k0 + tid / qp; kb < k1; kb += U * step) {
      float av[U][8], xv[U][TR];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kb + u * step;
        if (k >= k1) break;
        load8(as + (size_t)k * R + 8 * q, av[u]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
          xv[u][i] = TR == 1 || i < nrows ? to_f32(xr[(size_t)i * d + k])
                                          : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kb + u * step >= k1) break;
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(xv[u][i], av[u][j], acc[i][j]);
      }
    }
  }
  // lanes that share an octet differ in the bits at and above qp
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    if (m < qp) break;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], m);
  }
  if (lane < qp && lane < oct) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        scratch[(warp * TR + i) * R + 8 * lane + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < TR * R; e += NT) {
    float s = scratch[e];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += scratch[w * TR * R + e];
    part[e] = s;
  }
}

// ---------------------------------------------------------------------------
// shrink phase, tensor cores (bf16): the partials of slice [k0, k1) (k0 and
// the slice's length multiples of 16; x rows and A 16-byte aligned) for the
// 16 rows of the tile, into part[16][R].  RP is R rounded up to 16.  `ring`
// holds the cp.async ring and, after it, the warps' sums.
// ---------------------------------------------------------------------------
// ring stages by padded rank: at R = 16 a slice of d = 3072 (6 stages) is
// all in flight at once
template <int RP>
__host__ __device__ constexpr int tc_stages() {
  return RP == 16 ? 6 : RP == 32 ? 4 : 3;
}
template <int RP>
__host__ __device__ constexpr int tc_ring_bytes() {
  return tc_stages<RP>() * (TC_ROWS * LDX + KC * (RP + 8)) * 2;
}

template <int RP>
__device__ __forceinline__ void shrink_tc(const bf16* __restrict__ x,
                                          const bf16* __restrict__ as, int d,
                                          int R, int row0, int nrows, int k0,
                                          int k1, float* __restrict__ part,
                                          char* __restrict__ ring) {
  constexpr int LDA = RP + 8;
  constexpr int NB = RP / 8;
  constexpr int STAGES = tc_stages<RP>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* xs = reinterpret_cast<bf16*>(ring);
  bf16* at = xs + STAGES * TC_ROWS * LDX;
  const int oct = R >> 3;
  if (RP > R) {  // zero the pad columns once; cp.async never writes them
    const int padc = (RP - R) >> 3;
    for (int e = tid; e < STAGES * KC * padc; e += NT) {
      const int row = e / padc, c = R + 8 * (e - row * padc);
      *reinterpret_cast<uint4*>(at + row * LDA + c) = make_uint4(0, 0, 0, 0);
    }
  }
  const int nst = k1 > k0 ? (k1 - k0 + KC - 1) / KC : 0;
  auto load_stage = [&](int st) {
    const int kb = k0 + st * KC;
    bf16* xb = xs + (st % STAGES) * TC_ROWS * LDX;
    bf16* ab = at + (st % STAGES) * KC * LDA;
    for (int e = tid; e < TC_ROWS * (KC / 8); e += NT) {
      const int i = e / (KC / 8), c = 8 * (e % (KC / 8));
      const bool ok = i < nrows && kb + c < k1;
      cp_async16(xb + i * LDX + c,
                 ok ? x + (size_t)(row0 + i) * d + kb + c : x, ok ? 16 : 0);
    }
    for (int e = tid; e < KC * oct; e += NT) {
      const int kr = e / oct, c = 8 * (e - kr * oct);
      const bool ok = kb + kr < k1;
      cp_async16(ab + kr * LDA + c, ok ? as + (size_t)(kb + kr) * R + c : as,
                 ok ? 16 : 0);
    }
  };
  float acc[NB][4];
  zero_acc<NB>(acc);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nst) load_stage(st + STAGES - 1);
    cp_async_commit();
    if (k0 + st * KC + warp * 16 < k1) {
      const bf16* xb = xs + (st % STAGES) * TC_ROWS * LDX;
      const bf16* ab = at + (st % STAGES) * KC * LDA;
      uint32_t af[4];
      ldsm_x4(af, xb + (lane % 16) * LDX + warp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < NB / 2; ++n) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, ab + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8)
                               * LDA + n * 16 + (lane / 16) * 8);
        mma16816(acc[2 * n], af, bfr[0], bfr[1]);
        mma16816(acc[2 * n + 1], af, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' sums go there
  float* scratch = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= R) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* dst = scratch + (warp * TC_ROWS + g + 8 * hh) * R + col;
      dst[0] = acc[n][2 * hh];
      dst[1] = acc[n][2 * hh + 1];
    }
  }
  __syncthreads();
  for (int e = tid; e < TC_ROWS * R; e += NT) {
    float s = scratch[e];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += scratch[w * TC_ROWS * R + e];
    part[e] = s;
  }
}

// ---------------------------------------------------------------------------
// expand phase: the output tiles j0, j0 + jstep, ... of width bo for the
// tile's rows, from hs[TR][R] (bs = B[slot], or null: every value `fill`).
// A thread takes CW consecutive columns (one 16-byte load of B a rank: 8 in
// bf16, 4 in f32) for up to 8 rows; the block's tiles are one flat list of
// such items.  With base, writes base + y (y rounded to T first).  vec: O
// and bo are multiples of 8 and B, base and y 16-byte aligned.
// ---------------------------------------------------------------------------
template <typename T> struct Cols;
template <> struct Cols<bf16> {
  static constexpr int CW = 8;
  using Raw = uint4;
  __device__ static Raw load(const bf16* p, bool vec, int nc) {
    if (vec) return *reinterpret_cast<const uint4*>(p);
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (c < nc)
        w[c / 2] |= (uint32_t)__bfloat16_as_ushort(p[c]) << (16 * (c & 1));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void unpack(const Raw& u, float v[CW]) { unpack8(u, v); }
  __device__ static void store(bf16* p, bool vec, int nc, const bf16 v[CW]) {
    if (vec) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (uint32_t)__bfloat16_as_ushort(v[2 * i]) |
               ((uint32_t)__bfloat16_as_ushort(v[2 * i + 1]) << 16);
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int c = 0; c < nc; ++c) p[c] = v[c];
    }
  }
};
template <> struct Cols<float> {
  static constexpr int CW = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p, bool vec, int nc) {
    if (vec) return *reinterpret_cast<const float4*>(p);
    return make_float4(nc > 0 ? p[0] : 0.f, nc > 1 ? p[1] : 0.f,
                       nc > 2 ? p[2] : 0.f, nc > 3 ? p[3] : 0.f);
  }
  __device__ static void unpack(const Raw& u, float v[CW]) {
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  __device__ static void store(float* p, bool vec, int nc, const float v[CW]) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int c = 0; c < nc; ++c) p[c] = v[c];
    }
  }
};

// acc[i][c] += h[i][r] * B[r][c] for the N ranks r0 .. r0 + N - 1, in
// rank order: every load of the round (B's, and h's) is issued before the
// first fma.
template <typename T, int RG, int N>
__device__ __forceinline__ void expand_round(float (&acc)[RG][Cols<T>::CW],
                                             const float* __restrict__ hs,
                                             const T* __restrict__ bcol,
                                             int R, int O, int r0, bool vec,
                                             int nc) {
  using C = Cols<T>;
  typename C::Raw raw[N];
  float hv[RG][N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    raw[u] = C::load(bcol + (size_t)(r0 + u) * O, vec, nc);
#pragma unroll
    for (int i = 0; i < RG; ++i) hv[i][u] = hs[i * R + r0 + u];
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float bv[C::CW];
    C::unpack(raw[u], bv);
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int c = 0; c < C::CW; ++c)
        acc[i][c] = fmaf(hv[i][u], bv[c], acc[i][c]);
  }
}

template <typename T, int TR, bool vec>
__device__ __forceinline__ void expand_items(
    const float* __restrict__ hs, const T* __restrict__ bs,
    const T* __restrict__ base, T* __restrict__ y, int R, int O, int bo,
    int row0, int nrows, int j0, int jstep, float fill) {
  using C = Cols<T>;
  constexpr int CW = C::CW;
  constexpr int RG = TR < 8 ? TR : 8;
  constexpr int RC = RG == 1 ? 16 : 8;  // ranks a round
  const int nrg = (nrows + RG - 1) / RG;
  const int ntiles = (O + bo - 1) / bo;
  const int gmax = (bo + CW - 1) / CW;
  const int mine = j0 >= ntiles ? 0
                   : j0 + jstep >= ntiles ? 1
                                          : (ntiles - j0 + jstep - 1) / jstep;
  const int per_tile = nrg * gmax;
  for (int item = threadIdx.x; item < mine * per_tile; item += NT) {
    // (tile, row group, column group) of this item; the divisions are
    // skipped where there is one tile or one row group
    const int jt = mine == 1 ? 0 : item / per_tile;
    const int rest = item - jt * per_tile;
    const int rg = nrg == 1 ? 0 : rest / gmax;
    const int o0 = (j0 + jt * jstep) * bo, o1 = min(o0 + bo, O);
    const int c0 = o0 + CW * (rest - rg * gmax);
    if (c0 >= o1) continue;
    const int nc = min(CW, o1 - c0), i0 = rg * RG;
    float acc[RG][CW];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] = bs ? 0.f : fill;
    if (bs) {
      // whole rounds of RC ranks, then rounds of 8 (R is a multiple of 8):
      // no guard inside a round, so its loads all go out first
      int r0 = 0;
      for (; r0 + RC <= R; r0 += RC)
        expand_round<T, RG, RC>(acc, hs + i0 * R, bs + c0, R, O, r0, vec, nc);
      for (; r0 < R; r0 += 8)
        expand_round<T, RG, 8>(acc, hs + i0 * R, bs + c0, R, O, r0, vec, nc);
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      if (i0 + i >= nrows) break;
      const size_t off = (size_t)(row0 + i0 + i) * O + c0;
      T out[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) out[c] = from_f32<T>(acc[i][c]);
      if (base) {
        float bv[CW];
        C::unpack(C::load(base + off, vec, nc), bv);
#pragma unroll
        for (int c = 0; c < CW; ++c)
          out[c] = from_f32<T>(bv[c] + to_f32(out[c]));
      }
      C::store(y + off, vec, nc, out);
    }
  }
}

template <typename T, int TR>
__device__ __forceinline__ void expand_tiles(
    const float* __restrict__ hs, const T* __restrict__ bs,
    const T* __restrict__ base, T* __restrict__ y, int R, int O, int bo,
    int row0, int nrows, int j0, int jstep, bool vec, float fill) {
  if (vec)
    expand_items<T, TR, true>(hs, bs, base, y, R, O, bo, row0, nrows, j0,
                              jstep, fill);
  else
    expand_items<T, TR, false>(hs, bs, base, y, R, O, bo, row0, nrows, j0,
                               jstep, fill);
}

// ---------------------------------------------------------------------------
// The cluster kernel: shrink phase, cluster reduction, then either h to
// device memory (h_out: the standalone shrink, written by rank 0) or the
// expand phase (y, with or without base).  TR rows a tile; RP > 0 takes
// the tensor cores (TR = 16).
// ---------------------------------------------------------------------------
// Shared memory of the cluster kernel: the shrink's ring or scratch
// (`work`), the P partials received (`recv`), this block's partials and h.
// Where all of it fits the static 48 KB, recv has its own room and a block
// may signal the cluster barrier as it starts; else (the tensor-core tile
// at R > 16) recv reuses work, and the barrier waits for every block's
// shrink to be done with it.
template <int TR, int RP>
struct Smem {
  static constexpr int kRows = RP > 0 ? RP : MAX_RANK;  // ranks a row holds
  static constexpr int kScratch = NW * TR * kRows * 4;
  static constexpr int kRing = RP > 0 ? tc_ring_bytes<RP>() : 0;
  static constexpr int kWork = kRing > kScratch ? kRing : kScratch;
  static constexpr int kRecv = P * TR * kRows * 4;
  static constexpr bool kShared =
      kWork + kRecv + 2 * TR * kRows * 4 > 46 * 1024;
  static constexpr int kArea = kShared ? (kWork > kRecv ? kWork : kRecv)
                                       : kWork + kRecv;
};

template <typename T, int TR, int RP>
__global__ void __cluster_dims__(P, 1, 1) __launch_bounds__(NT)
lora_cluster_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ b, const int* __restrict__ ids,
                    const T* __restrict__ base, float* __restrict__ h_out,
                    T* __restrict__ y, int d, int R, int O, int bo, int S,
                    int s, int tps, int vec) {
  static_assert(RP == 0 || (TR == TC_ROWS && sizeof(T) == 2), "tc tile");
  using M = Smem<TR, RP>;
  __shared__ __align__(16) char work[M::kArea];
  __shared__ __align__(16) float part[TR * M::kRows];
  __shared__ __align__(16) float hs[TR * M::kRows];
  __shared__ __align__(8) uint64_t mbar;
  const int rank = (int)cg::this_cluster().block_rank();
  const Tile<TR> tile(blockIdx.x / P, s, tps);
  const int slot = ids[tile.seq];
  const bool live = slot >= 0 && slot < S;  // the same in every block
  if (live) {
    const int n = TR * R;  // floats of one block's partials
    float* recv = reinterpret_cast<float*>(work + (M::kShared ? 0 : M::kWork));
    if (threadIdx.x == 0) mbar_expect(&mbar, P * n * 4);
    if (!M::kShared) cluster_arrive_relaxed();
    const T* as = a + (size_t)slot * d * R;
    if constexpr (RP > 0) {
      // slices of whole k16 steps
      const int len = ((d + P - 1) / P + 15) / 16 * 16;
      const int k0 = min(d, rank * len), k1 = min(d, k0 + len);
      shrink_tc<RP>(
          reinterpret_cast<const bf16*>(x), reinterpret_cast<const bf16*>(as),
          d, R, tile.row0, tile.nrows, k0, k1, part, work);
    } else {
      const int len = (d + P - 1) / P;
      const int k0 = min(d, rank * len), k1 = min(d, k0 + len);
      shrink_cc<T, TR>(x, as, d, R, tile.row0, tile.nrows, k0, k1, part,
                       reinterpret_cast<float*>(work));
    }
    __syncthreads();
    // every block has initialised its mbarrier (and, where recv reuses
    // work, is past its shrink): push this block's partials into slot
    // `rank` of every block's recv, then wait for the P that come here
    if (M::kShared) cluster_arrive_relaxed();
    cluster_wait();
    const uint32_t dst = smem_addr(recv + rank * n), bar = smem_addr(&mbar);
    for (int i = threadIdx.x; i < P * (n / 4); i += NT) {
      const int p = i / (n / 4), e = 4 * (i - p * (n / 4));
      st_async4(mapa(dst + 4 * e, p), part + e, mapa(bar, p));
    }
    mbar_wait(&mbar);
    // h in slice order: the same sum in every block
    for (int e = threadIdx.x; e < tile.nrows * R; e += NT) {
      float v = recv[e];
#pragma unroll
      for (int p = 1; p < P; ++p) v += recv[p * n + e];
      hs[e] = v;
    }
    __syncthreads();
  }
  const float fill = slot < 0 ? 0.f : nan_f32();
  if (h_out != nullptr) {
    if (rank == 0)
      for (int e = threadIdx.x; e < tile.nrows * R; e += NT)
        h_out[(size_t)tile.row0 * R + e] = live ? hs[e] : fill;
  } else {
    expand_tiles<T, TR>(hs, live ? b + (size_t)slot * R * O : nullptr, base,
                        y, R, O, bo, tile.row0, tile.nrows, rank, P, vec != 0,
                        fill);
  }
}

// The standalone expand: grid (row tiles, output tiles); h from device
// memory, then the expand phase for one output tile.
template <typename T, int TR>
__global__ void __launch_bounds__(NT)
lora_expand_kernel(const float* __restrict__ h, const T* __restrict__ b,
                   const int* __restrict__ ids, T* __restrict__ y, int R,
                   int O, int bo, int S, int s, int tps, int vec) {
  const Tile<TR> tile(blockIdx.x, s, tps);
  const int slot = ids[tile.seq];
  const float* hr = h + (size_t)tile.row0 * R;
  if constexpr (TR > 1) {
    __shared__ float hs[TR * MAX_RANK];
    // staged once for the tile; h does not depend on the slot, so its
    // loads go out beside ids'.  One row is read where it is, no barrier.
    for (int e = threadIdx.x; e < tile.nrows * R; e += NT) hs[e] = hr[e];
    __syncthreads();
    hr = hs;
  }
  const bool live = slot >= 0 && slot < S;
  expand_tiles<T, TR>(hr, live ? b + (size_t)slot * R * O : nullptr, nullptr,
                      y, R, O, bo, tile.row0, tile.nrows, blockIdx.y,
                      gridDim.y, vec != 0, slot < 0 ? 0.f : nan_f32());
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *x, *a, *b, *ids, *base;
  float* h_out;
  void* y;
  int T, d, R, O, bo, S, s, dtype;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tensor-core regime's rule (kernels/lora.py's `tensor_core_rows`).
bool tensor_cores(const Args& g) {
  return g.dtype == 1 && g.s >= TC_MIN_ROWS && g.d % 8 == 0;
}

int expand_vec(const Args& g) {
  return g.O % 8 == 0 && g.bo % 8 == 0 && aligned16(g.b) &&
         aligned16(g.y) && (g.base == nullptr || aligned16(g.base));
}

template <typename T, int TR, int RP>
cudaError_t launch_cluster(const Args& g) {
  const int tps = (g.s + TR - 1) / TR;
  const long long tiles = (long long)(g.T / g.s) * tps;
  if (tiles * P > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  lora_cluster_kernel<T, TR, RP><<<(unsigned)(tiles * P), NT, 0, g.stream>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.a),
      static_cast<const T*>(g.b), static_cast<const int*>(g.ids),
      static_cast<const T*>(g.base), g.h_out, static_cast<T*>(g.y), g.d, g.R,
      g.O, g.bo, g.S, g.s, tps, g.h_out ? 0 : expand_vec(g));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cluster_cc(const Args& g) {
  return g.s == 1 ? launch_cluster<T, 1, 0>(g) : launch_cluster<T, 8, 0>(g);
}

cudaError_t launch_cluster_any(const Args& g) {
  if (g.dtype == 0) return launch_cluster_cc<float>(g);
  if (!tensor_cores(g)) return launch_cluster_cc<bf16>(g);
  if (!aligned16(g.x) || !aligned16(g.a)) return cudaErrorMisalignedAddress;
  switch ((g.R + 15) / 16) {
    case 1: return launch_cluster<bf16, TC_ROWS, 16>(g);
    case 2: return launch_cluster<bf16, TC_ROWS, 32>(g);
    case 3: return launch_cluster<bf16, TC_ROWS, 48>(g);
    default: return launch_cluster<bf16, TC_ROWS, 64>(g);
  }
}

template <typename T, int TR>
cudaError_t launch_expand(const Args& g, const float* h) {
  const int tps = (g.s + TR - 1) / TR;
  const long long tiles = (long long)(g.T / g.s) * tps;
  const int ntiles = (g.O + g.bo - 1) / g.bo;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, ntiles);
  lora_expand_kernel<T, TR><<<grid, NT, 0, g.stream>>>(
      h, static_cast<const T*>(g.b), static_cast<const int*>(g.ids),
      static_cast<T*>(g.y), g.R, g.O, g.bo, g.S, g.s, tps, expand_vec(g));
  return cudaGetLastError();
}

bool bad_common(int T, int R, int S, int s, int dtype) {
  return T < 0 || S < 1 || R < 8 || R > MAX_RANK || R % 8 || s < 1 ||
         T % s || (dtype != 0 && dtype != 1);
}

}  // namespace

// The C entry points.  dtype: 0 = float32, 1 = bfloat16 (of x, the slabs,
// base and y); h is float32.  ids holds T / rows_per_seq slots.  Each
// returns the launch's cudaError_t (0 = success); the kernel runs
// asynchronously on `stream`.

extern "C" int repro_lora_shrink(const void* x, const void* a,
                                 const void* ids, void* h, int T, int d,
                                 int R, int S, int rows_per_seq, int dtype,
                                 void* stream) {
  if (bad_common(T, R, S, rows_per_seq, dtype) || d < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  Args g{x, a, nullptr, ids, nullptr, static_cast<float*>(h), nullptr, T, d,
         R, 0, 1, S, rows_per_seq, dtype, static_cast<cudaStream_t>(stream)};
  return (int)launch_cluster_any(g);
}

extern "C" int repro_lora_expand(const void* h, const void* b,
                                 const void* ids, void* y, int T, int R,
                                 int O, int block_out, int S,
                                 int rows_per_seq, int dtype, void* stream) {
  if (bad_common(T, R, S, rows_per_seq, dtype) || O < 0 || block_out < 1 ||
      (O + block_out - 1) / block_out > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || O == 0) return 0;
  Args g{nullptr, nullptr, b, ids, nullptr, nullptr, y, T, 0, R, O,
         block_out, S, rows_per_seq, dtype,
         static_cast<cudaStream_t>(stream)};
  const float* hf = static_cast<const float*>(h);
  if (dtype == 0)
    return (int)(rows_per_seq == 1 ? launch_expand<float, 1>(g, hf)
                                   : launch_expand<float, 8>(g, hf));
  return (int)(rows_per_seq == 1 ? launch_expand<bf16, 1>(g, hf)
                                 : launch_expand<bf16, 8>(g, hf));
}

// base may be null: then y is the delta alone.
extern "C" int repro_lora_delta(const void* x, const void* a, const void* b,
                                const void* ids, const void* base, void* y,
                                int T, int d, int R, int O, int block_out,
                                int S, int rows_per_seq, int dtype,
                                void* stream) {
  if (bad_common(T, R, S, rows_per_seq, dtype) || d < 0 || O < 0 ||
      block_out < 1)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || O == 0) return 0;
  Args g{x, a, b, ids, base, nullptr, y, T, d, R, O, block_out, S,
         rows_per_seq, dtype, static_cast<cudaStream_t>(stream)};
  return (int)launch_cluster_any(g);
}
