// Warp-level tensor-core and copy helpers for Hopper (sm_90a), shared by
// the port's bf16 kernels: flash attention (K3), paged attention (K1), the
// matrix product (K4) and the LoRA shrink's chunk tile (K5).
//
// - `cp.async` copies global -> shared (16 and 4 bytes; a src size of 0
//   writes zeros), with commit/wait groups for multi-stage rings.
// - `ldmatrix` (`.x4`, `.x4.trans`) loads four 8x8 b16 matrices a warp.
// - `mma.sync.m16n8k16` (bf16 in, f32 accumulate) and the fragment maps
//   built on it: `mma_abt` (acc += A B^T, both row-major in shared memory)
//   and `mma_px` (acc += P X, P an accumulator fragment rounded to bf16, X
//   row-major in shared memory, read through `ldmatrix.trans`).
// - `store_rows` writes a warp's 16-row accumulator block as bf16 pairs;
//   `zero_pad` zeroes the columns past a short head_dim once.
// - `allow_smem` raises a kernel's dynamic shared-memory limit once.
//
// Included by several sources, so `kernels/build.py` hashes this file into
// each including library's name: an edit here rebuilds all of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane i addresses row i % 8 of matrix i / 8, and
// register j of every lane holds its part of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one k16 step from the accumulators of two n8 tiles
// (c0 = columns 0-7, c1 = columns 8-15 of the step), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Zero the columns [hd, HD) of `rows` rows once: the products run over the
// tile's whole head_dim HD, so a shorter head_dim reads zeros there.
template <int HD, int LD, int NT>
__device__ __forceinline__ void zero_pad(bf16* t, int rows, int hd) {
  const int chunks = (HD - hd) / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += NT) {
    const int r = i / chunks, c = hd + (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(t + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
}

// 2^x on the special-function unit (relative error ~2^-22); -1e30 gives 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A warp's block of NB n8 tiles of 16 rows, zeroed.
template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// acc (16 x NB*8) += A B^T: A the 16 rows at a, B the NB*8 rows at b (row
// stride LD each), contracting over the tile's head_dim HD: the scores
// S = Q K^T (and dP = dO V^T, S^T = K Q^T, dP^T = V dO^T).  No branch in
// the loop, so ptxas can issue the next step's ldmatrix under this step's
// mma.
template <int HD, int LD, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const bf16* a,
                                        const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < NB / 2; ++n) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b + (n * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                       kk * 16 + ((lane / 8) % 2) * 8);
      mma16816(acc[2 * n], af, bfr[0], bfr[1]);
      mma16816(acc[2 * n + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc (16 x the DB*8 columns [d0, d0 + DB*8) of head_dim) += P X, P the
// accumulators p (16 x NB*8, rounded to bf16 here), X the NB*8 rows at x
// (row stride LD): O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K.
template <int LD, int NB, int DB>
__device__ __forceinline__ void mma_px(float (&acc)[DB][4],
                                       const float (&p)[NB][4],
                                       const bf16* x, int d0, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t af[4];
    acc_to_a(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dn = 0; dn < DB / 2; ++dn) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, x + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                         d0 + dn * 16 + (lane / 16) * 8);
      mma16816(acc[2 * dn], af, bfr[0], bfr[1]);
      mma16816(acc[2 * dn + 1], af, bfr[2], bfr[3]);
    }
  }
}

// Write a warp's 16 x (DB*8) accumulator block (rows row0 + lane/4 and
// + 8, columns d0 + ...) times scale[h] (h: the row's half) as bf16 pairs;
// rows at or past `rows` and columns at or past hd are skipped.
template <int DB>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[DB][4],
                                           const float (&scale)[2], int row0,
                                           int rows, int d0, int hd,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      const int c = d0 + d * 8 + t * 2;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * hd + c) =
            __floats2bfloat162_rn(acc[d][2 * h] * scale[h],
                                  acc[d][2 * h + 1] * scale[h]);
    }
  }
}

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

}  // namespace
