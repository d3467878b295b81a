// Selective scan (K7, the Mamba1 recurrence) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `ssm_scan_kernel` in
// src/repro/kernels/ssm_scan.py and its chunked entry `ssm_scan_chunked`,
// which launches it once per chunk with the state carried between launches
// (the port's `ops.ssm_scan_chunked` is one launch over all T: the same
// bits, see below).  Reached from `ops.ssm_scan` / `ops.ssm_scan_chunked`,
// which every Mamba1 layer of the port calls: `mamba1_chunk` for a prefill
// chunk, `mamba1_decode_step` at T = 1, and `mamba1_forward` for the dense
// prefill.
//
//   h_t = a_t * h_{t-1} + b_t          a, b (B, T, D, N) f32
//   y_t = sum_n h_t[:, n] * c_t[n]     c (B, T, N) f32, y (B, T, D) f32
//   h_0 = h0 (B, D, N), h_last = h_T (B, D, N), all f32
//
// Layouts: within one batch row, a and b are (T, D, N) contiguous, c is
// (T, N) contiguous and y (T, D) contiguous; the batch strides are passed
// in, so a caller may hand in views of a slice of a longer sequence
// without copying them.  h0 and h_last are contiguous (B, D, N).
// N is a power of two up to 32 (the wrapper checks).
//
// Design.  The TPU kernel tiles D over a sequential grid and keeps one
// (block_d, N) state tile in on-chip scratch while a fori_loop walks T.
// Here one thread owns one (b, d, n) state element and keeps it in a
// register for the whole walk over T; the N threads of one d are N
// neighbouring lanes of a warp, and y_t is their butterfly sum
// (__shfl_xor_sync over offsets N/2 .. 1, a fixed order).  Block = 256
// threads = 256 / N values of d; grid = (ceil(D * N / 256), B).  At
// falcon-mamba-7b's widths (D = 8,192, N = 16) a prefill chunk (B = 1) has
// 131,072 threads, 512 blocks, about four per SM on 132 SMs; a decode step
// (B = 8) 4,096 blocks.  (The alternative, one thread per d holding its N
// states in registers, gives only 8,192 threads at B = 1, some 64 blocks,
// and leaves half the SMs idle; it would also read a and b with a stride of
// N floats between neighbouring lanes.)  Neighbouring lanes read
// neighbouring floats of a and b, so every load of a step is one coalesced
// 128-byte line per warp, and the loads of later steps do not depend on h,
// so the unrolled loop keeps several steps' loads in flight.
//
// The update is written as __fmul_rn then __fadd_rn, never a fused
// multiply-add: the state is rounded exactly as the plain sequential
// version rounds it (ref.ssm_scan_ref), and a step with a = 1, b = 0 (the
// identity pad of a ragged chunk, or a masked prompt position) leaves h
// unchanged.  So a scan split into chunks, each launch resuming from the
// previous launch's h_last (the engine's chunked prefill, one launch per
// dispatch), gives the same bits as one launch.
//
// Bound on the H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32): bytes.  Per
// (t, d, n) the kernel reads 8 bytes of a and b and does 4 flops; c and y
// are 1/D and 1/N of that.  A prefill chunk (B = 1, T = 256) moves 268 MB
// (about 80 us); a decode step (B = 8, T = 1) moves a, b, h0 and h_last,
// 16.8 MB (about 5 us).  The discretisation that makes a and b
// (a = exp(dt * A), b = dt * B * x) stays outside the kernel, as in the TPU
// kernel's interface, so a and b go through device memory once each way;
// fusing it would cut the bytes by about 16x and is later work.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last, int T,
                int D, long long ab_bstride, long long c_bstride,
                long long y_bstride) {
  const long long bi = blockIdx.y;
  const long long dn = (long long)D * N;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = pair < dn;         // a whole group of N lanes is live
  const int n = threadIdx.x & (N - 1);
  const float* ap = a + bi * ab_bstride + pair;
  const float* bp = b + bi * ab_bstride + pair;
  const float* cp = c + bi * c_bstride + n;
  float* yp = y + bi * y_bstride + pair / N;
  float h = live ? h0[bi * dn + pair] : 0.0f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    float at = 1.0f, bt = 0.0f;
    if (live) {
      at = __ldg(ap + (long long)t * dn);
      bt = __ldg(bp + (long long)t * dn);
    }
    const float ct = __ldg(cp + (long long)t * N);
    h = __fadd_rn(__fmul_rn(at, h), bt);
    float s = __fmul_rn(h, ct);
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (live && n == 0) yp[(long long)t * D] = s;
  }
  if (live) h_last[bi * dn + pair] = h;
}

template <int N>
cudaError_t launch(const float* a, const float* b, const float* c,
                   const float* h0, float* y, float* h_last, int B, int T,
                   int D, long long ab_bs, long long c_bs, long long y_bs,
                   cudaStream_t stream) {
  const long long dn = (long long)D * N;
  const dim3 grid((unsigned)((dn + THREADS - 1) / THREADS), (unsigned)B);
  ssm_scan_kernel<N><<<grid, THREADS, 0, stream>>>(a, b, c, h0, y, h_last, T,
                                                   D, ab_bs, c_bs, y_bs);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = success); the kernel runs
// asynchronously on `stream`.  Strides are in floats.
extern "C" int repro_ssm_scan(const void* a, const void* b, const void* c,
                              const void* h0, void* y, void* h_last, int B,
                              int T, int D, int N, long long ab_bstride,
                              long long c_bstride, long long y_bstride,
                              void* stream) {
  if (B < 0 || T < 0 || D < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  if ((long long)D * N / THREADS + 1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pc = static_cast<const float*>(c);
  const float* ph = static_cast<const float*>(h0);
  float* py = static_cast<float*>(y);
  float* pl = static_cast<float*>(h_last);
  switch (N) {
    case 1: return (int)launch<1>(pa, pb, pc, ph, py, pl, B, T, D, ab_bstride,
                                  c_bstride, y_bstride, s);
    case 2: return (int)launch<2>(pa, pb, pc, ph, py, pl, B, T, D, ab_bstride,
                                  c_bstride, y_bstride, s);
    case 4: return (int)launch<4>(pa, pb, pc, ph, py, pl, B, T, D, ab_bstride,
                                  c_bstride, y_bstride, s);
    case 8: return (int)launch<8>(pa, pb, pc, ph, py, pl, B, T, D, ab_bstride,
                                  c_bstride, y_bstride, s);
    case 16: return (int)launch<16>(pa, pb, pc, ph, py, pl, B, T, D,
                                    ab_bstride, c_bstride, y_bstride, s);
    case 32: return (int)launch<32>(pa, pb, pc, ph, py, pl, B, T, D,
                                    ab_bstride, c_bstride, y_bstride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
