// Selective scan (K7, the Mamba1 recurrence) and its gradient for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `ssm_scan_kernel` in
// src/repro/kernels/ssm_scan.py and its chunked entry `ssm_scan_chunked`,
// which launches it once per chunk with the state carried between launches
// (the port's `ops.ssm_scan_chunked` is one launch over all T: the same
// bits, see below).  Reached from `ops.ssm_scan` / `ops.ssm_scan_chunked`,
// which every Mamba1 layer of the port calls: `mamba1_chunk` for a prefill
// chunk, `mamba1_decode_step` at T = 1, and `mamba1_forward` for the dense
// prefill.  Under autograd (`ssm_scan.SSMScanFn`, the training loss of
// the ssm family) the forward also writes state checkpoints, and the
// backward kernels below give the gradient.
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
//
// Backward (the TPU kernel has none; the JAX package trains through
// autodiff of its jnp associative scan, and this is that gradient).  Given
// dy (B, T, D) and dh_last (B, D, N) or zero, with g_t = dL/dh_t:
//
//   g_{T-1} = dy_{T-1}[d] c_{T-1}[n] + dh_last
//   g_t     = dy_t[d] c_t[n] + a_{t+1} g_{t+1}
//   da_t = g_t h_{t-1} (h_{-1} = h0),  db_t = g_t,  dh0 = a_0 g_0,
//   dc_t[n] = sum_d dy_t[d] h_t[d, n].
//
// h_{t-1} is needed in reverse order.  The forward run under autograd
// writes the state every WINDOW = 16 steps, ckpt (B, ceil(T/16), D, N)
// (ckpt[:, w] = h before step 16 w, so ckpt[:, 0] = h0): 1/16 of a's bytes,
// 134 MB at the training shape (B 8, T 512, D 8,192, N 16) against 2.15 GB
// for the whole history.  The backward keeps the forward's thread mapping
// (one thread a (b, d, n)) and walks the windows from the last: it rebuilds
// the window's 16 states from its checkpoint into registers, reading a and
// b once (the same __fmul_rn/__fadd_rn steps as the forward, so the states
// are the forward's bits), keeps the window's a in registers too, then
// walks the window backwards with g in a register, writing da and db.  So
// a and b are read once and da and db written once, as the bound counts.
// dc is a sum over D with no atomics: each thread's dy_t h_t is summed over
// the d values of its warp (__shfl_xor_sync over offsets N .. 16), the
// warps' sums meet in shared memory and are added in warp (d) order into the
// block's partial, part (B, T, ceil(D N / 256), N), once a window; a second
// launch adds each (b, t, n)'s partials in block order.  Every sum has one
// fixed order, so two runs give the same bits (the restart replay of
// training rests on it).  The rounding of g, da, db and dh0 is
// ref.ssm_scan_bwd_ref's step for step: the kernel and the plain version
// agree to the bit there, and dc to f32 reassociation.
//
// Backward bound (bytes, H100 3.35 TB/s): read a and b, write da and db,
// plus the checkpoints and dy (1/16 of a's bytes each), c, dh_last, dc and
// dh0; about 8.9 GB at the training shape, 2.6 ms.  The partials (two
// passes over 1/16 of a's bytes) are the design's own cost.  No single
// PyTorch call computes the gradient.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WINDOW = 16;   // steps between the forward's state checkpoints

// CKPT: also write h before every WINDOW-th step into ckpt (the serve path
// instantiates it false: the same code and bits as before checkpoints).
template <int N, bool CKPT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ ckpt, int T, int D, long long ab_bstride,
                long long c_bstride, long long y_bstride) {
  const long long bi = blockIdx.y;
  const long long dn = (long long)D * N;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = pair < dn;         // a whole group of N lanes is live
  const int n = threadIdx.x & (N - 1);
  const float* ap = a + bi * ab_bstride + pair;
  const float* bp = b + bi * ab_bstride + pair;
  const float* cp = c + bi * c_bstride + n;
  float* yp = y + bi * y_bstride + pair / N;
  float* kp = CKPT ? ckpt + bi * ((T + WINDOW - 1) / WINDOW) * dn + pair
                   : nullptr;
  float h = live ? h0[bi * dn + pair] : 0.0f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    if (CKPT && live && t % WINDOW == 0) kp[(long long)(t / WINDOW) * dn] = h;
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

// The gradient, windows from the last (see the header).  dh_last may be
// null (zero).  da and db share a's batch stride; part is (B, T, nblk, N).
template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c,
                    const float* __restrict__ ckpt,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    float* __restrict__ da, float* __restrict__ db,
                    float* __restrict__ dh0, float* __restrict__ part, int T,
                    int D, long long ab_bstride, long long c_bstride,
                    long long y_bstride) {
  __shared__ float red[WINDOW][WARPS][N];
  const long long bi = blockIdx.y;
  const long long dn = (long long)D * N;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = pair < dn;
  const int n = threadIdx.x & (N - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (T + WINDOW - 1) / WINDOW;
  const long long nblk = gridDim.x;
  const float* ap = a + bi * ab_bstride + pair;
  const float* bp = b + bi * ab_bstride + pair;
  float* dap = da + bi * ab_bstride + pair;
  float* dbp = db + bi * ab_bstride + pair;
  const float* cp = c + bi * c_bstride + n;
  const float* dyp = dy + bi * y_bstride + pair / N;
  const float* kp = ckpt + bi * nw * dn + pair;
  float carry = (live && dh_last != nullptr) ? dh_last[bi * dn + pair] : 0.0f;
  for (int w = nw - 1; w >= 0; --w) {
    const int s = w * WINDOW;
    // hw[i] = h before step s + i, hw[i + 1] after it
    float hw[WINDOW + 1], aw[WINDOW];
    hw[0] = live ? kp[(long long)w * dn] : 0.0f;
#pragma unroll
    for (int i = 0; i < WINDOW; ++i) {
      float at = 1.0f, bt = 0.0f;
      if (live && s + i < T) {
        at = __ldg(ap + (long long)(s + i) * dn);
        bt = __ldg(bp + (long long)(s + i) * dn);
      }
      aw[i] = at;
      hw[i + 1] = __fadd_rn(__fmul_rn(at, hw[i]), bt);
    }
#pragma unroll
    for (int i = WINDOW - 1; i >= 0; --i) {
      const long long t = s + i;
      float p = 0.0f;
      if (t < T) {                     // the same for every thread
        const float dyt = live ? __ldg(dyp + t * D) : 0.0f;
        const float g = __fadd_rn(__fmul_rn(dyt, __ldg(cp + t * N)), carry);
        if (live) {
          dap[t * dn] = __fmul_rn(g, hw[i]);
          dbp[t * dn] = g;
        }
        carry = __fmul_rn(aw[i], g);
        p = __fmul_rn(dyt, hw[i + 1]);
      }
#pragma unroll
      for (int off = N; off < 32; off <<= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      if (lane < N) red[i][warp][lane] = p;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < WINDOW * N; k += THREADS) {
      const int i = k / N, nn = k % N;
      if (s + i < T) {
        float sum = red[i][0][nn];
#pragma unroll
        for (int wp = 1; wp < WARPS; ++wp) sum = __fadd_rn(sum, red[i][wp][nn]);
        part[((bi * T + s + i) * nblk + blockIdx.x) * N + nn] = sum;
      }
    }
    __syncthreads();
  }
  if (live) dh0[bi * dn + pair] = carry;
}

// dc[r, n] = the sum of part[r, k, n] over k in block order; r = b T + t.
__global__ void __launch_bounds__(THREADS)
ssm_scan_dc_kernel(const float* __restrict__ part, float* __restrict__ dc,
                   long long total, int nblk, int N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const float* p = part + (i / N) * nblk * N + i % N;
  float s = __ldg(p);
  for (int k = 1; k < nblk; ++k) s = __fadd_rn(s, __ldg(p + (long long)k * N));
  dc[i] = s;
}

// Calls f(std::integral_constant<int, N>) for the state sizes the kernels
// take: N lanes of one warp per d.
template <typename F>
cudaError_t with_state(int N, F&& f) {
  switch (N) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int T, int D, int N) {
  return B < 0 || T < 0 || D < 0 || N < 1 || B > 65535
      || (long long)D * N / THREADS + 1 > 0x7fffffffLL;
}

}  // namespace

// Returns the launch's cudaError_t (0 = success); the kernel runs
// asynchronously on `stream`.  Strides are in floats.  ckpt is null on the
// serve path; otherwise (B, ceil(T / window), D, N) contiguous, and window
// must be the kernels' WINDOW (repro_ssm_scan_window).
extern "C" int repro_ssm_scan(const void* a, const void* b, const void* c,
                              const void* h0, void* y, void* h_last,
                              void* ckpt, int window, int B, int T, int D,
                              int N, long long ab_bstride,
                              long long c_bstride, long long y_bstride,
                              void* stream) {
  if (bad_shape(B, T, D, N) || (ckpt != nullptr && window != WINDOW))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const long long dn = (long long)D * N;
  const dim3 grid((unsigned)((dn + THREADS - 1) / THREADS), (unsigned)B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pc = static_cast<const float*>(c);
  const float* ph = static_cast<const float*>(h0);
  float* py = static_cast<float*>(y);
  float* pl = static_cast<float*>(h_last);
  float* pk = static_cast<float*>(ckpt);
  return (int)with_state(N, [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    if (pk != nullptr)
      ssm_scan_kernel<NN, true><<<grid, THREADS, 0, st>>>(
          pa, pb, pc, ph, py, pl, pk, T, D, ab_bstride, c_bstride, y_bstride);
    else
      ssm_scan_kernel<NN, false><<<grid, THREADS, 0, st>>>(
          pa, pb, pc, ph, py, pl, pk, T, D, ab_bstride, c_bstride, y_bstride);
    return cudaGetLastError();
  });
}

extern "C" int repro_ssm_scan_window() { return WINDOW; }

// The gradient: two launches (the windowed backward, then dc's ordered
// column sum).  a, b, da and db share ab_bstride, dy has y_bstride, c
// c_bstride; ckpt is the forward's (window WINDOW), dh_last null for zero;
// dc (B, T, N), dh0 (B, D, N) and part (B, T, ceil(D N / 256), N) are
// contiguous.
extern "C" int repro_ssm_scan_bwd(const void* a, const void* b,
                                  const void* c, const void* ckpt,
                                  const void* dy, const void* dh_last,
                                  void* da, void* db, void* dc, void* dh0,
                                  void* part, int window, int B, int T, int D,
                                  int N, long long ab_bstride,
                                  long long c_bstride, long long y_bstride,
                                  void* stream) {
  if (bad_shape(B, T, D, N) || window != WINDOW)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const long long dn = (long long)D * N;
  const int nblk = (int)((dn + THREADS - 1) / THREADS);
  const dim3 grid((unsigned)nblk, (unsigned)B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_state(N, [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    ssm_scan_bwd_kernel<NN><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<const float*>(ckpt),
        static_cast<const float*>(dy), static_cast<const float*>(dh_last),
        static_cast<float*>(da), static_cast<float*>(db),
        static_cast<float*>(dh0), static_cast<float*>(part), T, D,
        ab_bstride, c_bstride, y_bstride);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * T * N;
  if (total == 0) return 0;
  ssm_scan_dc_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                       0, st>>>(static_cast<const float*>(part),
                                static_cast<float*>(dc), total, nblk, N);
  return (int)cudaGetLastError();
}
