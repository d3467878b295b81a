// Selective scan (K7, the Mamba1 recurrence) and its gradient for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `ssm_scan_kernel` in
// src/repro/kernels/ssm_scan.py and its chunked entry `ssm_scan_chunked`,
// which launches it once per chunk with the state carried between launches
// (the port's scan is one launch over all T: the same bits, see below).
//
//   h_t = a_t * h_{t-1} + b_t          a, b (B, T, D, N) f32
//   y_t = sum_n h_t[:, n] * c_t[n]     c (B, T, N), y (B, T, D) f32
//   h_0 = h0 (B, D, N), h_last = h_T (B, D, N), all f32
//
// Two interfaces, one kernel template (`ssm_scan_kernel`, over a policy
// that says where a step's a_t, b_t and c_t come from):
//
// - Loaded: a, b and c f32 from device memory, the TPU kernel's own
//   interface (`repro_ssm_scan`; `ops.ssm_scan` / `ops.ssm_scan_chunked`).
// - Fused: Mamba1's discretisation computed in registers from the layer's
//   own tensors (`repro_ssm_scan_fused`; `ops.ssm_scan_fused`, which every
//   Mamba1 layer of the port calls: `mamba1_chunk` for a prefill chunk,
//   `mamba1_decode_step` at T = 1, `mamba1_forward` for the dense prefill
//   and the ssm family's training loss):
//
//     a_t = exp(dt_t * A),  b_t = (dt_t * B_t) * x_t,  c_t = C_t
//
//   with dt (B, T, D) f32 after softplus, x (B, T, D) in the model's dtype
//   (f32 or bf16), B and C (B, T, N) in the model's dtype (slices of the
//   layer's projection: rows of any stride, unit stride along N), A (D, N)
//   f32.  The products are _discretise's (models/mamba.py), each rounded
//   (__fmul_rn, never a fused multiply-add), and exp is expf, the function
//   torch.exp runs on CUDA, so the fused scan aims at the bits of the
//   discretisation in torch ops followed by the Loaded scan.  A masked
//   position (dt = 0) is a = exp(0) = 1 and b = 0 exactly: the identity
//   step below.
//
// Layouts: within one batch row, a and b are (T, D, N) contiguous, c is
// (T, N) contiguous and y (T, D) contiguous; the batch strides are passed
// in, so a caller may hand in views of a slice of a longer sequence
// without copying them.  dt and x are contiguous (B, T, D); h0 and h_last
// contiguous (B, D, N).  N is a power of two up to 32 (the wrapper checks).
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
// and leaves half the SMs idle.)  The forward walks T a window of WINDOW
// = 16 steps at a time: it first loads the window's inputs, all at once,
// then runs its 16 steps.  (Loaded one step at a time, every step waited
// out a device-memory latency: a store to y might alias an input, so the
// compiler keeps each load behind the stores of the steps before it; the
// fused forward at the training shape took 1.8 ms so, 1.1-1.2 ms staged,
// NVIDIA H100 80GB HBM3.)  Loaded: each thread loads its own 16 a and b
// into registers (neighbouring lanes, neighbouring floats: one coalesced
// 128-byte line per warp and step), and the block its 16 c rows into
// shared memory.  Fused: the block loads the window's dt and x for its
// 256 / N values of d and its B and C rows into a shared-memory tile (1
// to 32 KB), from which the N lanes of one d read dt and x and every d
// reads B and C; A[d, n] stays in a register.
//
// The update is written as __fmul_rn then __fadd_rn, never a fused
// multiply-add: the state is rounded exactly as the plain sequential
// version rounds it (ref.ssm_scan_ref), and a step with a = 1, b = 0 (the
// identity pad of a ragged chunk, or a masked prompt position) leaves h
// unchanged.  So a scan split into chunks, each launch resuming from the
// previous launch's h_last (the engine's chunked prefill, one launch per
// dispatch), gives the same bits as one launch.
//
// Bounds on the H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32; CUDA's
// throughput table: 16 exp2 results a clock an SM on the special function
// units, 4.2 T/s at 1,980 MHz).  Loaded: bytes; per (t, d, n) it reads 8
// bytes of a and b and does 4 flops.  A prefill chunk (B = 1, T = 256)
// moves 268 MB (about 80 us).  Fused: per (t, d) it reads 6-8 bytes of dt
// and x and writes 4 of y, 1/16 of the Loaded bytes at N = 16, and per
// (t, d, n) it computes one expf and six rounded products and sums: at a
// prefill chunk the operations bound it (8 us), at the training shape the
// checkpoints' bytes (0.14 ms).  Neither is what holds it back: its time
// is the dependent chain of a step (expf, the update, the butterfly's
// shuffles) over the warps an SM holds.
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
// for the whole history.  Each backward keeps the forward's thread mapping
// (one thread a (b, d, n)) and walks the windows from the last: it rebuilds
// the window's 16 states from its checkpoint into registers (the same
// steps as the forward, through the same policy, so the states are the
// forward's bits), then walks the window backwards with g in a register.
// dc is a sum over D with no atomics: each thread's dy_t h_t is summed over
// the d values of its warp (__shfl_xor_sync over offsets N .. 16), the
// warps' sums meet in shared memory and are added in warp (d) order into
// the block's partial, part (B, T, ceil(D N / 256), N), once a window; a
// second launch adds each (b, t, n)'s partials in block order.  Every sum
// has one fixed order, so two runs give the same bits (the restart replay
// of training rests on it).
//
// - Loaded (`repro_ssm_scan_bwd`): keeps the window's a in registers too,
//   writes da and db (B, T, D, N); their rounding, and dh0's, is
//   ref.ssm_scan_bwd_ref's step for step (the kernel and the plain version
//   agree to the bit there, and dc to f32 reassociation).  Bound: bytes,
//   about 8.9 GB at the training shape, 2.6 ms.
// - Fused (`repro_ssm_scan_fused_bwd`): writes the layer's gradients and
//   never da or db.  In the reverse walk it recomputes a_t from dt_t (no
//   window of a in registers), and with u = (g_t h_{t-1}) a_t (da's
//   gradient through exp) and v = g_t x_t (db's through the product):
//
//     d(dt)_t[d] = sum_n (u A[d, n] + v B_t[n])     butterfly over N lanes
//     dx_t[d]    = sum_n g_t (dt_t B_t[n])          butterfly over N lanes
//     dB_t[n]    = sum_d v dt_t                     as dc: warps, partials
//     dC_t[n]    = sum_d dy_t[d] h_t[d, n]          (dc above)
//     dA[d, n]   = sum_{b,t} u dt_t                 a register over t (in
//                  reverse), one (B, D, N) partial, summed over b in order
//
//   The second launch adds dB's and dC's partials in block order (rounding
//   them once to the model's dtype) and dA's over b.  With a_t recomputed
//   and no window of a held, a thread needs 64 registers at N = 16 (the
//   Loaded backward 114).  Bound: about 0.7 GB of dt, x, dy, d(dt), dx and
//   the checkpoints at the training shape (0.20 ms), beside one expf and
//   about twenty rounded products and sums a (t, d, n) (0.13 and 0.18 ms);
//   it takes 5 ms there, bound like the forward by a step's dependent
//   chain.  The partials (2 x 134 MB written and read) are the design's
//   own cost.  No single PyTorch call computes the gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WINDOW = 16;   // steps between the forward's state checkpoints
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a, b and c from device memory (the TPU kernel's interface).
struct Loaded {
  const float* a;
  const float* b;
  const float* c;
  long long ab_bstride, c_bstride;   // in floats
};

// Mamba1's discretisation in registers: dt and x contiguous (B, T, D), B
// and C (B, T, N) with unit stride along N and their own batch and row
// strides (elements), A (D, N) contiguous.
template <typename XT>
struct Fused {
  const float* dt;
  const XT* x;
  const XT* bm;
  const XT* c;
  const float* A;
  long long bm_bstride, bm_tstride, c_bstride, c_tstride;
};

// One thread's view of a policy: the (b, d, n) it owns.  The forward
// stages a window of WINDOW steps' inputs (stage: one batch of
// independent loads a window), the inputs that threads share into a
// shared-memory tile (all the block's threads together: Fused's dt, x, B
// and C; Loaded's c) and the thread's own into registers (Loaded's a and
// b), then reads each step from there (step: a_t, b_t and c_t[n]).  The
// backward's walks load a step's inputs straight into registers (load,
// then ab for a_t and b_t).  A thread past D N reads the identity step
// (a = 1, b = 0).  (A step's loads issued one at a time would each wait
// out a device-memory latency: a store to y might alias an input, so the
// compiler keeps every load behind the stores of the steps before it.)
template <int N, class In>
struct Steps;

template <int N>
struct Steps<N, Loaded> {
  struct Raw {
    float a, b, c;
  };
  struct Tile {         // shared by the block
    float c[WINDOW][N];
  };
  struct Regs {         // the thread's own a and b
    float a[WINDOW], b[WINDOW];
  };
  const float* a;
  const float* b;
  const float* c;
  long long dn;
  __device__ Steps(const Loaded& in, long long bi, long long pair, int n,
                   int D, int T, bool live)
      : a(in.a + bi * in.ab_bstride + pair),
        b(in.b + bi * in.ab_bstride + pair),
        c(in.c + bi * in.c_bstride),
        dn((long long)D * N) {}
  __device__ __forceinline__ Raw load(long long t, bool live, int n) const {
    Raw r;
    r.a = live ? __ldg(a + t * dn) : 1.0f;
    r.b = live ? __ldg(b + t * dn) : 0.0f;
    r.c = __ldg(c + t * N + n);
    return r;
  }
  __device__ __forceinline__ void ab(const Raw& r, float& at,
                                     float& bt) const {
    at = r.a;
    bt = r.b;
  }
  // steps s .. s + len - 1 into the tile and the thread's registers
  __device__ __forceinline__ void stage(Tile& tl, Regs& rg, long long s,
                                        int len, bool live) const {
#pragma unroll
    for (int i = 0; i < WINDOW; ++i) {
      if (i < len) {
        rg.a[i] = live ? __ldg(a + (s + i) * dn) : 1.0f;
        rg.b[i] = live ? __ldg(b + (s + i) * dn) : 0.0f;
      }
    }
    for (int k = threadIdx.x; k < len * N; k += THREADS)
      tl.c[k / N][k % N] = __ldg(c + s * N + k);
  }
  __device__ __forceinline__ void step(const Tile& tl, const Regs& rg, int i,
                                       int n, float& at, float& bt,
                                       float& ct) const {
    at = rg.a[i];
    bt = rg.b[i];
    ct = tl.c[i][n];
  }
};

template <int N, typename XT>
struct Steps<N, Fused<XT>> {
  static constexpr int DPB = THREADS / N;   // values of d a block owns
  struct Raw {
    float dt, x, b, c;
  };
  struct Tile {         // shared by the block
    float dt[WINDOW][DPB], x[WINDOW][DPB], b[WINDOW][N], c[WINDOW][N];
  };
  struct Regs {};
  const float* dt;     // this batch row's (T, D)
  const XT* x;
  const XT* bm;        // this batch row's
  const XT* c;
  long long D, bts, cts, d;
  float A;
  __device__ Steps(const Fused<XT>& in, long long bi, long long pair, int n,
                   int D_, int T, bool live)
      : dt(in.dt + (bi * T) * D_),
        x(in.x + (bi * T) * D_),
        bm(in.bm + bi * in.bm_bstride),
        c(in.c + bi * in.c_bstride),
        D(D_),
        bts(in.bm_tstride),
        cts(in.c_tstride),
        d(pair / N),
        A(live ? __ldg(in.A + pair) : 0.0f) {}
  __device__ __forceinline__ Raw load(long long t, bool live, int n) const {
    Raw r;
    r.dt = live ? __ldg(dt + t * D + d) : 0.0f;
    r.x = live ? to_f(__ldg(x + t * D + d)) : 0.0f;
    r.b = to_f(__ldg(bm + t * bts + n));
    r.c = to_f(__ldg(c + t * cts + n));
    return r;
  }
  // a = exp(dt A), b = (dt B) x: _discretise's products, each rounded (a
  // thread past D N has dt = x = 0: a = 1, b = 0)
  __device__ __forceinline__ void ab(const Raw& r, float& at,
                                     float& bt) const {
    at = expf(__fmul_rn(r.dt, A));
    bt = __fmul_rn(__fmul_rn(r.dt, r.b), r.x);
  }
  __device__ __forceinline__ void stage(Tile& tl, Regs&, long long s,
                                        int len, bool live) const {
    const long long d0 = (long long)blockIdx.x * DPB;
    for (int k = threadIdx.x; k < len * DPB; k += THREADS) {
      const int i = k / DPB, j = k % DPB;
      const bool in_d = d0 + j < D;
      tl.dt[i][j] = in_d ? __ldg(dt + (s + i) * D + d0 + j) : 0.0f;
      tl.x[i][j] = in_d ? to_f(__ldg(x + (s + i) * D + d0 + j)) : 0.0f;
    }
    for (int k = threadIdx.x; k < len * N; k += THREADS) {
      const int i = k / N, nn = k % N;
      tl.b[i][nn] = to_f(__ldg(bm + (s + i) * bts + nn));
      tl.c[i][nn] = to_f(__ldg(c + (s + i) * cts + nn));
    }
  }
  __device__ __forceinline__ void step(const Tile& tl, const Regs&, int i,
                                       int n, float& at, float& bt,
                                       float& ct) const {
    Raw r;
    r.dt = tl.dt[i][threadIdx.x / N];
    r.x = tl.x[i][threadIdx.x / N];
    r.b = tl.b[i][n];
    ab(r, at, bt);
    ct = tl.c[i][n];
  }
};

// The scan, a window of WINDOW steps at a time from a shared-memory tile.
// CKPT: also write h before every WINDOW-th step into ckpt (the serve path
// instantiates it false: the same code and bits as without checkpoints).
// y has batch stride y_bstride (floats).
template <int N, bool CKPT, class In>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const In in, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ ckpt, int T, int D,
                long long y_bstride) {
  __shared__ typename Steps<N, In>::Tile tile;
  typename Steps<N, In>::Regs regs;
  const long long bi = blockIdx.y;
  const long long dn = (long long)D * N;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = pair < dn;         // a whole group of N lanes is live
  const int n = threadIdx.x & (N - 1);
  const Steps<N, In> st(in, bi, pair, n, D, T, live);
  float* yp = y + bi * y_bstride + pair / N;
  float* kp = CKPT ? ckpt + bi * ((T + WINDOW - 1) / WINDOW) * dn + pair
                   : nullptr;
  float h = live ? h0[bi * dn + pair] : 0.0f;
  for (int s = 0; s < T; s += WINDOW) {
    const int len = min(WINDOW, T - s);
    if (s > 0) __syncthreads();        // the last window's tile is read
    st.stage(tile, regs, s, len, live);
    __syncthreads();
    if (CKPT && live) kp[(long long)(s / WINDOW) * dn] = h;
#pragma unroll
    for (int i = 0; i < WINDOW; ++i) {
      if (i < len) {                   // the same for every thread
        float at, bt, ct;
        st.step(tile, regs, i, n, at, bt, ct);
        h = __fadd_rn(__fmul_rn(at, h), bt);
        float sum = __fmul_rn(h, ct);
#pragma unroll
        for (int off = N / 2; off > 0; off >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
        if (live && n == 0) yp[(long long)(s + i) * D] = sum;
      }
    }
  }
  if (live) h_last[bi * dn + pair] = h;
}

// The Loaded gradient, windows from the last (see the header).  dh_last may
// be null (zero).  da and db share a's batch stride; part is (B, T, nblk,
// N).
template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const Loaded in, const float* __restrict__ ckpt,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_last,
                    float* __restrict__ da, float* __restrict__ db,
                    float* __restrict__ dh0, float* __restrict__ part, int T,
                    int D, long long y_bstride) {
  __shared__ float red[WINDOW][WARPS][N];
  const long long bi = blockIdx.y;
  const long long dn = (long long)D * N;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = pair < dn;
  const int n = threadIdx.x & (N - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (T + WINDOW - 1) / WINDOW;
  const long long nblk = gridDim.x;
  const Steps<N, Loaded> st(in, bi, pair, n, D, T, live);
  float* dap = da + bi * in.ab_bstride + pair;
  float* dbp = db + bi * in.ab_bstride + pair;
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
      if (s + i < T) st.ab(st.load(s + i, live, n), at, bt);
      aw[i] = at;
      hw[i + 1] = __fadd_rn(__fmul_rn(at, hw[i]), bt);
    }
#pragma unroll
    for (int i = WINDOW - 1; i >= 0; --i) {
      const long long t = s + i;
      float p = 0.0f;
      if (t < T) {                     // the same for every thread
        const float dyt = live ? __ldg(dyp + t * D) : 0.0f;
        const float g = __fadd_rn(__fmul_rn(dyt, __ldg(st.c + t * N + n)),
                                  carry);
        if (live) {
          dap[t * dn] = __fmul_rn(g, hw[i]);
          dbp[t * dn] = g;
        }
        carry = __fmul_rn(aw[i], g);
        p = __fmul_rn(dyt, hw[i + 1]);
      }
#pragma unroll
      for (int off = N; off < 32; off <<= 1)
        p = __fadd_rn(p, __shfl_xor_sync(FULL, p, off));
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

// The Fused gradient, windows from the last (see the header).  dh_last may
// be null (zero).  ddt (f32) and dx (XT) are contiguous (B, T, D); part is
// (2, B, T, nblk, N): dC's partials, then dB's; dA_part (B, D, N).
template <int N, typename XT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fused_bwd_kernel(const Fused<XT> in, const float* __restrict__ ckpt,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ ddt, XT* __restrict__ dx,
                          float* __restrict__ dh0,
                          float* __restrict__ dA_part,
                          float* __restrict__ part, int T, int D) {
  using Raw = typename Steps<N, Fused<XT>>::Raw;
  __shared__ float red[2][WINDOW][WARPS][N];   // dC's and dB's warp sums
  const long long bi = blockIdx.y;
  const long long dn = (long long)D * N;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = pair < dn;
  const int n = threadIdx.x & (N - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (T + WINDOW - 1) / WINDOW;
  const long long nblk = gridDim.x;
  const long long half = (long long)gridDim.y * T * nblk * N;  // dB's offset
  const Steps<N, Fused<XT>> st(in, bi, pair, n, D, T, live);
  const long long row = (bi * T) * D + pair / N;   // (b, t = 0, d)
  const float* dyp = dy + row;
  float* ddtp = ddt + row;
  XT* dxp = dx + row;
  const float* kp = ckpt + bi * nw * dn + pair;
  float carry = (live && dh_last != nullptr) ? dh_last[bi * dn + pair] : 0.0f;
  float dA = 0.0f;
  for (int w = nw - 1; w >= 0; --w) {
    const int s = w * WINDOW;
    // hw[i] = h before step s + i, hw[i + 1] after it
    float hw[WINDOW + 1];
    hw[0] = live ? kp[(long long)w * dn] : 0.0f;
#pragma unroll
    for (int i = 0; i < WINDOW; ++i) {
      float at = 1.0f, bt = 0.0f;
      if (s + i < T) st.ab(st.load(s + i, live, n), at, bt);
      hw[i + 1] = __fadd_rn(__fmul_rn(at, hw[i]), bt);
    }
#pragma unroll
    for (int i = WINDOW - 1; i >= 0; --i) {
      const long long t = s + i;
      float pc = 0.0f, pb = 0.0f;
      if (t < T) {                     // the same for every thread
        const Raw r = st.load(t, live, n);
        const float dyt = live ? __ldg(dyp + t * D) : 0.0f;
        const float at = expf(__fmul_rn(r.dt, st.A));
        const float g = __fadd_rn(__fmul_rn(dyt, r.c), carry);
        const float u = __fmul_rn(__fmul_rn(g, hw[i]), at);
        const float v = __fmul_rn(g, r.x);
        float pdt = __fadd_rn(__fmul_rn(u, st.A), __fmul_rn(v, r.b));
        float pdx = __fmul_rn(g, __fmul_rn(r.dt, r.b));
        dA = __fadd_rn(dA, __fmul_rn(u, r.dt));
        pb = __fmul_rn(v, r.dt);
        pc = __fmul_rn(dyt, hw[i + 1]);
        carry = __fmul_rn(at, g);
#pragma unroll
        for (int off = N / 2; off > 0; off >>= 1) {
          pdt = __fadd_rn(pdt, __shfl_xor_sync(FULL, pdt, off));
          pdx = __fadd_rn(pdx, __shfl_xor_sync(FULL, pdx, off));
        }
        if (live && n == 0) {
          ddtp[t * D] = pdt;
          put(dxp + t * D, pdx);
        }
      }
#pragma unroll
      for (int off = N; off < 32; off <<= 1) {
        pc = __fadd_rn(pc, __shfl_xor_sync(FULL, pc, off));
        pb = __fadd_rn(pb, __shfl_xor_sync(FULL, pb, off));
      }
      if (lane < N) {
        red[0][i][warp][lane] = pc;
        red[1][i][warp][lane] = pb;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 2 * WINDOW * N; k += THREADS) {
      const int r = k / (WINDOW * N), i = (k / N) % WINDOW, nn = k % N;
      if (s + i < T) {
        float sum = red[r][i][0][nn];
#pragma unroll
        for (int wp = 1; wp < WARPS; ++wp)
          sum = __fadd_rn(sum, red[r][i][wp][nn]);
        part[r * half + ((bi * T + s + i) * nblk + blockIdx.x) * N + nn] =
            sum;
      }
    }
    __syncthreads();
  }
  if (live) {
    dh0[bi * dn + pair] = carry;
    dA_part[bi * dn + pair] = dA;
  }
}

// The Fused gradient's second launch: dC then dB (rows = B T N values
// each) as the sum of their partials over blocks in block order, rounded
// once to XT; then dA (dn values) as the sum of its partials over b in
// order.
template <typename XT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fused_finish_kernel(const float* __restrict__ part,
                             const float* __restrict__ dA_part,
                             XT* __restrict__ dC, XT* __restrict__ dB,
                             float* __restrict__ dA, long long rows,
                             int nblk, int N, long long dn, int B) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < 2 * rows) {
    const long long r = i / rows, j = i % rows;
    const float* p = part + r * rows * nblk + (j / N) * nblk * N + j % N;
    float s = __ldg(p);
    for (int k = 1; k < nblk; ++k)
      s = __fadd_rn(s, __ldg(p + (long long)k * N));
    put((r == 0 ? dC : dB) + j, s);
  } else if (i < 2 * rows + dn) {
    const long long j = i - 2 * rows;
    float s = __ldg(dA_part + j);
    for (int b = 1; b < B; ++b) s = __fadd_rn(s, __ldg(dA_part + b * dn + j));
    dA[j] = s;
  }
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

// Calls f(XT{}) for the model dtypes the fused entries take.
template <typename F>
cudaError_t with_dtype(int bf16, F&& f) {
  return bf16 ? f(__nv_bfloat16{}) : f(float{});
}

bool bad_shape(int B, int T, int D, int N) {
  return B < 0 || T < 0 || D < 0 || N < 1 || B > 65535
      || (long long)D * N / THREADS + 1 > 0x7fffffffLL;
}

template <int N, class In>
cudaError_t launch_scan(const dim3& grid, cudaStream_t st, const In& in,
                        const float* h0, float* y, float* h_last, float* ckpt,
                        int T, int D, long long y_bstride) {
  if (ckpt != nullptr)
    ssm_scan_kernel<N, true, In><<<grid, THREADS, 0, st>>>(
        in, h0, y, h_last, ckpt, T, D, y_bstride);
  else
    ssm_scan_kernel<N, false, In><<<grid, THREADS, 0, st>>>(
        in, h0, y, h_last, ckpt, T, D, y_bstride);
  return cudaGetLastError();
}

dim3 scan_grid(int B, int D, int N) {
  const long long dn = (long long)D * N;
  return dim3((unsigned)((dn + THREADS - 1) / THREADS), (unsigned)B);
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
  const Loaded in{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(c), ab_bstride, c_bstride};
  return (int)with_state(N, [&](auto nn) {
    return launch_scan<decltype(nn)::value>(
        scan_grid(B, D, N), static_cast<cudaStream_t>(stream), in,
        static_cast<const float*>(h0), static_cast<float*>(y),
        static_cast<float*>(h_last), static_cast<float*>(ckpt), T, D,
        y_bstride);
  });
}

// The fused scan: dt (f32) and x contiguous (B, T, D); bm and c (B, T, N)
// with unit stride along N and the batch and row strides given (elements);
// A (D, N)
// f32; x, bm and c bf16 when bf16 is nonzero, else f32.  y (B, T, D), h0
// and h_last (B, D, N) f32 contiguous; ckpt as repro_ssm_scan's.
extern "C" int repro_ssm_scan_fused(const void* dt, const void* x,
                                    const void* bm, const void* c,
                                    const void* A, const void* h0, void* y,
                                    void* h_last, void* ckpt, int window,
                                    int bf16, int B, int T, int D, int N,
                                    long long bm_bstride,
                                    long long bm_tstride,
                                    long long c_bstride, long long c_tstride,
                                    void* stream) {
  if (bad_shape(B, T, D, N) || (ckpt != nullptr && window != WINDOW))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  return (int)with_dtype(bf16, [&](auto xt) {
    using XT = decltype(xt);
    const Fused<XT> in{static_cast<const float*>(dt),
                       static_cast<const XT*>(x), static_cast<const XT*>(bm),
                       static_cast<const XT*>(c),
                       static_cast<const float*>(A), bm_bstride, bm_tstride,
                       c_bstride, c_tstride};
    return with_state(N, [&](auto nn) {
      return launch_scan<decltype(nn)::value>(
          scan_grid(B, D, N), static_cast<cudaStream_t>(stream), in,
          static_cast<const float*>(h0), static_cast<float*>(y),
          static_cast<float*>(h_last), static_cast<float*>(ckpt), T, D,
          (long long)T * D);
    });
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
  const dim3 grid = scan_grid(B, D, N);
  const int nblk = (int)grid.x;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Loaded in{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(c), ab_bstride, c_bstride};
  cudaError_t err = with_state(N, [&](auto nn) {
    ssm_scan_bwd_kernel<decltype(nn)::value><<<grid, THREADS, 0, st>>>(
        in, static_cast<const float*>(ckpt), static_cast<const float*>(dy),
        static_cast<const float*>(dh_last), static_cast<float*>(da),
        static_cast<float*>(db), static_cast<float*>(dh0),
        static_cast<float*>(part), T, D, y_bstride);
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

// The fused gradient: two launches (the windowed backward, then the ordered
// sums of dC's, dB's and dA's partials).  Inputs as repro_ssm_scan_fused's,
// with ckpt the fused forward's (window WINDOW), dy contiguous (B, T, D)
// f32, dh_last null for zero.  Outputs contiguous: ddt (B, T, D) f32, dx
// (B, T, D), dbm and dc (B, T, N) in x's dtype, dA (D, N) and dh0 (B, D, N)
// f32; scratch part (2, B, T, ceil(D N / 256), N) and dA_part (B, D, N)
// f32.
extern "C" int repro_ssm_scan_fused_bwd(
    const void* dt, const void* x, const void* bm, const void* c,
    const void* A, const void* ckpt, const void* dy, const void* dh_last,
    void* ddt, void* dx, void* dbm, void* dc, void* dA, void* dh0, void* part,
    void* dA_part, int window, int bf16, int B, int T, int D, int N,
    long long bm_bstride, long long bm_tstride, long long c_bstride,
    long long c_tstride, void* stream) {
  if (bad_shape(B, T, D, N) || window != WINDOW)
    return (int)cudaErrorInvalidValue;
  const long long dn = (long long)D * N;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dn == 0) return 0;
  if (B == 0)   // no batch row: dA is an empty sum
    return (int)cudaMemsetAsync(dA, 0, (size_t)dn * sizeof(float), st);
  const dim3 grid = scan_grid(B, D, N);
  const int nblk = (int)grid.x;
  const long long rows = (long long)B * T * N;
  return (int)with_dtype(bf16, [&](auto xt) {
    using XT = decltype(xt);
    const Fused<XT> in{static_cast<const float*>(dt),
                       static_cast<const XT*>(x), static_cast<const XT*>(bm),
                       static_cast<const XT*>(c),
                       static_cast<const float*>(A), bm_bstride, bm_tstride,
                       c_bstride, c_tstride};
    cudaError_t err = with_state(N, [&](auto nn) {
      ssm_scan_fused_bwd_kernel<decltype(nn)::value, XT>
          <<<grid, THREADS, 0, st>>>(
              in, static_cast<const float*>(ckpt),
              static_cast<const float*>(dy),
              static_cast<const float*>(dh_last), static_cast<float*>(ddt),
              static_cast<XT*>(dx), static_cast<float*>(dh0),
              static_cast<float*>(dA_part), static_cast<float*>(part), T, D);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    const long long total = 2 * rows + dn;
    ssm_scan_fused_finish_kernel<XT>
        <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
            static_cast<const float*>(part),
            static_cast<const float*>(dA_part), static_cast<XT*>(dc),
            static_cast<XT*>(dbm), static_cast<float*>(dA), rows, nblk, N, dn,
            B);
    return cudaGetLastError();
  });
}
