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
// int32; q_pos (B, R) int32; kv_lens (B,) int32 >= 1.  Any block size,
// head_dim a multiple of 8 up to 256.  A span stops at min(kv_len, M * bs,
// 1 + the largest q_pos of the rows at hand): pages past ceil(kv_len / bs),
// the null-padded table tail included, are never read.
//
// Bound on the H100: bytes.  Decode reads every live K/V position of a row
// once per KV head for 4 * group * hd flops per position, far below the
// card's ~295 flops/byte balance point; a prefill chunk of C tokens reuses
// each position for 2 * C * group rows and comes closer.  So decode is about
// keeping enough 16-byte copies in flight on every SM, and the chunk about
// doing its products on the tensor cores.
//
// Two designs, one entry point (`repro_paged_attention`), chosen by R and
// dtype:
//
// Split-KV ("flash-decoding"): decode (R <= 16 rows a KV head) in both
// dtypes, and f32 prefill chunks.  Grid (splits, row tiles, B * KV): a
// block takes up to 16 rows of one (b, KV head) over one slice of SPLIT =
// 512 key positions.  Rows are padded only to the next of 1, 2, 4, 8, 16
// (qwen3's 2, zamba2's 1 and a group of 8 are exact), so no warp computes
// a dead row there.  The block stages its slice's block-table entries in
// shared memory, each read once by one thread.  Its W warps take
// interleaved sub-tiles of 16 keys, each warp through its own two-stage
// `cp.async` ring of 16-byte copies gathered through the table (a K or V
// row of hd elements is contiguous in the pool); two lanes share a key's
// score (half of head_dim each, then one shuffle), a lane owns 4 columns of
// the PV accumulator.  The warps' (m, l, acc) meet in shared memory in warp
// order, and the block writes them in f32 to a workspace (from
// `torch.empty` in the wrapper); a combine kernel merges each row's splits
// in split order and divides.  Split-KV at decode fills the card: a step
// at B = 8 over spans up to 2,048 with 8 KV heads is 144 blocks, where one
// block per (KV head, b) was 64.
//
// FlashAttention-2 on the tensor cores: bf16 prefill chunks (R > 16; R =
// group * C rows, ordered g * C + c, so with C a multiple of 64 a tile is
// one head's consecutive positions).  Grid (64-row q tiles, KV, B); 4
// warps of 16 rows walk 64-key K/V tiles (32 at head_dim 256) gathered
// through the table by 16-byte `cp.async` into a two-stage ring, with
// `mma.sync.m16n8k16` for S = Q K^T and O += P V (K3's fragment maps,
// sm90_mma.cuh), online softmax in log2 units on `ex2`, and P rounded to
// bf16 as the A operand.  head_dim tiles are 64, 80, 128 and 256; a shorter
// head_dim reads zero columns.  Tiles past the q tile's largest q_pos are
// never read, and a warp skips a tile its rows cannot see.
//
// Batch invariance.  A row's output bits depend only on its own q, q_pos,
// kv_len and the pages it reads -- never on B, on the other rows, or on
// the grid.  Split boundaries sit at fixed multiples of SPLIT from position
// 0, sub-tiles at fixed multiples of 16 within a split, each sub-tile has a
// fixed warp, and every sum runs in a fixed order.  A key that the row
// cannot see adds an exact 0 once the row has seen key 0 (every row sees
// it, and split 0's warp 0 walks it first); a warp or split that saw none of
// the row's keys enters its merge with weight exactly 0, and the combine
// reads only the splits the row's own q_pos reaches.  So which extra tiles
// or splits other rows make a block walk changes no bit.  The engine's
// token identities rest on this.
//
// `pages_per_fetch` (the TPU kernel's DMA grouping knob) is accepted by the
// Python wrapper for signature parity and not used: if the split length
// followed it, planning on (32 pages) and off (1) would give different bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int SPLIT = 512;        // key positions a split (a constant)
constexpr int KT = 16;            // keys a warp sub-tile
constexpr int MAX_RP = 16;        // rows a split-KV block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements at p (16-byte aligned for bf16, 32 for f32's two
// float4) as f32
__device__ __forceinline__ void load8(float (&f)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(float (&f)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
// 4 consecutive elements (8-byte aligned for bf16, 16 for f32) as f32
__device__ __forceinline__ void load4(float (&f)[4], const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(float (&f)[4], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

struct Params {
  const void *q, *k_pages, *v_pages;
  const int *tables, *q_pos, *kv_lens;
  void* out;
  float* ws;            // split-KV partials: acc, then (m, l)
  int B, KV, R, hd, bs, M, S;  // S: splits of the longest span, M*bs/SPLIT
  float sl2;            // scale * log2(e)
};

// The workspace's slots of row r of (b, h) = bh, split j.
__device__ __forceinline__ size_t ws_slot(const Params& p, int bh, int r,
                                          int j) {
  return ((size_t)bh * p.R + r) * p.S + j;
}

// ===========================================================================
// Split-KV: decode, and f32 prefill chunks
// ===========================================================================

// Shared memory of a split-KV block, in bytes (16-byte aligned pieces):
// q rows in f32, the slice's table entries, each warp's two-stage K/V ring
// and its p tile; the warps' merge reuses the rings.
template <typename T>
__host__ __device__ constexpr int split_ld(int hd) {
  return hd + 16 / (int)sizeof(T);   // row stride: 16 bytes of padding
}
template <typename T>
__host__ __device__ size_t split_smem(int RP, int W, int hd) {
  return (size_t)RP * hd * 4 + (SPLIT + 4) * 4 +
         (size_t)W * 2 * 2 * KT * split_ld<T>(hd) * sizeof(T) +
         (size_t)W * RP * KT * 4;
}

// Issue one warp's 16-byte copies of the K and V rows of keys
// [kb, kb + KT) into ks / vs (row stride LD); keys at or past k_hi are
// zero-filled.  tab: the slice's table entries from page pg0.
template <typename T>
__device__ __forceinline__ void split_load(T* ks, T* vs, const T* kp,
                                           const T* vp, const int* tab,
                                           int pg0, int kb, int k_hi, int bs,
                                           size_t row_stride, size_t head,
                                           int hd, int LD, int lane) {
  constexpr int EPC = 16 / sizeof(T);   // elements a copy
  const int cpr = hd / EPC;
  long long off = 0;
  if (lane < KT) {
    const int kpos = kb + lane;
    if (kpos < k_hi)
      off = ((long long)tab[kpos / bs - pg0] * bs + kpos % bs) *
                (long long)row_stride + (long long)head;
    else
      off = -1;
  }
  for (int base = 0; base < KT * cpr; base += 32) {
    const int x = base + lane;
    const int t = min(x / cpr, KT - 1);
    const long long o = __shfl_sync(FULL, off, t);
    if (x < KT * cpr) {
      const int c = (x - t * cpr) * EPC;
      const bool ok = o >= 0;
      cp_async16(ks + t * LD + c, ok ? kp + o + c : kp, ok ? 16 : 0);
      cp_async16(vs + t * LD + c, ok ? vp + o + c : vp, ok ? 16 : 0);
    }
  }
}

// RP: rows a block (>= the rows it serves); DC4: 4-column chunks of the PV
// accumulator a lane owns (ceil(hd / 128)); W: warps.
template <typename T, int RP, int DC4, int W>
__global__ void __launch_bounds__(W * 32)
paged_split_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char pa_smem[];
  const int hd = p.hd, LD = split_ld<T>(hd);
  float* q_s = reinterpret_cast<float*>(pa_smem);            // [RP][hd]
  int* tab_s = reinterpret_cast<int*>(q_s + RP * hd);        // [SPLIT + 4]
  T* ring = reinterpret_cast<T*>(tab_s + SPLIT + 4);         // [W][2][2][KT][LD]
  float* p_s = reinterpret_cast<float*>(ring + (size_t)W * 4 * KT * LD);
  const int j = blockIdx.x, r0 = blockIdx.y * RP, bh = blockIdx.z;
  const int b = bh / p.KV, h = bh - b * p.KV;
  const int nrows = min(RP, p.R - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* qpos_g = p.q_pos + (size_t)b * p.R + r0;

  int horizon = 0;
  for (int r = 0; r < nrows; ++r) horizon = max(horizon, qpos_g[r] + 1);
  const int span = min(min(p.kv_lens[b], p.M * p.bs), horizon);
  const int k_lo = j * SPLIT;
  if (k_lo >= span) return;                 // the row tile ends before j
  const int k_hi = min(span, k_lo + SPLIT);
  const int pg0 = k_lo / p.bs, npg = (k_hi - 1) / p.bs - pg0 + 1;

  const T* q = static_cast<const T*>(p.q) + ((size_t)bh * p.R + r0) * hd;
  for (int i = threadIdx.x; i < RP * hd; i += W * 32)
    q_s[i] = i < nrows * hd ? to_f32(q[i]) : 0.f;
  const int* table = p.tables + (size_t)b * p.M;
  for (int i = threadIdx.x; i < npg; i += W * 32) tab_s[i] = table[pg0 + i];
  __syncthreads();

  int qp[RP];
  float m[RP], l[RP], acc[RP][4 * DC4];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    qp[r] = r < nrows ? qpos_g[r] : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DC4; ++e) acc[r][e] = 0.f;
  }

  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  const size_t row_stride = (size_t)p.KV * hd, head = (size_t)h * hd;
  T* wring = ring + (size_t)warp * 4 * KT * LD;   // [stage][K, V][KT][LD]
  float* wp = p_s + warp * RP * KT;               // [RP][KT]
  const int nsub = (k_hi - k_lo + KT - 1) / KT;
  const int nw = (nsub - warp + W - 1) / W;       // sub-tiles warp, + W, ...
  const int t = lane % KT, half = lane / KT;

  if (nw > 0)
    split_load<T>(wring, wring + KT * LD, kp, vp, tab_s, pg0,
                  k_lo + warp * KT, k_hi, p.bs, row_stride, head, hd, LD,
                  lane);
  cp_async_commit();
  for (int it = 0; it < nw; ++it) {
    if (it + 1 < nw) {
      T* st = wring + ((it + 1) & 1) * 2 * KT * LD;
      split_load<T>(st, st + KT * LD, kp, vp, tab_s, pg0,
                    k_lo + (warp + (it + 1) * W) * KT, k_hi, p.bs,
                    row_stride, head, hd, LD, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const T* ks = wring + (it & 1) * 2 * KT * LD;
    const T* vs = ks + KT * LD;
    const int kpos = k_lo + (warp + it * W) * KT + t;

    // scores: lanes t and t + 16 each take half of key t's 8-column chunks
    float s[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) s[r] = 0.f;
    for (int c = half * 8; c < hd; c += 16) {
      float kf[8];
      load8(kf, ks + t * LD + c);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        float qf[8];
        load8(qf, q_s + r * hd + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r] = fmaf(qf[e], kf[e], s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      s[r] += __shfl_xor_sync(FULL, s[r], KT);
      const float x = (kpos < k_hi && kpos <= qp[r]) ? s[r] * p.sl2 : NEG_INF;
      float mx = x;
#pragma unroll
      for (int o = KT / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float pr = fast_exp2(x - m_new);
      float ps = pr;
#pragma unroll
      for (int o = KT / 2; o > 0; o >>= 1) ps += __shfl_xor_sync(FULL, ps, o);
      const float alpha = fast_exp2(m[r] - m_new);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * DC4; ++e) acc[r][e] *= alpha;
      if (half == 0) wp[r * KT + t] = to_f32(from_f32<T>(pr));  // v's dtype
    }
    __syncwarp();

    // PV: lane owns columns 4 * lane + 128 * c .. + 3
#pragma unroll
    for (int k4 = 0; k4 < KT; k4 += 4) {
#pragma unroll
      for (int c = 0; c < DC4; ++c) {
        const int d = 4 * lane + 128 * c;
        if (d >= hd) break;
        float vf[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) load4(vf[u], vs + (k4 + u) * LD + d);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float4 pv = *reinterpret_cast<const float4*>(wp + r * KT + k4);
          const float pu[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][4 * c + e] = fmaf(pu[u], vf[u][e], acc[r][4 * c + e]);
        }
      }
    }
    __syncwarp();   // this stage and the p tile are refilled next
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: merge there

  float* ml_s = reinterpret_cast<float*>(ring);           // [W][RP][2]
  float* acc_s = ml_s + W * RP * 2;                        // [W][RP][hd]
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    if (lane == 0) {
      ml_s[(warp * RP + r) * 2] = m[r];
      ml_s[(warp * RP + r) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < DC4; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d < hd)
        *reinterpret_cast<float4*>(acc_s + (warp * RP + r) * hd + d) =
            make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                        acc[r][4 * c + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * hd; i += W * 32) {
    const int r = i / hd, d = i - r * hd;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) mm = fmaxf(mm, ml_s[(w * RP + r) * 2]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float wt = fast_exp2(ml_s[(w * RP + r) * 2] - mm);
      a = fmaf(wt, acc_s[(w * RP + r) * hd + d], a);
      ll = fmaf(wt, ml_s[(w * RP + r) * 2 + 1], ll);
    }
    const size_t slot = ws_slot(p, bh, r0 + r, j);
    p.ws[slot * hd + d] = a;
    if (d == 0) {
      float* ml = p.ws + (size_t)p.B * p.KV * p.R * p.S * hd + slot * 2;
      ml[0] = mm;
      ml[1] = ll;
    }
  }
}

// One warp a row: its splits merged in split order, only those its own
// q_pos reaches (the others are all masked for it), and divided.
template <typename T>
__global__ void __launch_bounds__(256)
paged_combine_kernel(Params p) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.KV * p.R) return;
  const int bh = (int)(row / p.R), r = (int)(row - (long long)bh * p.R);
  const int b = bh / p.KV;
  const int reach = min(min(p.kv_lens[b], p.M * p.bs),
                        p.q_pos[(size_t)b * p.R + r] + 1);
  const int n = max(1, (reach + SPLIT - 1) / SPLIT);
  const size_t slot0 = ws_slot(p, bh, r, 0);
  const float* ml = p.ws + (size_t)p.B * p.KV * p.R * p.S * p.hd + slot0 * 2;
  float mm = NEG_INF;
  for (int j = 0; j < n; ++j) mm = fmaxf(mm, ml[2 * j]);
  float ll = 0.f;
  for (int j = 0; j < n; ++j) ll = fmaf(fast_exp2(ml[2 * j] - mm), ml[2 * j + 1], ll);
  const float denom = fmaxf(ll, 1e-30f);
  T* out = static_cast<T*>(p.out) + (size_t)row * p.hd;
  for (int d = lane; d < p.hd; d += 32) {
    float a = 0.f;
    for (int j = 0; j < n; ++j)
      a = fmaf(fast_exp2(ml[2 * j] - mm), p.ws[(slot0 + j) * p.hd + d], a);
    out[d] = from_f32<T>(a / denom);
  }
}

// ===========================================================================
// bf16 prefill chunks: FlashAttention-2 on mma.sync
// ===========================================================================
constexpr int CQ = 64;            // q rows a block: 4 warps of 16

// Rows of keys [k0, k0 + BK) of head h into ks / vs (row stride LD) by
// 16-byte cp.async through the block table; keys at or past `span` are
// zero-filled.  Columns past hd are left alone (zero_pad writes them).
template <int BK, int LD>
__device__ __forceinline__ void chunk_load(bf16* ks, bf16* vs, const Params& p,
                                           const int* table, int k0, int span,
                                           size_t head) {
  const bf16* kp = static_cast<const bf16*>(p.k_pages);
  const bf16* vp = static_cast<const bf16*>(p.v_pages);
  const int cpr = p.hd / 8;
  const size_t row_stride = (size_t)p.KV * p.hd;
  for (int i = threadIdx.x; i < BK * cpr; i += 128) {
    const int t = i / cpr, c = (i - t * cpr) * 8;
    const int kpos = k0 + t;
    const bool ok = kpos < span;
    const size_t o = ok ? ((size_t)table[kpos / p.bs] * p.bs + kpos % p.bs) *
                                  row_stride + head + c
                        : 0;
    cp_async16(ks + t * LD + c, kp + o, ok ? 16 : 0);
    cp_async16(vs + t * LD + c, vp + o, ok ? 16 : 0);
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(128)
paged_chunk_mma_kernel(Params p) {
  constexpr int LD = HD + 8, NB = BK / 8, DB = HD / 8;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(pa_smem);  // [CQ][LD]
  bf16* k_s = q_s + CQ * LD;                      // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]
  __shared__ int hmax_s[4];
  const int q0 = blockIdx.x * CQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * p.KV + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;
  const int* table = p.tables + (size_t)b * p.M;
  const int span = min(p.kv_lens[b], p.M * p.bs);

  // the q_pos of the thread's rows row0 + g and + 8 (-1: past R)
  int qp[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + g + 8 * e;
    qp[e] = r < p.R ? p.q_pos[(size_t)b * p.R + r] : -1;
  }
  int wmax = max(qp[0], qp[1]), wmin = min(qp[0], qp[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(FULL, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(FULL, wmin, o));
  }
  if (lane == 0) hmax_s[warp] = wmax;

  zero_pad<HD, LD, 128>(q_s, CQ + 4 * BK, p.hd);  // q_s, k_s, v_s adjoin
  const bf16* q = static_cast<const bf16*>(p.q) + bh * p.R * p.hd;
  const int cpr = p.hd / 8;
  for (int i = threadIdx.x; i < CQ * cpr; i += 128) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool ok = q0 + r < p.R;
    cp_async16(q_s + r * LD + c, q + (size_t)(ok ? q0 + r : 0) * p.hd + c,
               ok ? 16 : 0);
  }
  __syncthreads();
  const int horizon =
      max(max(hmax_s[0], hmax_s[1]), max(hmax_s[2], hmax_s[3])) + 1;
  const int end = min(span, horizon);
  const int ntiles = (end + BK - 1) / BK;
  const size_t head = (size_t)h * p.hd;
  if (ntiles > 0) chunk_load<BK, LD>(k_s, v_s, p, table, 0, end, head);
  cp_async_commit();

  float acc[DB][4];
  zero_acc(acc);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * BK, st = jt & 1;
    if (jt + 1 < ntiles)
      chunk_load<BK, LD>(k_s + (st ^ 1) * BK * LD, v_s + (st ^ 1) * BK * LD,
                         p, table, k0 + BK, end, head);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // a warp whose rows all lie before the tile's first key skips it
    if (k0 <= wmax) {
      float sc[NB][4];
      zero_acc(sc);
      mma_abt<HD, LD, NB>(sc, q_s + warp * 16 * LD, k_s + st * BK * LD, lane);
      const bool mask = k0 + BK > end || k0 + BK - 1 > wmin;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * p.sl2;
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          if (mask && !(kpos < end && kpos <= qp[e / 2])) x = NEG_INF;
          sc[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 2));
        alpha[hh] = fast_exp2(m[hh] - mx[hh]);
        m[hh] = mx[hh];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = fast_exp2(sc[n][e] - m[e / 2]);
          rs[e / 2] += sc[n][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(FULL, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(FULL, rs[hh], 2);
        l[hh] = l[hh] * alpha[hh] + rs[hh];
      }
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
      mma_px<LD, NB, DB>(acc, sc, v_s + st * BK * LD, 0, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  store_rows<DB>(static_cast<bf16*>(p.out) + bh * p.R * p.hd, acc, inv, row0,
                 p.R, 0, p.hd, lane);
}

// ===========================================================================
// Launchers
// ===========================================================================

// Splits of the longest span the table can hold.
int max_splits(int bs, int M) {
  return (int)(((long long)bs * M + SPLIT - 1) / SPLIT);
}

bool uses_split(int R, int dtype) { return dtype == 0 || R <= MAX_RP; }

template <typename T, int RP, int DC4>
cudaError_t launch_split(const Params& p, cudaStream_t s) {
  constexpr int W = (sizeof(T) == 4 && DC4 == 2) ? 2 : 4;
  const size_t smem = split_smem<T>(RP, W, p.hd);
  auto kern = paged_split_kernel<T, RP, DC4, W>;
  static size_t allowed = 0;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.S, (p.R + RP - 1) / RP, p.B * p.KV);
  kern<<<grid, W * 32, smem, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.KV * p.R;
  paged_combine_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int DC4>
cudaError_t launch_split_rows(const Params& p, cudaStream_t s) {
  if (p.R <= 1) return launch_split<T, 1, DC4>(p, s);
  if (p.R <= 2) return launch_split<T, 2, DC4>(p, s);
  if (p.R <= 4) return launch_split<T, 4, DC4>(p, s);
  if (p.R <= 8) return launch_split<T, 8, DC4>(p, s);
  return launch_split<T, 16, DC4>(p, s);   // more rows: 16-row tiles
}

template <int HD, int BK>
cudaError_t launch_chunk(const Params& p, cudaStream_t s) {
  const size_t smem = (size_t)(CQ + 4 * BK) * (HD + 8) * 2;
  auto kern = paged_chunk_mma_kernel<HD, BK>;
  static size_t allowed = 0;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<dim3((p.R + CQ - 1) / CQ, p.KV, p.B), 128, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int dtype, cudaStream_t s) {
  if (uses_split(p.R, dtype)) {
    if (dtype == 0)
      return p.hd <= 128 ? launch_split_rows<float, 1>(p, s)
                         : launch_split_rows<float, 2>(p, s);
    return p.hd <= 128 ? launch_split_rows<bf16, 1>(p, s)
                       : launch_split_rows<bf16, 2>(p, s);
  }
  if (p.hd <= 64) return launch_chunk<64, 64>(p, s);
  if (p.hd <= 80) return launch_chunk<80, 64>(p, s);
  if (p.hd <= 128) return launch_chunk<128, 64>(p, s);
  return launch_chunk<256, 32>(p, s);
}

bool bad_shape(int B, int KV, int R, int hd, int bs, int M) {
  return B < 0 || KV < 0 || R < 0 || hd <= 0 || hd > 256 || hd % 8 != 0 ||
         bs <= 0 || M <= 0 || B > 65535 || KV > 65535 ||
         (long long)B * KV > 65535 || (long long)bs * M > (1LL << 30);
}

}  // namespace

// f32 elements of the split-KV workspace that repro_paged_attention needs
// (0: none), or -1 for a shape or dtype it refuses.
extern "C" long long repro_paged_attention_workspace(int B, int KV, int R,
                                                     int hd, int bs, int M,
                                                     int dtype) {
  if (bad_shape(B, KV, R, hd, bs, M) || (dtype != 0 && dtype != 1))
    return -1;
  if (!uses_split(R, dtype)) return 0;
  return (long long)B * KV * R * max_splits(bs, M) * (hd + 2);
}

// dtype: 0 = float32, 1 = bfloat16.  ws: repro_paged_attention_workspace
// f32 elements (may be null when that is 0).  Returns the launches'
// cudaError_t (0 = success); the kernels run asynchronously on `stream`.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_tables,
                                     const void* q_pos, const void* kv_lens,
                                     void* out, void* ws, int B, int KV, int R,
                                     int hd, int bs, int M, int dtype,
                                     void* stream) {
  if (bad_shape(B, KV, R, hd, bs, M) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KV == 0 || R == 0) return 0;
  if (uses_split(R, dtype) && ws == nullptr) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q; p.k_pages = k_pages; p.v_pages = v_pages;
  p.tables = static_cast<const int*>(block_tables);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.out = out; p.ws = static_cast<float*>(ws);
  p.B = B; p.KV = KV; p.R = R; p.hd = hd; p.bs = bs; p.M = M;
  p.S = max_splits(bs, M);
  p.sl2 = (float)(1.0 / sqrt((double)hd)) * LOG2E;
  return (int)dispatch(p, dtype, static_cast<cudaStream_t>(stream));
}
