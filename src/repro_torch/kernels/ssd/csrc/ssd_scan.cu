// Chunked Mamba2 SSD scan (state-space duality) on Hopper's tensor cores,
// in the model's layout:
//
//   x  (B, S, H, P)   x's dtype (float32 or bfloat16)
//   dt (B, S, H)      float32, ≥ 0
//   A  (H,)           float32, < 0
//   Bm (B, S, G, N)   x's dtype, head h reads group g = h / (H / G)
//   C  (B, S, G, N)   x's dtype
//   y  (B, S, H, P)   x's dtype;  final_state (B, H, N, P) float32, optional
//
// For each (sample b, head h), with L the within-chunk cumulative sum of
// dt·A (every entry ≤ 0) and the state carried across the chunks in order:
//
//   Y_intra[t] = Σ_{s≤t} e^{L_t−L_s} (C_t·B_s) dt_s x_s
//   Y_inter[t] = e^{L_t} C_t · state
//   state'     = e^{L_Q} state + Σ_s e^{L_Q−L_s} dt_s B_s ⊗ x_s
//
// Replaces the TPU kernel ssd_scan (_ssd_kernel, the pallas_call at
// src/repro/kernels/ssd/kernel.py:82). That kernel runs a (B, H, S/Q) grid
// in order on one core and carries the (N, P) state in VMEM scratch from one
// grid step to the next. Here the operands are read in the model's layout
// and rows past S are masked (loaded as dt = 0, x = B = C = 0, never
// stored), so nothing is transposed or padded in device memory.
//
// What bounds it: operations. Per chunk of Q = 64 rows and head, the
// products are C·Bᵀ's causal half (once a group), the masked scores times x
// (causal half), C·state and the state update, 1.18 M multiply-adds at
// mamba2-2.7b's N = 128, P = 64: 24.3 GFLOP at the prefill shape (4, 2048,
// 80 heads), against 0.34 GB read and written once. That is 0.36 ms on the
// CUDA cores (67 TFLOP/s) and 0.15 ms as 3xTF32 on the tensor cores (3 ×
// 24.3 GFLOP at 495 TFLOP/s); the bytes take 0.10 ms.
//
// What the design does about it:
// * Every product is mma.sync.m16n8k8 TF32 in the 3xTF32 split form of
//   ../../common/csrc/mma_tf32.cuh (TF32 is pinned off for fp32 work, and
//   one TF32 pass misses the port's fp32 bound: tests/test_torch_ssd.py
//   emulates both). In bf16, x, B and C are exact TF32 values (their lo
//   part is 0), so the passes that multiply by their lo are skipped: C·Bᵀ
//   is one pass, the scores times x and the update two, C·state three.
// * C·Bᵀ once a group: a first kernel (ssd_scan_cb) computes each chunk's
//   C·Bᵀ on the causal tiles for each (b, chunk, group) into a scratch of
//   16 KB a chunk (2.1 MB at the prefill shape, 8.4 MB at 32K: it stays in
//   L2 while the heads read it), stored in the A-fragment order of the
//   consumer, so that each warp loads one k step as one 16-byte load a lane.
//   Tiles above the diagonal are neither computed nor read, in C·Bᵀ and in
//   the scores times x.
// * Sequence ranges that fill the card: each (b, h) sequence is split into R
//   ranges of whole chunks (range r holds chunks [r·nc/R, (r+1)·nc/R)); the
//   wrapper picks R from B·H, the chunk count, the SM count and the blocks
//   an SM holds (ssd_scan_config), so the same shape on the same card
//   always runs the same R. Where B·H blocks fill a wave of pass 3's
//   slots already (the prefill shape: 320 blocks, 264 slots) R is 1: a
//   split would add pass 1 and its scratch and buy nothing. Pass 1 (ssd_scan_chunks<T, false>, ranges 0 …
//   R−2) runs only the update product from a zero state and writes each
//   range's local final state and its decay Π e^{L_Q}; pass 3
//   (ssd_scan_chunks<T, true>, every range) first combines those in range
//   order, state_in_r = decay_{r−1}·state_in_{r−1} + local_{r−1} (the
//   state-passing pass, a few fused multiply-adds a state element), then
//   runs the chunks of its range.
//   Against Mamba2's per-chunk decomposition this writes (R−1) states per
//   (b, h), not one per chunk: 31 MB at 32K (R = 13), not 1.34 GB.
// * Shared memory of pass 3: x's split (hi, lo), C and the (N, P) state in
//   fp32 and each warp's exponent sums, 108 KB, so two blocks of 8 warps
//   share an SM (pass 1 holds only x's split: 37 KB). The state is the
//   accumulator of the update product (each warp 16 rows of N, all of P):
//   written to shared memory at the start of a chunk as C·state's B operand,
//   and read back from there for the update, so that it holds no registers
//   while y is computed. B is the update's A operand and comes straight from
//   device memory (L2: every head of the group reads it), never through
//   shared memory.
// * Warps of the chunk body: for y, warp w owns rows 16 (w % 4) … + 15 and
//   half the columns of P; C·state runs 16 k steps, the scores times x only
//   the 2 (w % 4 + 1) k steps of the causal half. The B operands (x, the
//   state) come from rows padded to 72 floats as one 16-byte load for four
//   n8 tiles: column g of tile q of half j is p = 32 j + 4 g + q, so each
//   thread's outputs are 8 adjacent p (two 16-byte stores).
// * Loads from L2 run under mma work: a warp loads its C·Bᵀ fragments, then
//   runs C·state, then loads the update's B rows, then runs the scores
//   times x; pass 1 loads its B rows before the chunk's load phase.
// * Exponents are sums of the rows they cover, never the difference of
//   two sums over many rows: within a chunk |L| reaches the hundreds on
//   strongly decaying heads, and L_t − L_s would lose the few rows between
//   s and t to rounding (at the prefill shape, 3.4–4× the error against
//   the sequential oracle). Warp 0 scans dt·A (two rows a lane, then
//   five shuffles, a fixed tree) for L_t (e^{L_t}), for the sums after each
//   row (w_s = e^{L_Q − L_s} dt_s) and for the total (the chunk's decay);
//   each warp scans to the end of its 16-row tile, S_r, and takes L_t − L_s
//   as S_s − S_t, where |S_t| spans at most 16 rows. expf, not __expf;
//   e^{L_t − L_s} only where s ≤ t.
//
// Launches: ssd_scan_cb, then pass 1 when R > 1, then pass 3: two or three
// CUDA kernels a call, on the caller's stream.
//
// Determinism: every sum runs in a fixed order (the mma k order, the
// warp scans' trees, the range combine in range order); no atomics, so the
// same inputs on the same card give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/csrc/mma_tf32.cuh"  // split_tf32, mma_tf32

namespace {

constexpr int kQ = 64;                   // chunk length
constexpr int kN = 128;                  // d_state the tiles cover (smaller: zero rows)
constexpr int kP = 64;                   // head_dim the tiles cover (smaller: zero columns)
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kCbThreads = 128;          // ssd_scan_cb: one warp a 16-row tile of C·Bᵀ
constexpr int XS = kP + 8;               // row stride of x hi / lo and of the state
constexpr int CS = kN + 4;               // row stride of C (and B in ssd_scan_cb)
constexpr int kXFloats = kQ * XS;        // one of x hi, x lo
constexpr int kSmall = 3 * kQ + 4;       // dt, w, e^L, the chunk's decay
constexpr int kCbFloats = kQ * kQ;       // one chunk's C·Bᵀ in the scratch
constexpr int kStateFloats = kN * kP;    // one local state in the scratch
constexpr unsigned kFull = 0xffffffffu;

constexpr int smem_cb() { return 2 * kQ * CS * 4; }
template <bool kOut>
constexpr int smem_chunks() {
  return (2 * kXFloats + kSmall + (kOut ? kQ * CS + kN * XS + kWarps * kQ : 0)) * 4;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* C;
  void* y;
  float* final_state;  // may be null
  float* cb;           // (batch, nc, G) × kCbFloats
  float* local;        // (batch, H, R − 1) × kStateFloats
  float* decay;        // (batch, H, R − 1)
  int batch, S, H, G, N, P, nc, R;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// v[0..8) to p[0..8), 16-byte aligned
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// Four n8 accumulator tiles hold, for row half e2 (rows g or g + 8), the
// 8 adjacent columns 8 t + [0, 8) of a 32-column half: tile q column 2t is
// column 8 t + q, column 2t + 1 is 8 t + 4 + q (see the note on B operands).
__device__ __forceinline__ void row8(const float (*acc)[4], int e2, float (&v)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = acc[q][2 * e2], v[4 + q] = acc[q][2 * e2 + 1];
}
__device__ __forceinline__ void set_row8(float (*acc)[4], int e2, float4 u, float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q][2 * e2] = uu[q], acc[q][2 * e2 + 1] = vv[q];
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
}
__device__ __forceinline__ void split4(float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(v.x, hi[0], lo[0]);
  split_tf32(v.y, hi[1], lo[1]);
  split_tf32(v.z, hi[2], lo[2]);
  split_tf32(v.w, hi[3], lo[3]);
}
__device__ __forceinline__ void to_words(uint4 v, uint32_t (&w)[4]) {
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

// acc[q] += A·B over one k step for four n8 tiles: 3xTF32, small terms
// first (hi·lo, then lo·hi, then hi·hi), each pass over the four tiles in
// turn so that consecutive mma steps do not wait on each other. kBExact:
// B's lo is 0 (a bf16 input), so its pass is skipped.
template <bool kBExact>
__device__ __forceinline__ void mma4(float (*acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh0)[4],
                                     const uint32_t (&bh1)[4], const uint32_t (&bl0)[4],
                                     const uint32_t (&bl1)[4]) {
  if constexpr (!kBExact) {
#pragma unroll
    for (int q = 0; q < 4; ++q) mma_tf32(acc[q], ah, bl0[q], bl1[q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) mma_tf32(acc[q], al, bh0[q], bh1[q]);
#pragma unroll
  for (int q = 0; q < 4; ++q) mma_tf32(acc[q], ah, bh0[q], bh1[q]);
}

// In a warp whose lane holds the terms la, lb of rows 2 lane and 2 lane + 1:
// the sums of the terms after each of its two rows, (Σ_{q > 2 lane},
// Σ_{q > 2 lane + 1}), by a suffix scan of the pair sums over the lanes
// (a fixed tree). Every sum is of the terms it covers, not a difference of
// two longer sums, so its error is relative to itself.
__device__ __forceinline__ float2 suffix_sums(float la, float lb, int lane) {
  float v = la + lb;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v = v + u;
  }
  float after = __shfl_down_sync(kFull, v, 1);  // Σ over the rows of the lanes above
  if (lane == 31) after = 0.f;
  return make_float2(lb + after, after);
}

// ---------------------------------------------------------------- C·Bᵀ
// One block a (b, chunk, group); warp i computes rows 16i … 16i + 15 of
// C·Bᵀ over the NT = 2(i + 1) n8 tiles of columns s ≤ 16i + 15, and stores
// them, zero above the diagonal, in the A-fragment order ssd_scan_chunks
// reads: [t tile i][k step kk][lane][4], lane (g, t) holding (16i + g, 8kk + t),
// (16i + g + 8, 8kk + t), (16i + g, 8kk + t + 4), (16i + g + 8, 8kk + t + 4).
template <bool kExact, int NT>
__device__ __forceinline__ void cb_tiles(const float* Cs, const float* Bs, float* out, int i,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* c0 = Cs + (16 * i + g) * CS;
  const float* c1 = c0 + 8 * CS;
#pragma unroll 2
  for (int kk = 0; kk < kN / 8; ++kk) {
    const int k = 8 * kk + t;
    const float av[4] = {c0[k], c1[k], c0[k + 4], c1[k + 4]};
    uint32_t ah[4], al[4];
    split4(av, ah, al);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {  // B operand = Bᵀ: (k n, column s = 8n + g)
      const float* br = Bs + (8 * n + g) * CS + k;
      split_tf32(br[0], bh[n][0], bl[n][0]);
      split_tf32(br[4], bh[n][1], bl[n][1]);
    }
    if constexpr (!kExact) {
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);  // in the 16 × 8 tile
      const bool keep = 8 * n + c <= 16 * i + r;             // s ≤ t
      out[((i * 8 + n) * 32 + 4 * (r & 7) + (c & 3)) * 4 + (r >> 3) + 2 * (c >> 2)] =
          keep ? acc[n][e] : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(kCbThreads) ssd_scan_cb(const Args a) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;
  float* Bs = Cs + kQ * CS;
  const int blk = blockIdx.x;  // (b, chunk, group)
  const int grp = blk % a.G, c = (blk / a.G) % a.nc, b = blk / (a.G * a.nc);
  const int s0 = c * kQ, rows = min(kQ, a.S - s0);
  const T* Cp = static_cast<const T*>(a.C);
  const T* Bp = static_cast<const T*>(a.Bm);
  for (int e = threadIdx.x; e < kQ * (kN / 4); e += kCbThreads) {
    const int r = e / (kN / 4), c4 = (e % (kN / 4)) * 4;
    float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
    if (r < rows && c4 < a.N) {
      const long long off = ((static_cast<long long>(b) * a.S + s0 + r) * a.G + grp) * a.N + c4;
      cv = load4(Cp + off);
      bv = load4(Bp + off);
    }
    *reinterpret_cast<float4*>(Cs + r * CS + c4) = cv;
    *reinterpret_cast<float4*>(Bs + r * CS + c4) = bv;
  }
  __syncthreads();
  float* out = a.cb + static_cast<long long>(blk) * kCbFloats;
  const int i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  switch (i) {  // warp-uniform: each t tile its own count of causal n8 tiles
    case 0: cb_tiles<kExact, 2>(Cs, Bs, out, 0, lane); break;
    case 1: cb_tiles<kExact, 4>(Cs, Bs, out, 1, lane); break;
    case 2: cb_tiles<kExact, 6>(Cs, Bs, out, 2, lane); break;
    default: cb_tiles<kExact, 8>(Cs, Bs, out, 3, lane); break;
  }
}

// ------------------------------------------------------- the chunk body
// kOut = false (pass 1): range r < R − 1 of one (b, h) from a zero
// state, the update product only; writes the range's local final state and
// decay. kOut = true (pass 3): range r from the state entering it;
// writes y, and the final state from the last range.
template <typename T, bool kOut>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_chunks(const Args a) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // x, B, C exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* xh = smem;               // x rows, TF32 hi   [kQ][XS]
  float* xl = xh + kXFloats;      // x rows, TF32 lo   [kQ][XS]
  float* dts = xl + kXFloats;     // dt_s
  float* ws = dts + kQ;           // w_s = e^{L_Q − L_s} dt_s
  float* eLs = ws + kQ;           // e^{L_s}
  float* misc = eLs + kQ;         // [0]: the chunk's decay e^{L_Q}
  float* Cs = misc + 4;           // kOut: C rows        [kQ][CS]
  float* st = Cs + kQ * CS;       // kOut: the state     [kN][XS]
  float* Sw = st + kN * XS;       // kOut: each warp's sums of dt·A to its tile's end [kWarps][kQ]

  const int nranges = kOut ? a.R : a.R - 1;
  const int H = a.H, G = a.G, N = a.N, P = a.P, S = a.S;
  const int h = blockIdx.x % H, r = (blockIdx.x / H) % nranges, b = blockIdx.x / (H * nranges);
  const int grp = h / (H / G);
  const float Ah = a.A[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c_begin = static_cast<int>(static_cast<long long>(r) * a.nc / a.R);
  const int c_end = static_cast<int>(static_cast<long long>(r + 1) * a.nc / a.R);
  const T* xp = static_cast<const T*>(a.x);
  const T* Bp = static_cast<const T*>(a.Bm);
  const T* Cp = static_cast<const T*>(a.C);
  const long long bh = static_cast<long long>(b) * H + h;

  // the state: rows n = 16 warp + g (+ 8), columns p = 32 j + 8 t + [0, 8)
  // of half j: acc[4j + q][0 | 1] is row n, p = 32 j + 8 t + q | + 4 + q;
  // [2 | 3] the same for row n + 8
  const int n0 = 16 * warp + g, n1 = n0 + 8;
  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
  if constexpr (kOut) {  // state_in_r, combined in range order
    for (int rr = 0; rr < r; ++rr) {
      const long long idx = bh * (a.R - 1) + rr;
      const float d = a.decay[idx];
      const float* lp = a.local + idx * kStateFloats;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float* row = lp + (e2 ? n1 : n0) * kP + 32 * j + 8 * t;
          const float4 u = load4(row), v = load4(row + 4);
          const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[4 * j + q][2 * e2] = fmaf(d, acc[4 * j + q][2 * e2], uu[q]);
            acc[4 * j + q][2 * e2 + 1] = fmaf(d, acc[4 * j + q][2 * e2 + 1], vv[q]);
          }
        }
    }
  }
  float range_decay = 1.f;  // kOut = false: Π e^{L_Q} over the range, in order

  for (int c = c_begin; c < c_end; ++c) {
    const int s0 = c * kQ, rows = min(kQ, S - s0);
    const long long row0 = static_cast<long long>(b) * S + s0;  // (b, s0)
    __syncthreads();  // every warp is done with the previous chunk's shared memory
    // the update's A operand, B rows of this chunk (L2), into registers
    float bv[8][4];
    auto load_b = [&]() {
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        const int sa = 8 * kk + t, sb = sa + 4;
        const T* ra = Bp + ((row0 + sa) * G + grp) * N;
        const T* rb = Bp + ((row0 + sb) * G + grp) * N;
        bv[kk][0] = sa < rows && n0 < N ? load1(ra + n0) : 0.f;
        bv[kk][1] = sa < rows && n1 < N ? load1(ra + n1) : 0.f;
        bv[kk][2] = sb < rows && n0 < N ? load1(rb + n0) : 0.f;
        bv[kk][3] = sb < rows && n1 < N ? load1(rb + n1) : 0.f;
      }
    };
    if constexpr (!kOut) load_b();  // its latency runs under the load phase

    if constexpr (kOut) {
      // the state entering this chunk, C·state's B operand
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float v[8];
          row8(acc + 4 * j, e2, v);
          store8(st + (e2 ? n1 : n0) * XS + 32 * j + 8 * t, v);
        }
      for (int e = threadIdx.x; e < kQ * (kN / 4); e += kThreads) {
        const int rr = e / (kN / 4), c4 = (e % (kN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rr < rows && c4 < N) v = load4(Cp + ((row0 + rr) * G + grp) * N + c4);
        *reinterpret_cast<float4*>(Cs + rr * CS + c4) = v;
      }
    }
    // x rows, split once: hi and lo
    for (int e = threadIdx.x; e < kQ * (kP / 4); e += kThreads) {
      const int rr = e / (kP / 4), c4 = (e % (kP / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < rows && c4 < P) v = load4(xp + ((row0 + rr) * H + h) * P + c4);
      uint32_t hi[4], lo[4];
      split4(v, hi, lo);
      *reinterpret_cast<uint4*>(xh + rr * XS + c4) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if constexpr (!kExact)
        *reinterpret_cast<uint4*>(xl + rr * XS + c4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    // dt·A summed in a warp, rows 2 lane and 2 lane + 1 a lane, fixed trees.
    // Warp 0: L_t (the sum up to t, for e^{L_t}), the sums after each row
    // (e^{L_Q − L_s} for w), the chunk's total (its decay). An exponent is
    // never the difference of two sums over many rows: with |L| in the
    // hundreds (strongly decaying heads), that difference would lose the
    // few rows between t and s to rounding.
    if (warp == 0) {
      const int ra = 2 * lane, rb = ra + 1;
      const float da = ra < rows ? a.dt[(row0 + ra) * H + h] : 0.f;
      const float db = rb < rows ? a.dt[(row0 + rb) * H + h] : 0.f;
      const float la = da * Ah, lb = db * Ah;
      float v = la + lb;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v = u + v;
      }
      float before = __shfl_up_sync(kFull, v, 1);
      if (lane == 0) before = 0.f;
      const float2 after = suffix_sums(la, lb, lane);
      dts[ra] = da;
      dts[rb] = db;
      ws[ra] = expf(after.x) * da;
      ws[rb] = expf(after.y) * db;
      eLs[ra] = expf(before + la);
      eLs[rb] = expf(v);
      if (lane == 31) misc[0] = expf(v);
    }
    __syncthreads();

    if constexpr (kOut) {
      // ---- y = (M ⊙ C·Bᵀ)·diag(dt)·x + diag(e^L)·C·state: warp w owns
      // rows 16 (w % 4) … + 15 and the half j = w / 4 of P
      const int i = warp & 3, j = warp >> 2;
      const int tr0 = 16 * i + g, tr1 = tr0 + 8;
      float yacc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[q][0] = yacc[q][1] = yacc[q][2] = yacc[q][3] = 0.f;
      // this warp's C·Bᵀ fragments, all at once: their L2 latency runs
      // under C·state, which comes first
      const int nk = 2 * (i + 1);  // causal k steps: s < 16 (i + 1)
      const float4* cbp = reinterpret_cast<const float4*>(
                              a.cb + ((static_cast<long long>(b) * a.nc + c) * G + grp) *
                                         kCbFloats) +
                          i * 8 * 32 + lane;
      float4 cbv[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        cbv[kk] = kk < nk ? __ldg(cbp + kk * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
      // C·state, the C rows scaled by e^{L_t}
      {
        const float e0 = eLs[tr0], e1 = eLs[tr1];
        const float* c0 = Cs + tr0 * CS;
        const float* c1 = Cs + tr1 * CS;
#pragma unroll
        for (int kk = 0; kk < kN / 8; ++kk) {
          const int na = 8 * kk + t, nb = na + 4;
          const float av[4] = {c0[na] * e0, c1[na] * e1, c0[nb] * e0, c1[nb] * e1};
          uint32_t ah[4], al[4], bh0[4], bh1[4], bl0[4], bl1[4];
          split4(av, ah, al);
          split4(*reinterpret_cast<const float4*>(st + na * XS + 32 * j + 4 * g), bh0, bl0);
          split4(*reinterpret_cast<const float4*>(st + nb * XS + 32 * j + 4 * g), bh1, bl1);
          mma4<false>(yacc, ah, al, bh0, bh1, bl0, bl1);
        }
      }
      load_b();  // its latency runs under the scores times x
      // the scores times x. The exponent L_t − L_s = S_s − S_t, with S_r
      // the sum of dt·A over the rows after r up to the end of this warp's
      // tile: |S_t| spans at most 16 rows, so the rounding stays at the
      // scale of the exponent itself.
      {
        float* S = Sw + warp * kQ;
        const int end = 16 * (i + 1), ra = 2 * lane, rb = ra + 1;
        const float2 sf = suffix_sums(ra < end ? dts[ra] * Ah : 0.f,
                                      rb < end ? dts[rb] * Ah : 0.f, lane);
        S[ra] = sf.x;
        S[rb] = sf.y;
        __syncwarp();
        const float St0 = S[tr0], St1 = S[tr1];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk < nk) {
            const float4 v = cbv[kk];
            const int sa = 8 * kk + t, sb = sa + 4;
            const float Sa = S[sa], Sb = S[sb], da = dts[sa], db = dts[sb];
            const float m[4] = {sa <= tr0 ? v.x * expf(Sa - St0) * da : 0.f,
                                sa <= tr1 ? v.y * expf(Sa - St1) * da : 0.f,
                                sb <= tr0 ? v.z * expf(Sb - St0) * db : 0.f,
                                sb <= tr1 ? v.w * expf(Sb - St1) * db : 0.f};
            uint32_t ah[4], al[4], bh0[4], bh1[4], bl0[4], bl1[4];
            split4(m, ah, al);
            to_words(*reinterpret_cast<const uint4*>(xh + sa * XS + 32 * j + 4 * g), bh0);
            to_words(*reinterpret_cast<const uint4*>(xh + sb * XS + 32 * j + 4 * g), bh1);
            if constexpr (!kExact) {
              to_words(*reinterpret_cast<const uint4*>(xl + sa * XS + 32 * j + 4 * g), bl0);
              to_words(*reinterpret_cast<const uint4*>(xl + sb * XS + 32 * j + 4 * g), bl1);
            }
            mma4<kExact>(yacc, ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
      const int p0 = 32 * j + 8 * t;
      if (p0 < P) {
        T* yp = static_cast<T*>(a.y);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int tr = e2 ? tr1 : tr0;
          if (tr < rows) {
            float v[8];
            row8(yacc, e2, v);
            store8(yp + ((row0 + tr) * H + h) * P + p0, v);
          }
        }
      }
    }

    // ---- state = e^{L_Q} state + (diag(w) B)ᵀ x: warp w owns rows
    // n = 16 w + g (+ 8) and all of P; A = (B w)ᵀ straight from device memory
    {
      const float decay = misc[0];
      if constexpr (!kOut) range_decay *= decay;
      if constexpr (kOut) {  // the state entering the chunk, from st: not held through y
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float* row = st + (e2 ? n1 : n0) * XS + 32 * j + 8 * t;
            set_row8(acc + 4 * j, e2, load4(row), load4(row + 4));
          }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        const int sa = 8 * kk + t, sb = sa + 4;
        const float wa = ws[sa], wb = ws[sb];
        const float av[4] = {bv[kk][0] * wa, bv[kk][1] * wa, bv[kk][2] * wb, bv[kk][3] * wb};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh0[4], bh1[4], bl0[4], bl1[4];
          to_words(*reinterpret_cast<const uint4*>(xh + sa * XS + 32 * j + 4 * g), bh0);
          to_words(*reinterpret_cast<const uint4*>(xh + sb * XS + 32 * j + 4 * g), bh1);
          if constexpr (!kExact) {
            to_words(*reinterpret_cast<const uint4*>(xl + sa * XS + 32 * j + 4 * g), bl0);
            to_words(*reinterpret_cast<const uint4*>(xl + sb * XS + 32 * j + 4 * g), bl1);
          }
          mma4<kExact>(acc + 4 * j, ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  // ---- the range's result: its local state and decay (pass 1), or the
  // final state (the last range of pass 3)
  float* out = nullptr;
  int ostride = kP;
  if constexpr (kOut) {
    if (r == a.R - 1 && a.final_state != nullptr) {
      out = a.final_state + bh * N * P;
      ostride = P;
    }
  } else {
    const long long idx = bh * (a.R - 1) + r;
    out = a.local + idx * kStateFloats;
    if (threadIdx.x == 0) a.decay[idx] = range_decay;
  }
  if (out != nullptr) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int n = e2 ? n1 : n0, p0 = 32 * j + 8 * t;
        if (kOut ? (n < N && p0 < P) : true) {
          float v[8];
          row8(acc + 4 * j, e2, v);
          store8(out + static_cast<long long>(n) * ostride + p0, v);
        }
      }
  }
}

// once a device and kernel: allow the dynamic shared memory it takes and
// prefer the shared-memory carve-out, so that two blocks fit an SM
template <typename K>
int configure(K kern, int smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

template <typename T>
int configure_all() {
  static bool cb_done[64] = {}, st_done[64] = {}, ch_done[64] = {};
  int rc = configure(ssd_scan_cb<T>, smem_cb(), cb_done);
  if (rc == 0) rc = configure(ssd_scan_chunks<T, false>, smem_chunks<false>(), st_done);
  if (rc == 0) rc = configure(ssd_scan_chunks<T, true>, smem_chunks<true>(), ch_done);
  return rc;
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  int rc = configure_all<T>();
  if (rc != 0) return rc;
  ssd_scan_cb<T><<<a.batch * a.nc * a.G, kCbThreads, smem_cb(), stream>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (a.R > 1) {
    ssd_scan_chunks<T, false><<<a.batch * a.H * (a.R - 1), kThreads, smem_chunks<false>(),
                                stream>>>(a);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  ssd_scan_chunks<T, true><<<a.batch * a.H * a.R, kThreads, smem_chunks<true>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident(int* chunks, int* states) {
  int rc = configure_all<T>();
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        chunks, ssd_scan_chunks<T, true>, kThreads, smem_chunks<true>()));
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        states, ssd_scan_chunks<T, false>, kThreads, smem_chunks<false>()));
  return rc;
}

}  // namespace

// All operands contiguous in the layouts above; dtype 0 = float32,
// 1 = bfloat16 (x, Bm, C, y); final_state may be null. cb holds
// batch·ceil(S/64)·G·4096 floats; local (batch·H·(ranges − 1)·8192) and
// decay (batch·H·(ranges − 1)) may be null when ranges is 1. 1 ≤ ranges ≤
// ceil(S/64). Launches on `stream`; returns the first cudaGetLastError()
// that is not cudaSuccess.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* C, void* y, void* final_state, void* cb, void* local,
                            void* decay, int batch, int S, int H, int G, int N, int P,
                            int ranges, int dtype, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N < 16 || N > kN ||
      N % 16 != 0 || P < 16 || P > kP || P % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + kQ - 1) / kQ;
  if (ranges < 1 || ranges > nc || (ranges > 1 && (local == nullptr || decay == nullptr)) ||
      static_cast<long long>(batch) * H * ranges > 2147483647LL ||
      static_cast<long long>(batch) * nc * G > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, C, y,
               static_cast<float*>(final_state), static_cast<float*>(cb),
               static_cast<float*>(local), static_cast<float*>(decay), batch, S, H, G, N, P,
               nc, ranges};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of ssd_scan_chunks<T, true> (pass 3) and <T, false> (pass 1)
// that one SM holds, for dtype 0 or 1, on the current device; the wrapper
// picks the range count from them. Also the dynamic shared memory each of
// the three kernels takes, in bytes. Returns a CUDA error code.
extern "C" int ssd_scan_config(int dtype, int* chunks_per_sm, int* states_per_sm,
                               int* smem_cb_bytes, int* smem_states_bytes,
                               int* smem_chunks_bytes) {
  *smem_cb_bytes = smem_cb();
  *smem_states_bytes = smem_chunks<false>();
  *smem_chunks_bytes = smem_chunks<true>();
  if (dtype == 0) return resident<float>(chunks_per_sm, states_per_sm);
  if (dtype == 1) return resident<__nv_bfloat16>(chunks_per_sm, states_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
