// Flash attention, forward, on Hopper's tensor cores: out = softmax(q k^T *
// scale + mask) v per head, with an online softmax so the (S, S) score
// matrix never reaches device memory.
//
// Replaces the TPU kernel flash_attention (_fa_kernel, the pallas_call at
// src/repro/kernels/flash_attention/kernel.py:130): fp32 running max m, sum
// l and accumulator for fp32 and bf16 inputs; optional causal mask and
// sliding window (position i sees [i - W + 1, i]); GQA (head h reads kv
// head h / (Hq / Hkv)); keys at or past true_len masked; rows with l == 0
// give 0.
//
// What bounds it, at the DiT's shape (B 8, H 12, S 256, D 64): the two
// products are 4*B*H*S^2*D = 1.61 GFLOP over 25.2 MB (12.6 MB in bf16).
//   fp32 on the CUDA cores, 67 TFLOP/s:                 24.0 us (operations)
//   fp32 as 3xTF32 on the tensor cores, 3 x 1.61 GFLOP
//   at 495 TFLOP/s (this kernel's yardstick):            9.8 us (operations)
//   bf16 on the tensor cores:  3.8 us (bytes at 3.35 TB/s; 1.6 us by operations)
//
// What the design does about it:
// * fp32: both products, S = Q K^T and O = P V, are
//   mma.sync.m16n8k8.f32.tf32.tf32.f32 in the 3xTF32 split form. Each
//   operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi); each
//   k step accumulates hi*lo, then lo*hi, then hi*hi into one fp32
//   accumulator (lo*lo is dropped). Its error is fp32's; one TF32 pass
//   would miss the port's fp32 bound by 10x and more
//   (tests/test_torch_flash_attention.py emulates both), so no product here
//   is a single TF32 pass. The split and the mma.sync wrappers live in
//   ../../common/csrc/mma_tf32.cuh, shared with ssd_scan.cu.
// * bf16: mma.sync.m16n8k16.f32.bf16.bf16.f32, fp32 accumulators, m and l.
//   P is rounded to bf16 only as the operand of P V. ldmatrix loads K, and
//   ldmatrix.trans V, from shared memory.
// * A warp owns 16 query rows; a block of NW = min(4, ceil(S / 16)) warps
//   owns 16 * NW rows of one (b, h): the DiT's shape is 4 x 96 = 384 blocks
//   of 4 warps, the planning shape (S 8) one warp per (b, h). A thread holds
//   two rows (g and g + 8 of its warp; g = lane / 4, t = lane % 4); the row
//   max reduces over the 4 threads of a quad with two shuffles a tile, the
//   row sum once, at the end. exp2f, with scale * log2(e) folded in.
// * S's accumulator is P's A fragment as it stands. In bf16 the m16n8k16
//   layouts agree (two n8 tiles of S are one k16 step of P V). In tf32 they
//   do not, so the key order inside each k8 step is permuted, in P's A
//   fragment and in V's B fragment alike: logical k = t is key 2t, and
//   k = t + 4 is key 2t + 1. No value moves between threads.
// * fp32 fragments come from shared memory 16 bytes at a time, by two more
//   permutations that leave the sums' terms unchanged: inside each pair of
//   k steps of Q K^T, k = t and t + 4 are d 16 (kk / 2) + 4t + 2 (kk % 2) +
//   {0, 1}, in Q's A fragment and K's B fragment alike; and column g of
//   P V's n8 tile n is d 32 (n / 4) + 4g + n % 4, which the output store
//   undoes (each thread then holds 8 adjacent d of its rows). K rows are
//   padded to DP + 16 floats (thread (g, t) of a quarter warp starts at
//   bank 16g + 4t), V rows to DP + 4 (bank 8t + 4g): no bank conflicts.
//   bf16 rows are padded to DP + 8, which keeps ldmatrix conflict-free.
// * K/V tiles of BK keys come into shared memory by cp.async.cg, 16 bytes a
//   thread, through a ring of NST stages (2 in fp32, 3 in bf16): tiles
//   j + 1 .. j + NST - 1 are in flight while tile j is multiplied, and one
//   barrier a tile both publishes tile j and frees tile j - 1's stage. Keys
//   past S and columns past D are zero-filled (cp.async with a short or
//   zero source size) and masked; nothing is padded in device memory, so
//   the wrapper needs 16-byte-aligned base pointers and (b, h, s) strides
//   and checks them.
// * fp32: each thread splits the 16-byte chunks it copied, once its own
//   copies have landed and before the barrier: hi in place, lo into the
//   stage's lo buffer. Each element is split once, not once for each warp
//   that reads it, and the split of one block overlaps the others' mma.
// * Q's fragments (split, in fp32) are made once. They stay in registers
//   for the whole key loop up to DP = 64 (fp32) / 128 (bf16); wider heads
//   keep them in shared memory in fragment order, each lane reading back
//   its own words (no barrier).
// * Tiles that no row of the block can see (causal, window) are never
//   loaded, and a warp skips the tiles none of its rows can see. Within a
//   tile every mma step runs (keys past S are zeros, masked): the unrolled
//   steps form one basic block, ordered so that consecutive mma steps work
//   on different n8 tiles and do not wait on each other.
// * No atomics; every sum runs in a fixed order, so a call gives the same
//   bits every time, and strides do not change the arithmetic.
//
// Tiles: fp32 BK = 32 keys (8 at DP = 256, where Q's split fragments take
// 128 KB of shared memory); bf16 64 (32 at DP = 256). DP, the padded head
// width, is 32, 64, 128 or 256. Up to DP = 64 the kernel is held to 168
// registers, so that 3 blocks of 4 warps share an SM: the DiT's 384 blocks
// are one wave.
//
// Why mma.sync and cp.async, not wgmma and TMA: the whole DiT call is 1.6
// GFLOP, ~10 us even on the tensor cores, so latency and occupancy weigh
// more than the last factor of the tensor-core rate; and TF32 wgmma takes B
// only K-major, so V would have to be transposed on its way into shared
// memory. If this kernel stays above twice its 3xTF32 bound, wgmma + TMA is
// its next lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/csrc/mma_tf32.cuh"  // split_tf32, mma_tf32, mma_bf16

namespace {

constexpr int kMaxWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int Hq, Hkv, S, D, true_len, causal, window;
  float scale_log2;  // softmax scale * log2(e)
};

template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // keys per tile and cp.async stages (see the note at the top)
  static constexpr int BK = kF32 ? (DP == 256 ? 8 : 32) : (DP <= 128 ? 64 : 32);
  static constexpr int NST = kF32 ? 2 : 3;
  static constexpr int NT = BK / 8;                          // n8 tiles of keys
  // padded row strides of K and V in shared memory (elements)
  static constexpr int KSTK = DP + (kF32 ? 16 : 8), KSTV = DP + (kF32 ? 4 : 8);
  static constexpr int CH = 16 / sizeof(T);                  // elements per cp.async
  static constexpr int TK = BK * KSTK, TILE = TK + BK * KSTV;  // K tile; K and V
  static constexpr int KS = DP / (kF32 ? 8 : 16);            // k steps of Q K^T
  static constexpr int QW = kF32 ? 8 : 4;                    // Q words a lane, k step
  static constexpr bool QREG = DP <= (kF32 ? 64 : 128);
  // NST stages of (K, V), then in fp32 NST stages of (K lo, V lo)
  static constexpr int KV_BYTES = NST * (kF32 ? 2 : 1) * TILE * static_cast<int>(sizeof(T));
  static constexpr int Q_BYTES_PER_WARP = QREG ? 0 : KS * 32 * QW * 4;
  static int smem(int nw) { return KV_BYTES + nw * Q_BYTES_PER_WARP; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two fp32 values as one bf16x2 operand word, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// fp32 elements c .. c + 3 of a row (c a multiple of 4), 0 outside [0, D)
__device__ __forceinline__ float4 ld4(const float* row, int c, int D) {
  if (c + 4 <= D) return *reinterpret_cast<const float4*>(row + c);
  return make_float4(c < D ? row[c] : 0.f, c + 1 < D ? row[c + 1] : 0.f,
                     c + 2 < D ? row[c + 2] : 0.f, c + 3 < D ? row[c + 3] : 0.f);
}

// bf16 elements c and c + 1 of a row (c even) as one operand word, 0
// outside [0, D)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row, int c, int D) {
  if (c + 2 <= D) return *reinterpret_cast<const uint32_t*>(row + c);
  return c < D ? __bfloat16_as_ushort(row[c]) : 0u;
}

// x[0..8) to row[c..c + 8), the part below D
__device__ __forceinline__ void st8(float* row, int c, int D, const float (&x)[8]) {
  if (c + 8 <= D) {
    *reinterpret_cast<float4*>(row + c) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(row + c + 4) = make_float4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < D) row[c + i] = x[i];
  }
}
__device__ __forceinline__ void st2(__nv_bfloat16* row, int c, int D, float x, float y) {
  if (c + 1 < D) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else if (c < D) {
    row[c] = __float2bfloat16_rn(x);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * kMaxWarps, DP <= 64 ? 3 : 1)
    flash_fwd_kernel(const Args a) {
  using C = Cfg<T, DP>;
  constexpr int BK = C::BK, NT = C::NT, KS = C::KS, QW = C::QW, NST = C::NST;
  constexpr int KSTK = C::KSTK, KSTV = C::KSTV, TK = C::TK, TILE = C::TILE;
  constexpr int NO = DP / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem);  // [stage][K [BK][KSTK], V [BK][KSTV]], then fp32's lo
  T* lo_kv = kv + NST * TILE;          // fp32: [stage][K lo, V lo], laid out as kv

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nthreads = blockDim.x, R = nthreads / 2;  // 16 rows a warp
  const int S = a.S, D = a.D;
  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * R, wr0 = q0 + 16 * w;
  const int r0 = wr0 + g, r1 = r0 + 8;  // this thread's rows
  const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  // keys [k_lo, k_hi) that some row of the block can see
  const int k_end = min(S, a.true_len);
  int k_hi = k_end;
  if (a.causal) k_hi = min(k_hi, q0 + R);
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_first = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + BK - 1) / BK : 0;

  // cp.async of the tile at key k0 into stage st; keys past S read as 0
  auto load_tile = [&](int k0, int st) {
    constexpr int CPR = DP / C::CH;  // 16-byte chunks a row
    T* ks = kv + st * TILE;
    T* vs = ks + TK;
    for (int i = threadIdx.x; i < BK * CPR; i += nthreads) {
      const int r = i / CPR, c = (i - r * CPR) * C::CH, key = k0 + r;
      const int n = key < S ? max(0, min(C::CH, D - c)) : 0;
      const long long ko = n ? key * a.ks.s + c : 0, vo = n ? key * a.vs.s + c : 0;
      cp_async16(ks + r * KSTK + c, kp + ko, n * static_cast<int>(sizeof(T)));
      cp_async16(vs + r * KSTV + c, vp + vo, n * static_cast<int>(sizeof(T)));
    }
  };
  // NST - 1 tiles in flight ahead of the one multiplied; one group a tile,
  // empty past the last, so that wait<NST - 2> always means "tile it"
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < n_tiles) load_tile(k_first + j * BK, j);
    cp_async_commit();
  }

  // Q's A fragments, once: registers (QREG) or this lane's words in shared
  // memory, [warp][k step][QW / 4][lane][4] (16-byte loads free of conflicts)
  constexpr int QR = C::QREG ? KS : 1;
  uint32_t qf[QR][QW];
  uint32_t* qsm = reinterpret_cast<uint32_t*>(smem + C::KV_BYTES) + w * KS * 32 * QW + lane * 4;
  {
    const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* q0r = qp + static_cast<long long>(min(r0, S - 1)) * a.qs.s;
    const T* q1r = qp + static_cast<long long>(min(r1, S - 1)) * a.qs.s;
    const int D0 = r0 < S ? D : 0, D1 = r1 < S ? D : 0;  // rows past S read as 0
    float4 x0, x1;  // fp32: this thread's d 16 (kk / 2) + 4t + [0, 4) of its rows
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t f[QW];
      if constexpr (C::kF32) {  // k = t, t + 4 are d 16 (kk / 2) + 4t + 2 (kk % 2) + {0, 1} (see K)
        if (kk % 2 == 0) {
          x0 = ld4(q0r, 8 * kk + 4 * t, D0);
          x1 = ld4(q1r, 8 * kk + 4 * t, D1);
        }
        split_tf32(kk % 2 ? x0.z : x0.x, f[0], f[4]);
        split_tf32(kk % 2 ? x1.z : x1.x, f[1], f[5]);
        split_tf32(kk % 2 ? x0.w : x0.y, f[2], f[6]);
        split_tf32(kk % 2 ? x1.w : x1.y, f[3], f[7]);
      } else {
        const int c = kk * 16 + 2 * t;
        f[0] = ld_pair(q0r, c, D0);
        f[1] = ld_pair(q1r, c, D1);
        f[2] = ld_pair(q0r, c + 8, D0);
        f[3] = ld_pair(q1r, c + 8, D1);
      }
      if constexpr (C::QREG) {
#pragma unroll
        for (int i = 0; i < QW; ++i) qf[kk][i] = f[i];
      } else {
#pragma unroll
        for (int i = 0; i < QW; i += 4)
          *reinterpret_cast<uint4*>(qsm + (kk * QW + i) * 32) =
              make_uint4(f[i], f[i + 1], f[i + 2], f[i + 3]);
      }
    }
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0, st = 0; it < n_tiles; ++it, st = st + 1 == NST ? 0 : st + 1) {
    const int k0 = k_first + it * BK;
    cp_async_wait<NST - 2>();  // this thread's copies of tile it have landed
    if constexpr (C::kF32) {
      // split them, each element once: hi in place, lo in the stage's lo
      // buffer. These are the chunks load_tile gave this thread, so no
      // barrier is needed before; the one below publishes them
      float* hi = kv + st * TILE;
      float* lo = lo_kv + st * TILE;
      constexpr int CPR = DP / 4;
      for (int i = threadIdx.x; i < BK * CPR; i += nthreads) {
        const int r = i / CPR, c = (i - r * CPR) * 4;
#pragma unroll
        for (int kv_i = 0; kv_i < 2; ++kv_i) {  // K, then V
          const int e = kv_i ? TK + r * KSTV + c : r * KSTK + c;
          const float4 x = *reinterpret_cast<const float4*>(hi + e);
          uint4 h, l;
          split_tf32(x.x, h.x, l.x);
          split_tf32(x.y, h.y, l.y);
          split_tf32(x.z, h.z, l.z);
          split_tf32(x.w, h.w, l.w);
          *reinterpret_cast<uint4*>(hi + e) = h;
          *reinterpret_cast<uint4*>(lo + e) = l;
        }
      }
    }
    // tile it is visible to every warp, and every warp is done with tile
    // it - 1, whose stage takes tile it + NST - 1
    __syncthreads();
    if (it + NST - 1 < n_tiles)
      load_tile(k0 + (NST - 1) * BK, st == 0 ? NST - 1 : st - 1);
    cp_async_commit();
    const T* Ks = kv + st * TILE;
    const T* Vs = Ks + TK;
    const T* Kl = lo_kv + st * TILE;  // fp32's lo
    const T* Vl = Kl + TK;

    // warp-uniform: does no row of this warp see the tile; may some not see all of it
    const int kmax = k0 + BK - 1;
    const bool skip = (a.causal && k0 > wr0 + 15) || (a.window > 0 && kmax <= wr0 - a.window);
    if (!skip) {
      const bool masked = kmax >= k_end || (a.causal && kmax > wr0) ||
                          (a.window > 0 && k0 <= wr0 + 15 - a.window);
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

      // S = Q K^T
      uint4 kh4[NT], kl4[NT];  // fp32: K hi and lo for two k steps
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t f[QW];
        if constexpr (C::QREG) {
#pragma unroll
          for (int i = 0; i < QW; ++i) f[i] = qf[kk][i];
        } else {
#pragma unroll
          for (int i = 0; i < QW; i += 4) {
            const uint4 u = *reinterpret_cast<const uint4*>(qsm + (kk * QW + i) * 32);
            f[i] = u.x, f[i + 1] = u.y, f[i + 2] = u.z, f[i + 3] = u.w;
          }
        }
        if constexpr (C::kF32) {
          const uint32_t ah[4] = {f[0], f[1], f[2], f[3]}, al[4] = {f[4], f[5], f[6], f[7]};
          // B = K^T (k = d, n = key). The d order inside a pair of k steps
          // is permuted, as in Q's fragment: thread t's k = t, t + 4 are
          // d 16 (kk / 2) + 4t + 2 (kk % 2) + {0, 1}, so one 16-byte load
          // of its key's row serves both steps (bank 16g + 4t: no conflict)
          if (kk % 2 == 0) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int e = (n * 8 + g) * KSTK + 8 * kk + 4 * t;
              kh4[n] = *reinterpret_cast<const uint4*>(Ks + e);
              kl4[n] = *reinterpret_cast<const uint4*>(Kl + e);
            }
          }
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            bh[n][0] = kk % 2 ? kh4[n].z : kh4[n].x, bh[n][1] = kk % 2 ? kh4[n].w : kh4[n].y;
            bl[n][0] = kk % 2 ? kl4[n].z : kl4[n].x, bl[n][1] = kk % 2 ? kl4[n].w : kl4[n].y;
          }
          // s += q_hi k_lo, then q_lo k_hi, then q_hi k_hi, each over the n8
          // tiles in turn, so consecutive mma steps are independent
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(s[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(s[n], al, bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(s[n], ah, bh[n][0], bh[n][1]);
        } else {
          const uint32_t aq[4] = {f[0], f[1], f[2], f[3]};
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {  // keys np*16 + [0, 16): two n8 tiles
            uint32_t bb[4];
            ldsm_x4(bb, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * KSTK + kk * 16 +
                            ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], aq, bb[0], bb[1]);
            mma_bf16(s[2 * np + 1], aq, bb[2], bb[3]);
          }
        }
      }

      // scale, mask, row max over the quad
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1), row = e < 2 ? r0 : r1;
          const bool vis = !masked || (key < k_end && (!a.causal || key <= row) &&
                                       (a.window <= 0 || key > row - a.window));
          const float x = vis ? s[n][e] * a.scale_log2 : -INFINITY;
          s[n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));

      // online softmax; a row that has seen nothing keeps m = -inf, l = 0
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = exp2f(m0 - mu0), c1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = exp2f(s[n][0] - mu0);
        s[n][1] = exp2f(s[n][1] - mu0);
        s[n][2] = exp2f(s[n][2] - mu1);
        s[n][3] = exp2f(s[n][3] - mu1);
        l0 += s[n][0];
        l0 += s[n][1];
        l1 += s[n][2];
        l1 += s[n][3];
      }

      // O += P V
      if constexpr (C::kF32) {
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          // A: logical k = t is key 2t, k = t + 4 is key 2t + 1
          uint32_t ph[4], pl[4];
          split_tf32(s[kk][0], ph[0], pl[0]);
          split_tf32(s[kk][2], ph[1], pl[1]);
          split_tf32(s[kk][1], ph[2], pl[2]);
          split_tf32(s[kk][3], ph[3], pl[3]);
          // B = V (k = key, n = d): keys 2t, 2t + 1 as in P. The d order is
          // permuted across the n8 tiles: column g of tile n is d
          // 32 (n / 4) + 4g + n % 4, so one 16-byte load of each key row serves
          // four tiles (bank 8t + 4g: no conflict); the store undoes it
#pragma unroll
          for (int ng = 0; ng < DP / 32; ++ng) {
            const int e = (kk * 8 + 2 * t) * KSTV + 32 * ng + 4 * g;
            const uint4 h0 = *reinterpret_cast<const uint4*>(Vs + e);
            const uint4 h1 = *reinterpret_cast<const uint4*>(Vs + e + KSTV);
            const uint4 l0 = *reinterpret_cast<const uint4*>(Vl + e);
            const uint4 l1 = *reinterpret_cast<const uint4*>(Vl + e + KSTV);
            const uint32_t bh0[4] = {h0.x, h0.y, h0.z, h0.w}, bh1[4] = {h1.x, h1.y, h1.z, h1.w};
            const uint32_t bl0[4] = {l0.x, l0.y, l0.z, l0.w}, bl1[4] = {l1.x, l1.y, l1.z, l1.w};
            // o += p_hi v_lo, then p_lo v_hi, then p_hi v_hi, as for s
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[4 * ng + i], ph, bl0[i], bl1[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[4 * ng + i], pl, bh0[i], bh1[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(o[4 * ng + i], ph, bh0[i], bh1[i]);
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < NT / 2; ++ks) {
          const uint32_t ap[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                  pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                  pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                  pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
          for (int dp = 0; dp < DP / 16; ++dp) {  // d dp*16 + [0, 16): two n8 tiles
            uint32_t bb[4];
            ldsm_x4_trans(bb, Vs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * KSTV +
                                  dp * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], ap, bb[0], bb[1]);
            mma_bf16(o[2 * dp + 1], ap, bb[2], bb[3]);
          }
        }
      }
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float i0 = l0 == 0.f ? 0.f : 1.f / l0, i1 = l1 == 0.f ? 0.f : 1.f / l1;
  T* op = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;
  if constexpr (C::kF32) {  // thread t holds d 32 ng + 8t + [0, 8) of its rows
#pragma unroll
    for (int ng = 0; ng < DP / 32; ++ng) {
      const int c = 32 * ng + 8 * t;
      float x0[8], x1[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x0[i] = o[4 * ng + i][0] * i0, x0[i + 4] = o[4 * ng + i][1] * i0;
        x1[i] = o[4 * ng + i][2] * i1, x1[i + 4] = o[4 * ng + i][3] * i1;
      }
      if (r0 < S) st8(op + r0 * a.os.s, c, D, x0);
      if (r1 < S) st8(op + r1 * a.os.s, c, D, x1);
    }
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < S) st2(op + r0 * a.os.s, c, D, o[n][0] * i0, o[n][1] * i0);
      if (r1 < S) st2(op + r1 * a.os.s, c, D, o[n][2] * i1, o[n][3] * i1);
    }
  }
}

int warps_for(int S) { return S >= 16 * kMaxWarps ? kMaxWarps : (S + 15) / 16; }

template <typename T, int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const int nw = warps_for(a.S);
  const int smem = C::smem(nw);
  auto kern = flash_fwd_kernel<T, DP>;
  if (C::smem(kMaxWarps) > 48 * 1024) {  // once a device: allow the most any launch takes
    static bool set[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || !set[dev]) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::smem(kMaxWarps));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) set[dev] = true;
    }
  }
  const dim3 grid((a.S + 16 * nw - 1) / (16 * nw), static_cast<unsigned>(B) * a.Hq);
  kern<<<grid, 32 * nw, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

template <typename T>
int smem_for(int S, int D) {
  const int nw = warps_for(S);
  if (D <= 32) return Cfg<T, 32>::smem(nw);
  if (D <= 64) return Cfg<T, 64>::smem(nw);
  if (D <= 128) return Cfg<T, 128>::smem(nw);
  return Cfg<T, 256>::smem(nw);
}

template <typename T>
int keys_per_tile(int D) {
  return D <= 128 ? Cfg<T, 128>::BK : Cfg<T, 256>::BK;
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, S, D), out like q, each addressed by
// element strides (b, h, s) with a contiguous last dimension; base pointers
// and strides 16-byte aligned. One launch takes B * Hq <= 65,535 (b, h)
// pairs (gridDim.y); the wrapper launches a larger batch in ranges of
// whole batches (flash_attention/ops.py batch_ranges). dtype: 0 = float32, 1 = bfloat16. window <= 0
// means no window. Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int B, int Hq, int Hkv, int S, int D,
    int true_len, int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      static_cast<long long>(B) * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, Hq, Hkv, S, D, true_len, causal, window,
               scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_width<float>(a, B, s);
  if (dtype == 1) return dispatch_width<__nv_bfloat16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape flash_attention_fwd takes for (S, D, dtype): warps a
// block, keys a tile and dynamic shared memory in bytes. Returns 0, or
// cudaErrorInvalidValue for a dtype other than 0 or 1.
extern "C" int flash_attention_config(int S, int D, int dtype, int* warps, int* keys,
                                      int* smem_bytes) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  *warps = warps_for(S);
  *keys = dtype == 0 ? keys_per_tile<float>(D) : keys_per_tile<__nv_bfloat16>(D);
  *smem_bytes = dtype == 0 ? smem_for<float>(S, D) : smem_for<__nv_bfloat16>(S, D);
  return 0;
}
