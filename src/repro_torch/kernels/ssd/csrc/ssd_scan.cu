// Chunked Mamba2 SSD scan (state-space duality), the model's layout:
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
// Replaces the TPU kernel ssd_scan (_ssd_kernel) of
// src/repro/kernels/ssd/kernel.py. That kernel runs a (B, H, S/Q) grid
// in order on one core, carries the (N, P) state in VMEM scratch from one
// grid step to the next, and needs its operands transposed to head-major
// layout and S padded to the chunk. Here one block owns one (b, h) pair
// and walks its chunks in a loop, so the state never leaves the block;
// the operands are read in the model's layout, and rows past S are
// masked (loaded as dt = 0, x = B = C = 0, never stored), so nothing is
// transposed or padded in device memory.
//
// What bounds it: operations. Per chunk and head the kernel does
// Q·Q·N (C·Bᵀ) + Q·Q·P (the masked scores times x) + 2·Q·N·P (C·state and
// the state update) multiply-adds in fp32 on the CUDA cores, against one
// read of x, B and C and one write of y. At mamba2-2.7b's prefill shape
// that is tens of GFLOP against a third of a GB.
//
// What the design does about it: everything of a chunk stays in shared
// memory (C, B, x, the masked Q×Q scores and the N×P state: 135 KB at
// N = 128, P = 64, with Q = 64 so that it fits under the 227 KB a block
// can have), and every product is a register-tiled loop in which each
// thread keeps a 4×4 (state: up to 8×4) tile of sums and reads its
// operands from shared memory as 16-byte vectors, four steps of the
// contraction at a time, so that a step costs fewer shared-memory
// transactions than multiply-adds. Rows of C, B and the scores are
// padded by four floats: 16-byte aligned, and the reads of 16 rows across
// a warp fall in distinct banks. The Q×Q scores are exponentiated only
// for s ≤ t (above the diagonal L_t − L_s > 0 would overflow); expf, not
// __expf. Tensor cores (mma.sync / wgmma), TMA and sharing C·Bᵀ across
// the heads of a group are later work.
//
// Determinism: every sum runs in a fixed order in one thread; no atomics,
// so the same inputs give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;         // chunk length
constexpr int kThreads = 256;  // a 16×16 grid of threads
constexpr int kMaxN = 128;     // d_state: a multiple of 16 up to 128
constexpr int kMaxP = 64;      // head_dim: a multiple of 16 up to 64 (16 columns of four)

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr size_t smem_floats(int N, int P) {
  return 2 * kQ * (N + 4)     // C, B (rows padded, 16-byte aligned)
         + kQ * P             // x
         + kQ * (kQ + 4)      // masked scores (rows padded, 16-byte aligned)
         + N * P              // state
         + 4 * kQ;            // L, dt, w = e^{L_Q−L_s}·dt_s, e^{L_t}
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a.x·b0 + a.y·b1 + a.z·b2 + a.w·b3, one multiply-add at a time, in
// that order (the order of the contraction index)
__device__ __forceinline__ float dot4(float acc, float4 a, float b0, float b1,
                                      float b2, float b3) {
  acc = fmaf(a.x, b0, acc);
  acc = fmaf(a.y, b1, acc);
  acc = fmaf(a.z, b2, acc);
  return fmaf(a.w, b3, acc);
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ final_state, int S, int H, int G, int N, int P) {
  extern __shared__ __align__(16) float smem[];
  const int CS = N + 4, MS = kQ + 4;  // row strides, multiples of 4 floats
  float* Cs = smem;
  float* Bs = Cs + kQ * CS;
  float* xs = Bs + kQ * CS;
  float* Ms = xs + kQ * P;
  float* st = Ms + kQ * MS;
  float* Ls = st + N * P;
  float* dts = Ls + kQ;
  float* ws = dts + kQ;
  float* eLs = ws + kQ;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = A[h];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int pv = P >> 2, nv = N >> 2;  // columns of four along P and N
  const bool pcol = tx < pv;           // this thread owns p = 4tx … 4tx+3

  for (int i = tid; i < N * P; i += kThreads) st[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kQ) {
    const int rows = min(kQ, S - s0);
    const long long row0 = static_cast<long long>(b) * S + s0;  // (b, s0)

    // ---- load the chunk; rows past S are zeros with dt = 0
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      xs[i] = r < rows ? load(x, ((row0 + r) * H + h) * P + p) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      const long long off = ((row0 + r) * G + g) * N + n;
      Bs[r * CS + n] = r < rows ? load(Bm, off) : 0.f;
      Cs[r * CS + n] = r < rows ? load(Cm, off) : 0.f;
    }
    if (tid < kQ) dts[tid] = tid < rows ? dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {  // L = cumsum(dt·A), in order
      float acc = 0.f;
      for (int r = 0; r < kQ; ++r) {
        acc = __fadd_rn(acc, __fmul_rn(dts[r], a));
        Ls[r] = acc;
      }
    }
    __syncthreads();

    // ---- scores[t][s] = C_t·B_s, masked and decayed:
    //      M[t][s] = s ≤ t ? scores · e^{L_t−L_s} · dt_s : 0
    // thread (ty, tx) owns t = ty + 16i, s = tx + 16j; n in steps of four
    if (tid < kQ) {
      ws[tid] = expf(Ls[kQ - 1] - Ls[tid]) * dts[tid];
      eLs[tid] = expf(Ls[tid]);
    }
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&Cs[(ty + 16 * i) * CS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(&Bs[(tx + 16 * j) * CS + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = dot4(acc[i][j], cv[i], bv[j].x, bv[j].y, bv[j].z, bv[j].w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          Ms[t * MS + s] = s <= t ? acc[i][j] * expf(Ls[t] - Ls[s]) * dts[s] : 0.f;
        }
    }
    __syncthreads();

    // ---- y[t][p] = Σ_s M[t][s] x[s][p] + e^{L_t} Σ_n C[t][n] state[n][p]
    // thread (ty, tx) owns t = ty + 16i, p = 4tx + k; the state is the one
    // entering the chunk (updated after the next barrier)
    if (pcol) {
      float yi[4][4] = {}, yo[4][4] = {};
      for (int s = 0; s < kQ; s += 4) {
        float4 mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = ld4(&Ms[(ty + 16 * i) * MS + s]);
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = ld4(&xs[(s + r) * P + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            yi[i][k] = dot4(yi[i][k], mv[i], at(xv[0], k), at(xv[1], k), at(xv[2], k),
                            at(xv[3], k));
      }
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&Cs[(ty + 16 * i) * CS + n]);
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = ld4(&st[(n + r) * P + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            yo[i][k] = dot4(yo[i][k], cv[i], at(sv[0], k), at(sv[1], k), at(sv[2], k),
                            at(sv[3], k));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t < rows) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            store(y, ((row0 + t) * H + h) * P + 4 * tx + k, yi[i][k] + eLs[t] * yo[i][k]);
        }
      }
    }
    // B is no longer read by the scores: scale its rows by w for the update
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      Bs[r * CS + n] *= ws[r];
    }
    __syncthreads();

    // ---- state[n][p] = e^{L_Q} state[n][p] + Σ_s (w_s B[s][n]) x[s][p]
    // thread (ty, tx) owns n = 4(ty + 16c) + d, p = 4tx + k
    if (pcol) {
      const float decay = expf(Ls[kQ - 1]);
      float acc[kMaxN / 64][4][4] = {};
      for (int s = 0; s < kQ; ++s) {
        const float4 xv = ld4(&xs[s * P + 4 * tx]);
#pragma unroll
        for (int c = 0; c < kMaxN / 64; ++c) {
          if (ty + 16 * c < nv) {
            const float4 bv = ld4(&Bs[s * CS + 4 * (ty + 16 * c)]);
#pragma unroll
            for (int d = 0; d < 4; ++d)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[c][d][k] = fmaf(at(bv, d), at(xv, k), acc[c][d][k]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxN / 64; ++c)
        if (ty + 16 * c < nv) {
#pragma unroll
          for (int d = 0; d < 4; ++d)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int idx = (4 * (ty + 16 * c) + d) * P + 4 * tx + k;
              st[idx] = decay * st[idx] + acc[c][d][k];
            }
        }
    }
    __syncthreads();
  }

  if (final_state != nullptr) {
    float* out = final_state + static_cast<long long>(blockIdx.x) * N * P;
    for (int i = tid; i < N * P; i += kThreads) out[i] = st[i];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* C, void* y, void* final_state, int batch, int S, int H,
           int G, int N, int P, cudaStream_t stream) {
  // opt in once to the largest shared memory any accepted shape needs
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxN, kMaxP) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const size_t smem = smem_floats(N, P) * sizeof(float);
  ssd_scan_kernel<T><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(final_state), S, H, G, N, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All operands contiguous in the layouts above; dtype 0 = float32,
// 1 = bfloat16 (x, Bm, C, y); final_state may be null. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* C, void* y,
                            void* final_state, int batch, int S, int H, int G,
                            int N, int P, int dtype, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N < 16 ||
      N > kMaxN || N % 16 != 0 || P < 16 || P > kMaxP || P % 16 != 0 ||
      static_cast<long long>(batch) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, C, y, final_state, batch, S, H, G, N, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, C, y, final_state, batch, S, H, G, N, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
