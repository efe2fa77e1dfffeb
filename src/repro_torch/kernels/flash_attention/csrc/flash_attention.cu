// Flash attention, forward: out = softmax(q k^T * scale + mask) v per head,
// with an online softmax so the (S, S) score matrix never reaches device
// memory.
//
// Replaces the TPU kernel flash_attention (_fa_kernel) of
// src/repro/kernels/flash_attention/kernel.py: fp32 running max m, sum l
// and accumulator for fp32 and bf16 inputs; optional causal mask and
// sliding window (position i sees [i - W + 1, i]); GQA (head h reads kv
// head h / (Hq / Hkv)); keys at or past true_len masked; rows with l == 0
// give 0.
//
// What bounds it: operations. At the main path's shape (B 8, H 12, S 256,
// D 64) the two products are 4*B*H*S^2*D = 1.61 GFLOP over 25.2 MB, so it
// is compute-bound: 24 us at the 67 TFLOP/s fp32 rate of the CUDA cores
// this kernel uses, 1.6 us at the 989 TFLOP/s bf16 tensor-core rate.
//
// What the design does about it: one block per (64 query rows, head,
// batch). A loop over 32-key tiles staged in shared memory takes the place
// of the TPU's sequential key-block grid axis; tiles that no row of the
// block can see under the causal mask or window are never loaded. Four
// threads share a query row, each holding a quarter of q and of the
// accumulator in registers as float4 chunks, so one shared-memory load
// feeds four FMAs and the 8 rows of a warp read the same K/V words
// (broadcast, no bank conflicts). The two partial dot products are joined
// by two warp shuffles. Plain fp32 FMA on the CUDA cores: tensor cores
// (mma/wgmma) and TMA are later work. Any S is handled by masking, so the
// wrapper pads nothing; q/k/v/out are read through (b, h, s) strides, so
// the model's (B, S, H, D) tensors are used in place without a transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kG = 4;                   // threads per query row
constexpr int kThreads = kBQ * kG;      // 256
constexpr int kBK = 32;                 // keys per shared-memory tile

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

struct Strides {
  long long b, h, s;
};

// DMAX: compile-time bound on the padded head width DP (a multiple of 16).
// Thread g of a row owns columns 16*c + 4*g + {0..3} for c < DMAX/16.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int Hq,
    int Hkv, int S, int D, int DP, int true_len, int causal, int window,
    float scale) {
  constexpr int NC = DMAX / 16;         // float4 chunks per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBK][DP]
  float* Vs = Ks + kBK * DP;                     // [kBK][DP]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, row = tid / kG, g = tid % kG;
  const int qpos = q0 + row;
  const int nc = DP / 16;               // chunks in use (uniform)

  float qr[NC][4], acc[NC][4];
  const T* qrow = q + b * qs.b + h * qs.h + static_cast<long long>(min(qpos, S - 1)) * qs.s;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * g + e;
      qr[c][e] = (c < nc && d < D) ? ld(qrow, d) : 0.f;
      acc[c][e] = 0.f;
    }
  float m = -INFINITY, l = 0.f;

  // keys [k_lo, k_hi) that some row of this block can see
  const int k_end = min(S, true_len);
  int k_lo = 0, k_hi = k_end;
  if (causal) k_hi = min(k_hi, min(q0 + kBQ, S));
  if (window > 0) k_lo = max(0, q0 - window + 1);

  const T* kbase = k + b * ks.b + hk * ks.h;
  const T* vbase = v + b * vs.b + hk * vs.h;
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int j = e / DP, d = e - j * DP, kpos = k0 + j;
      const bool in = kpos < S && d < D;
      Ks[e] = in ? ld(kbase, kpos * ks.s + d) : 0.f;
      Vs[e] = in ? ld(vbase, kpos * vs.s + d) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* K4 = reinterpret_cast<const float4*>(Ks + j * DP);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          const float4 kk = K4[4 * c + g];
          dot += qr[c][0] * kk.x + qr[c][1] * kk.y + qr[c][2] * kk.z + qr[c][3] * kk.w;
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + j;
      bool vis = kpos < k_end;
      if (causal) vis = vis && kpos <= qpos;
      if (window > 0) vis = vis && kpos > qpos - window;
      s[j] = vis ? dot * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }

    const float m_new = fmaxf(m, mt);
    if (m_new != -INFINITY) {           // some key of this row visible so far
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float4* V4 = reinterpret_cast<const float4*>(Vs + j * DP);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float4 vv = V4[4 * c + g];
            acc[c][0] += p * vv.x;
            acc[c][1] += p * vv.y;
            acc[c][2] += p * vv.z;
            acc[c][3] += p * vv.w;
          }
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (qpos < S) {
    const float inv = l == 0.f ? 0.f : 1.f / l;
    T* orow = o + b * os.b + h * os.h + static_cast<long long>(qpos) * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * c + 4 * g + e;
        if (c < nc && d < D) st(orow, d, acc[c][e] * inv);
      }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int Hq, int Hkv, int S,
           int D, int true_len, int causal, int window, float scale,
           cudaStream_t stream) {
  const int DP = (D + 15) / 16 * 16;
  const size_t smem = 2ull * kBK * DP * sizeof(float);
  auto kern = flash_fwd_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, static_cast<unsigned>(B) * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, Hq, Hkv, S, D, DP, true_len, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int Hq, int Hkv, int S, int D, int true_len, int causal,
                   int window, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, D, true_len,
                         causal, window, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, D, true_len,
                          causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, qs, ks, vs, os, B, Hq, Hkv, S, D, true_len,
                        causal, window, scale, stream);
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, S, D), out like q, each addressed by
// element strides (b, h, s) with a contiguous last dimension.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int B, int Hq, int Hkv, int S, int D,
    int true_len, int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      static_cast<long long>(B) * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_width<float>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv, S, D,
                                 true_len, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_width<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, Hq, Hkv,
                                         S, D, true_len, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
