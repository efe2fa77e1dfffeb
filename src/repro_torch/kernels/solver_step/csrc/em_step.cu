// Fused Euler–Maruyama / ancestral update for a (B, D) state:
//
//   x' = c0*x + c1*s + c2*z        per-row fp32 coefficients, fp32 math,
//                                  stored in the operand dtype
//
// The update of every fixed-grid stochastic baseline has this form: the
// EM step (c0 = 1 - h*a(t), c1 = h*g^2, c2 = sqrt(h)*g), the ancestral
// predictor and the Langevin corrector.
//
// Replaces the TPU kernel em_step (_em_kernel) of
// src/repro/kernels/solver_step/kernel.py.
//
// What bounds it: memory. Per element it reads three operands and writes
// one and does five flops. At the DiT state (B 8, D 196,608, fp32) that is
// 25.2 MB, or 7.5 us at 3.35 TB/s.
//
// What the design does about it: one elementwise pass over a (D-tile, B)
// grid. A block reads its row's three coefficients once; each thread moves
// 16-byte packs (4 fp32 or 8 bf16) when D is a multiple of the pack and the
// operands are 16-byte aligned (the wrapper refuses unaligned operands), and
// single elements otherwise. The tile's ragged end is masked; D is never
// padded. bf16 operands are widened in registers and rounded once at the
// store. The products and sums are rounded one by one in the plain version's
// order, ((c0*x + c1*s) + c2*z), with no FMA contraction, so the kernel gives
// the plain version's bits, and the same inputs the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPacks = 2;  // 16-byte packs per thread per tile

template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float& d, float v) { d = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

__device__ __forceinline__ float update(float c0, float c1, float c2, float x,
                                        float s, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, x), __fmul_rn(c1, s)), __fmul_rn(c2, z));
}

template <typename T>
__host__ __device__ constexpr long long tile_elems() {
  return static_cast<long long>(kThreads) * kPacks * Pack<T>::N;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) em_step_kernel(
    const T* __restrict__ x, const T* __restrict__ s, const T* __restrict__ z,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const float* __restrict__ c2, T* __restrict__ out, long long D, int packed) {
  constexpr int N = Pack<T>::N;
  const long long row = blockIdx.y;
  const float a = c0[row], b = c1[row], c = c2[row];
  const long long base = row * D;
  const long long begin = static_cast<long long>(blockIdx.x) * tile_elems<T>();
  if (packed) {
    // D % N == 0 and every pointer is 16-byte aligned: a pack never
    // straddles a row, and the tile's end masks whole packs
#pragma unroll
    for (int k = 0; k < kPacks; ++k) {
      const long long col =
          begin + (static_cast<long long>(k) * kThreads + threadIdx.x) * N;
      if (col < D) {
        const long long i = base + col;
        const uint4 vx = *reinterpret_cast<const uint4*>(x + i);
        const uint4 vs = *reinterpret_cast<const uint4*>(s + i);
        const uint4 vz = *reinterpret_cast<const uint4*>(z + i);
        const T* px = reinterpret_cast<const T*>(&vx);
        const T* ps = reinterpret_cast<const T*>(&vs);
        const T* pz = reinterpret_cast<const T*>(&vz);
        uint4 vo;
        T* po = reinterpret_cast<T*>(&vo);
#pragma unroll
        for (int e = 0; e < N; ++e)
          narrow(po[e], update(a, b, c, widen(px[e]), widen(ps[e]), widen(pz[e])));
        *reinterpret_cast<uint4*>(out + i) = vo;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPacks * N; ++k) {
      const long long col = begin + static_cast<long long>(k) * kThreads + threadIdx.x;
      if (col < D) {
        const long long i = base + col;
        narrow(out[i], update(a, b, c, widen(x[i]), widen(s[i]), widen(z[i])));
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x, const void* s, const void* z, const float* c0,
           const float* c1, const float* c2, void* out, long long B, long long D,
           cudaStream_t stream) {
  const long long tiles = (D + tile_elems<T>() - 1) / tile_elems<T>();
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  const int packed = D % Pack<T>::N == 0;
  em_step_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s), static_cast<const T*>(z),
      c0, c1, c2, static_cast<T*>(out), D, packed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, s, z and out share it). c0, c1, c2
// are (B,) float32; x, s, z and out must be 16-byte aligned. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int solver_step_em(const void* x, const void* s, const void* z,
                              const void* c0, const void* c1, const void* c2,
                              void* out, long long B, long long D, int dtype,
                              void* stream) {
  if (B <= 0 || B > 65535 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, s, z, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f0 = static_cast<const float*>(c0);
  const float* f1 = static_cast<const float*>(c1);
  const float* f2 = static_cast<const float*>(c2);
  if (dtype == 0) return launch<float>(x, s, z, f0, f1, f2, out, B, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, s, z, f0, f1, f2, out, B, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
