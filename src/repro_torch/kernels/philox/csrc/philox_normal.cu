// Per-row counter-based normals: P1, the port's per-slot noise draw.
//
//   row i of z (B, D) fp32 = Philox4x32-10(key     = seed_i's two 32-bit halves,
//                                          counter = (j4, 0, counter_i's halves))
//                            for j4 = 0 .. ceil(D / 4) - 1, four words a call,
//                            each pair of words two normals by Box-Muller
//
// No TPU kernel: the reference draws a slot's noise with XLA's threefry
// (_draw_noise in src/repro/core/solvers/adaptive.py, one key a slot). The
// port keeps a slot's stream as device data, a (B,) int64 seed and a (B,)
// int64 counter, so a captured CUDA graph draws for whatever request sits
// in a slot now: compaction and admission move the two numbers with their
// row, and row i's draw depends on (seed_i, counter_i, D) alone. The
// kernel reads the counter and never advances it; the solver body returns
// counter + 1 (+ 2 with a projecting conditioner) as a new carry leaf. A
// row with seed < 0 is an idle slot and gets zeros.
//
// Philox4x32-10 is written out with the published constants (Salmon et
// al., SC'11, "Parallel random numbers: as easy as 1, 2, 3"): multipliers
// 0xD2511F53 and 0xCD9E8D57, Weyl increments 0x9E3779B9 and 0xBB67AE85,
// ten rounds, the key bumped before rounds 1..9. curand_kernel.h is not
// used, so ref.py reproduces the words bit for bit. A word w becomes the
// uniform ((w >> 8) + 0.5) * 2^-24 in (0, 1], so the logarithm never sees
// 0; words (w0, w1) give r cos(2 pi u1), r sin(2 pi u1) with
// r = sqrt(-2 log u0), and (w2, w3) likewise. The adds and products are
// rounded one at a time (__fadd_rn, __fmul_rn: no contraction), and
// logf, sqrtf, sinf and cosf are the accurate library versions, so the
// normals agree with ref.py's fp32 torch.log/sqrt/sin/cos within a few
// ulps.
//
// What bounds it: memory. At the DiT's state (B 8, D 196,608) it writes
// 6.29 MB: 1.88 us at 3.35 TB/s, reading 16 bytes a row. Each element
// costs about 80 integer and floating-point operations (a quarter of a
// Philox call, half a logarithm, square root, sine and cosine), ~0.13
// GOP there, which the SMs retire in about the same time as the store.
//
// What the design does about it: one flat pass, a thread one Philox call
// (four adjacent elements of a row) a pass, neighbouring threads
// neighbouring groups, a grid-stride loop above a wave of blocks. The
// row of a group is one 32-bit division while B * ceil(D / 4) < 2^31
// (else 64-bit). A whole group is one 16-byte store where the row length
// is a multiple of 4 and the output starts on 16 bytes (`vec`); the
// ragged last group of a row is stored element by element. With `raw`
// the kernel writes the four uint32 words instead of the normals (the
// bit-exact check against ref.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform(uint32_t w) {
  return __fmul_rn(__fadd_rn(__uint2float_rn(w >> 8), 0.5f), 5.9604644775390625e-8f);
}

// (r cos(theta), r sin(theta)), r = sqrt(-2 log u0), theta = 2 pi u1
__device__ __forceinline__ float2 box_muller(uint32_t w0, uint32_t w1) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(uniform(w0))));
  const float theta = __fmul_rn(6.2831853071795864769f, uniform(w1));
  return make_float2(__fmul_rn(r, cosf(theta)), __fmul_rn(r, sinf(theta)));
}

template <typename Index>
__global__ void __launch_bounds__(kThreads) philox_normal_kernel(
    const long long* __restrict__ seed, const long long* __restrict__ counter,
    void* __restrict__ out, long long D, Index groups, Index total, int raw, int vec) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index g = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; g < total;
       g += stride) {
    const Index row = g / groups;
    const long long col = static_cast<long long>(g - row * groups) * 4;
    const long long s = __ldg(seed + row);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s >= 0) {
      const unsigned long long c = static_cast<unsigned long long>(__ldg(counter + row));
      const unsigned long long k = static_cast<unsigned long long>(s);
      const uint4 q = philox4x32_10(
          make_uint4(static_cast<uint32_t>(col >> 2), 0u, static_cast<uint32_t>(c),
                     static_cast<uint32_t>(c >> 32)),
          make_uint2(static_cast<uint32_t>(k), static_cast<uint32_t>(k >> 32)));
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
      if (!raw) {
        const float2 a = box_muller(q.x, q.y), b = box_muller(q.z, q.w);
        v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
      }
    }
    const long long at = static_cast<long long>(row) * D + col;
    if (raw) {
      uint32_t* o = static_cast<uint32_t*>(out);
      if (vec) {
        *reinterpret_cast<uint4*>(o + at) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) o[at + e] = w[e];
      }
    } else {
      float* o = static_cast<float*>(out);
      if (vec) {
        __stcs(reinterpret_cast<float4*>(o + at), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) o[at + e] = v[e];
      }
    }
  }
}

}  // namespace

// seed, counter: (B,) int64 on the device; out: (B, D) fp32 (or, with raw,
// uint32 words), contiguous. `vec` asks for 16-byte stores (refused with
// cudaErrorMisalignedAddress unless D % 4 == 0 and out is 16-byte
// aligned). `max_blocks` caps the grid (the wrapper passes a wave of the
// card). Launches one kernel on `stream`; returns cudaGetLastError().
extern "C" int philox_normal(const void* seed, const void* counter, void* out,
                             long long B, long long D, int raw, int vec, int max_blocks,
                             void* stream) {
  if (B <= 0 || D <= 0 || max_blocks <= 0 || (D + 3) / 4 > 4294967295LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (D % 4 || reinterpret_cast<uintptr_t>(out) % 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long groups = (D + 3) / 4, total = B * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < max_blocks ? blocks : max_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  const long long* ct = static_cast<const long long*>(counter);
  if (total < 2147483647LL) {
    philox_normal_kernel<unsigned><<<grid, kThreads, 0, s>>>(
        sd, ct, out, D, static_cast<unsigned>(groups), static_cast<unsigned>(total), raw, vec);
  } else {
    philox_normal_kernel<unsigned long long><<<grid, kThreads, 0, s>>>(
        sd, ct, out, D, static_cast<unsigned long long>(groups),
        static_cast<unsigned long long>(total), raw, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
