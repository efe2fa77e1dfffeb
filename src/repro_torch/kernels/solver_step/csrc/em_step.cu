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
// What bounds it: memory, and at small states the launch. Per element it
// reads three operands and writes one and does five flops. At the DiT
// state (B 8, D 196,608, fp32) that is 25.2 MB, or 7.5 us at 3.35 TB/s;
// at Table 1's (4096, 2) it is 180 KB, 0.054 us, far under one launch.
//
// What the design does about it: one flat pass over the B*D elements of
// the contiguous operands, on a 1-D grid. A thread takes one pack of 16
// bytes (4 fp32 or 8 bf16 elements) a pass, neighbouring threads
// neighbouring packs, with a grid-stride loop once the packs pass a wave
// of blocks. A pack may straddle rows, and a row may be shorter than a
// pack. The pack's first row comes from one division of its flat index
// by D, a magic-number multiply and shift that the wrapper computes
// (32-bit indices while B*D < 2^31, else 64-bit and a true division). A
// pack inside one row takes that row's coefficients for every lane; a
// pack that crosses rows steps its lanes' column and moves to the next
// row, loading its coefficients, where the column reaches D. The
// coefficients go through the read-only path (__ldg), once a row a pack,
// not once an element. So a 2-column row costs half a fp32 thread, where
// the former (D-tile, B) grid gave it a 256-thread block, and rows no
// longer sit on gridDim.y: B is not capped at 65,535. Where x, s, z and
// out all start on 16 bytes (`vec`) a whole pack is one 16-byte load or
// store; elsewhere, and for the ragged tail of B*D, the same lanes are
// loaded one element at a time. Where a call moves more than a quarter of
// the L2, state loads and stores are streaming (evict-first: no element
// is read twice); below that they are plain, since the caller's next
// kernels read x' (and the next step its inputs) from the L2. The wrapper
// (`ops.em_kernel_config`) fixes the launch. On an H100, one pack a thread
// was as fast as two or faster at every state timed, 128 threads a block
// as fast as 64 or 256, and the streaming hints faster at the DiT's state
// and slower at (4096, 2) and at (256, 3072) in bf16.
//
// Rounding: bf16 operands are widened in registers and rounded once at
// the store. The products and sums are rounded one by one in the plain
// version's order, ((c0*x + c1*s) + c2*z), with no FMA contraction, so
// the kernel gives the plain version's bits whatever the load width or
// the launch shape, and the same inputs the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;

// N: the elements of a 16-byte pack. kMinBlocks: the blocks an SM must
// hold (__launch_bounds__); bf16 is held to 16 (32 registers a thread), at
// which it ran as fast as the former kernel at the DiT's state, where the
// unbounded build (40 registers) was slower; fp32 ran faster unbounded
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static constexpr int kMinBlocks = 1;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr int kMinBlocks = 16;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float& d, float v) { d = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

__device__ __forceinline__ float update(float c0, float c1, float c2, float x,
                                        float s, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, x), __fmul_rn(c1, s)), __fmul_rn(c2, z));
}

// The row of flat element i: (umulhi(i, magic) + i) >> shift, exact for
// i < 2^31 (magic != 0), else a 64-bit division
__device__ __forceinline__ unsigned row_of(unsigned i, unsigned, unsigned magic, int shift) {
  return (__umulhi(i, magic) + i) >> shift;
}
__device__ __forceinline__ long long row_of(long long i, long long D, unsigned magic,
                                            int shift) {
  if (magic) {
    const unsigned u = static_cast<unsigned>(i);
    return static_cast<long long>((__umulhi(u, magic) + u) >> shift);
  }
  return i / D;
}

// Streaming (evict-first) or plain loads and stores of one element or pack
template <bool kStream, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kStream) return __ldcs(p);
  else return *p;
}
template <bool kStream, typename V>
__device__ __forceinline__ void st(V* p, const V& v) {
  if constexpr (kStream) __stcs(p, v);
  else *p = v;
}

// the pack of N elements at p + i0 into `raw`: one 16-byte load where
// `vec` and the pack is whole, else element by element (lanes at or past n
// are left 0)
template <bool kStream, typename T, typename I>
__device__ __forceinline__ void load_pack(const T* __restrict__ p, I i0, I n, int vec,
                                          uint4& raw) {
  constexpr int N = Pack<T>::N;
  if (vec && i0 + N <= n) {
    raw = ld<kStream>(reinterpret_cast<const uint4*>(p + i0));
  } else {
    raw = make_uint4(0, 0, 0, 0);
    T* q = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (i0 + e < n) q[e] = ld<kStream>(p + i0 + e);
  }
}

template <bool kStream, typename T, typename I>
__device__ __forceinline__ void store_pack(T* __restrict__ p, I i0, I n, int vec,
                                           const uint4& raw) {
  constexpr int N = Pack<T>::N;
  if (vec && i0 + N <= n) {
    st<kStream>(reinterpret_cast<uint4*>(p + i0), raw);
  } else {
    const T* q = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (i0 + e < n) st<kStream>(p + i0 + e, q[e]);
  }
}

// I is the index type: unsigned while n < 2^31 (the magic divide), else
// long long; kStream asks for evict-first state loads and stores
template <typename T, typename I, bool kStream>
__global__ void __launch_bounds__(kMaxThreads, Pack<T>::kMinBlocks) em_step_kernel(
    const T* __restrict__ x, const T* __restrict__ s, const T* __restrict__ z,
    const float* __restrict__ c0, const float* __restrict__ c1,
    const float* __restrict__ c2, T* __restrict__ out, I n, I D, unsigned magic,
    int shift, int vec) {
  constexpr int N = Pack<T>::N;
  const I packs = (n + N - 1) / N;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I pack = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; pack < packs;
       pack += stride) {
    // every load first: the state pack and the coefficients of its first row
    const I i0 = pack * N;
    uint4 rx, rs, rz;
    load_pack<kStream>(x, i0, n, vec, rx);
    load_pack<kStream>(s, i0, n, vec, rs);
    load_pack<kStream>(z, i0, n, vec, rz);
    I row = row_of(i0, D, magic, shift);
    I col = i0 - row * D;
    float a = __ldg(c0 + row), b = __ldg(c1 + row), c = __ldg(c2 + row);
    const T* px = reinterpret_cast<const T*>(&rx);
    const T* ps = reinterpret_cast<const T*>(&rs);
    const T* pz = reinterpret_cast<const T*>(&rz);
    uint4 ro;
    T* po = reinterpret_cast<T*>(&ro);
    if (col + N <= D) {  // the pack lies in one row
#pragma unroll
      for (int e = 0; e < N; ++e)
        narrow(po[e], update(a, b, c, widen(px[e]), widen(ps[e]), widen(pz[e])));
    } else {  // lanes step across rows, loading a row's coefficients where it starts
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e > 0 && ++col == D) {
          col = 0, ++row;
          if (i0 + e < n) a = __ldg(c0 + row), b = __ldg(c1 + row), c = __ldg(c2 + row);
        }
        narrow(po[e], update(a, b, c, widen(px[e]), widen(ps[e]), widen(pz[e])));
      }
    }
    store_pack<kStream>(out, i0, n, vec, ro);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool kStream>
int launch_as(const void* x, const void* s, const void* z, const float* c0,
              const float* c1, const float* c2, void* out, long long n, long long D,
              unsigned magic, int shift, int grid, int threads, int vec,
              cudaStream_t stream) {
  const T* tx = static_cast<const T*>(x);
  const T* ts = static_cast<const T*>(s);
  const T* tz = static_cast<const T*>(z);
  T* to = static_cast<T*>(out);
  if (magic)
    em_step_kernel<T, unsigned, kStream><<<grid, threads, 0, stream>>>(
        tx, ts, tz, c0, c1, c2, to, static_cast<unsigned>(n), static_cast<unsigned>(D),
        magic, shift, vec);
  else
    em_step_kernel<T, long long, kStream><<<grid, threads, 0, stream>>>(
        tx, ts, tz, c0, c1, c2, to, n, D, magic, shift, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* s, const void* z, const float* c0,
           const float* c1, const float* c2, void* out, long long n, long long D,
           unsigned magic, int shift, int grid, int threads, int vec, int evict_first,
           cudaStream_t stream) {
  return evict_first ? launch_as<T, true>(x, s, z, c0, c1, c2, out, n, D, magic, shift,
                                          grid, threads, vec, stream)
                     : launch_as<T, false>(x, s, z, c0, c1, c2, out, n, D, magic, shift,
                                           grid, threads, vec, stream);
}

}  // namespace

// x, s, z and out are n = B*D contiguous elements of `dtype` (0 = float32,
// 1 = bfloat16); c0, c1, c2 are (B,) float32. (magic, shift) divide a flat
// index by D (magic 0: a 64-bit division); grid, threads, vec and
// evict_first are the launch of ops.em_kernel_config. vec = 1 requires
// every state pointer on 16 bytes. Launches on `stream`; returns
// cudaGetLastError() or the error of a refused argument.
extern "C" int solver_step_em(const void* x, const void* s, const void* z,
                              const void* c0, const void* c1, const void* c2,
                              void* out, long long n, long long D, unsigned magic, int shift,
                              int grid, int threads, int vec, int evict_first, int dtype,
                              void* stream) {
  if (n <= 0 || D <= 0 || n % D != 0 || grid <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || shift < 0 || shift > 31 ||
      (magic != 0 && n >= (1LL << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const void* ptrs[] = {x, s, z, out};
    for (const void* p : ptrs)
      if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f0 = static_cast<const float*>(c0);
  const float* f1 = static_cast<const float*>(c1);
  const float* f2 = static_cast<const float*>(c2);
  if (dtype == 0)
    return launch<float>(x, s, z, f0, f1, f2, out, n, D, magic, shift, grid, threads, vec,
                         evict_first, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, s, z, f0, f1, f2, out, n, D, magic, shift, grid,
                                 threads, vec, evict_first, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
