// Fused adaptive-solver step: the arithmetic of one Algorithm-1 iteration
// after its two score evaluations, for a (B, D) state.
//
//   x~  = x - e0*x' + d1*s2 + d2*z
//   x'' = (x' + x~) / 2                        stored in the operand dtype
//   d   = max(eps_abs, eps_rel * max(|x'|, |x'_prev|))   (|x'| only if !use_prev)
//   e2  = sqrt(mean(((x' - x'') / d)^2))       per row, fp32
//
// Replaces the TPU kernels error_step (_error_kernel) and error_step_vec
// (_error_kernel_vec) of src/repro/kernels/solver_step/kernel.py. One
// kernel serves both: the tolerances are read by pointer as (B,) fp32
// arrays, and the wrapper broadcasts a scalar tolerance into such arrays,
// so a uniform vector and the scalar are the same launch.
//
// What bounds it: memory. Per element it reads five operands and writes
// one and does about 15 flops, far below the card's ratio of operations
// to bytes. At the main path's shape (B 8, D 196,608, fp32) that is
// 37.7 MB, or 11.3 us at 3.35 TB/s.
//
// What the design does about it: one pass. Each element is read once,
// upcast to fp32 in registers, and x'' is rounded once, at the store;
// no intermediate goes back to device memory. There is no padding of D:
// the last tile masks its ragged edge and the mean divides by the true D.
// The TPU kernel carries the row sum across its sequential D grid axis;
// Hopper blocks run in no order, so the sum is deterministic in two
// stages instead: grid (tiles, B) writes each tile's partial sum to a
// (B, tiles) scratch buffer, then one warp per row sums the partials in a
// fixed order. No floating-point atomics, so the same inputs give the
// same bits on every run (the chunked-equals-monolithic rule needs that).
//
// The same kernel is K4, the per-rank body of the sharded step that
// replaces sharded_error_step of src/repro/kernels/solver_step/ops.py
// (the TPU kernel under shard_map). solver_step_error_sums runs it on one
// rank's block: rows of the rank's batch shard and a contiguous column
// range of the flattened state, read in place through a row stride (the
// block of a (B, D) state is B rows of D_loc columns, D apart), and
// its finish stage writes the raw fp32 row sum of squared scaled
// residuals instead of the normalised e2. The caller all-reduces those
// sums over the ranks that split the columns and takes sqrt(sum / D):
// exact, with no sqrt -> square -> x D_loc round trip. A ragged last
// column range is masked like any ragged tile; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                   // elements per thread per tile
constexpr int kTile = kThreads * kItems;    // 2048 elements per block

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) error_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ xp, const T* __restrict__ s2,
    const T* __restrict__ z, const T* __restrict__ xv,
    const float* __restrict__ e0, const float* __restrict__ d1,
    const float* __restrict__ d2, const float* __restrict__ eps_abs,
    const float* __restrict__ eps_rel, T* __restrict__ xh,
    float* __restrict__ partial, long long D, long long ld_in, long long ld_out,
    int n_tiles, int use_prev) {
  const int tile = blockIdx.x;
  const long long row = blockIdx.y;
  const float c0 = e0[row], c1 = d1[row], c2 = d2[row];
  const float ea = eps_abs[row], er = eps_rel[row];
  const long long base = row * ld_in, out_base = row * ld_out;
  const long long begin = static_cast<long long>(tile) * kTile;

  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long col = begin + k * kThreads + threadIdx.x;
    if (col < D) {
      const long long i = base + col;
      const float vx = load(x, i), vxp = load(xp, i), vs = load(s2, i), vz = load(z, i);
      const float x_tilde = vx - c0 * vxp + c1 * vs + c2 * vz;
      const float x_high = 0.5f * (vxp + x_tilde);
      store(xh, out_base + col, x_high);
      float mag = fabsf(vxp);
      if (use_prev) mag = fmaxf(mag, fabsf(load(xv, i)));
      const float r = (vxp - x_high) / fmaxf(ea, er * mag);
      acc += r * r;
    }
  }

  // fixed-order block sum: shuffles within each warp, then warp 0 over the warps
  __shared__ float warp_sums[kThreads / 32];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[row * n_tiles + tile] = v;
  }
}

// raw = 0: e2 = sqrt(sum / D) (K1/K2); raw = 1: the sum itself (K4's partial)
__global__ void error_finish_kernel(const float* __restrict__ partial,
                                    float* __restrict__ e2, int n_tiles,
                                    long long D, int raw) {
  const long long row = blockIdx.x;
  float v = 0.f;
  for (int j = threadIdx.x; j < n_tiles; j += 32) v += partial[row * n_tiles + j];
  v = warp_sum(v);
  if (threadIdx.x == 0) e2[row] = raw ? v : sqrtf(v / static_cast<float>(D));
}

}  // namespace

extern "C" int solver_step_num_tiles(long long D) {
  return static_cast<int>((D + kTile - 1) / kTile);
}

namespace {

int launch_error(const void* x, const void* xp, const void* s2, const void* z,
                 const void* xv, const void* e0, const void* d1, const void* d2,
                 const void* eps_abs, const void* eps_rel, void* xh, void* e2,
                 void* partial, long long B, long long D, long long ld_in,
                 long long ld_out, int dtype, int use_prev, int raw, void* stream) {
  if (B <= 0 || B > 65535 || D <= 0 || ld_in < D || ld_out < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = solver_step_num_tiles(D);
  const dim3 grid(n_tiles, static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_e0 = static_cast<const float*>(e0);
  const float* f_d1 = static_cast<const float*>(d1);
  const float* f_d2 = static_cast<const float*>(d2);
  const float* f_ea = static_cast<const float*>(eps_abs);
  const float* f_er = static_cast<const float*>(eps_rel);
  float* f_part = static_cast<float*>(partial);
  if (dtype == 0) {
    error_partial_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(xp),
        static_cast<const float*>(s2), static_cast<const float*>(z),
        static_cast<const float*>(xv), f_e0, f_d1, f_d2, f_ea, f_er,
        static_cast<float*>(xh), f_part, D, ld_in, ld_out, n_tiles, use_prev);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    error_partial_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(xp),
        static_cast<const bf*>(s2), static_cast<const bf*>(z),
        static_cast<const bf*>(xv), f_e0, f_d1, f_d2, f_ea, f_er,
        static_cast<bf*>(xh), f_part, D, ld_in, ld_out, n_tiles, use_prev);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  error_finish_kernel<<<static_cast<unsigned>(B), 32, 0, s>>>(
      f_part, static_cast<float*>(e2), n_tiles, D, raw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, x', s2, z, x'_prev and x'' share it).
// Coefficients and tolerances are (B,) float32; partial is (B, num_tiles(D))
// float32 scratch. Launches on `stream`; returns cudaGetLastError().
extern "C" int solver_step_error(const void* x, const void* xp, const void* s2,
                                 const void* z, const void* xv, const void* e0,
                                 const void* d1, const void* d2,
                                 const void* eps_abs, const void* eps_rel,
                                 void* xh, void* e2, void* partial, long long B,
                                 long long D, int dtype, int use_prev,
                                 void* stream) {
  return launch_error(x, xp, s2, z, xv, e0, d1, d2, eps_abs, eps_rel, xh, e2,
                      partial, B, D, D, D, dtype, use_prev, 0, stream);
}

// K4's per-rank block: the operands are B rows of D columns, ld_in elements
// apart (all five share the stride); x'' is written B rows of D columns,
// ld_out apart; sums[row] is the raw fp32 sum of squared scaled residuals
// over the block's D columns, in the same fixed order as solver_step_error.
extern "C" int solver_step_error_sums(const void* x, const void* xp,
                                      const void* s2, const void* z,
                                      const void* xv, const void* e0,
                                      const void* d1, const void* d2,
                                      const void* eps_abs, const void* eps_rel,
                                      void* xh, void* sums, void* partial,
                                      long long B, long long D, long long ld_in,
                                      long long ld_out, int dtype, int use_prev,
                                      void* stream) {
  return launch_error(x, xp, s2, z, xv, e0, d1, d2, eps_abs, eps_rel, xh, sums,
                      partial, B, D, ld_in, ld_out, dtype, use_prev, 1, stream);
}
