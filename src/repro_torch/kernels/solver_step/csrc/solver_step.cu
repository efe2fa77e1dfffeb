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
// What bounds it: memory, and at the planning shape the launch. Per
// element it reads five operands and writes one and does about 17 flops,
// far below the card's ratio of operations to bytes. At the DiT's shape
// (B 8, D 196,608, fp32) that is 37.7 MB, or 11.3 us at 3.35 TB/s; at
// planning's (64, 736) 1.1 MB, 0.34 us, well under one launch.
//
// What the design does about it: one pass and one launch a call. Each
// element is read once, widened to fp32 in registers, and x'' is rounded
// once, at the store; no intermediate goes back to device memory. A row
// is cut into tiles of kTile columns, one block a (tile, row); a thread
// takes kItems runs of kVec consecutive columns, and reads each run as
// one 16-byte (fp32) or 8-byte (bf16) load where the wrapper has found
// every row of every operand aligned for it (`vec`), else as kVec
// scalar loads. The arithmetic and the order of the sums are the same
// either way. There is no padding of D: a tile's ragged end is masked
// and the mean divides by the true D. Loads are evict-first, since no
// operand is read twice. At the DiT's shape the 512 blocks (64 tiles x
// 8 rows) fit the card's slots at 4 blocks an SM in one wave. Of the
// tilings tried on an H100 (2048 columns at 5, 6 or 8 blocks an SM,
// 4096 at 3, 512 and 128 threads a block), with and without evict-first
// loads, this was the fastest.
//
// The row sum, without a second launch. The TPU kernel carries it across
// its sequential D grid axis; Hopper blocks run in no order. A row that
// fits one tile (planning's 736 columns) is summed by its block, which
// writes e2 directly. A row of many tiles (the DiT's 64) is summed by
// the last of its blocks to finish: each block writes its tile's sum to
// a (B, tiles) scratch, makes it visible (__threadfence), and takes a
// ticket from the row's counter with an integer atomicAdd; the block
// that draws the last ticket adds the row's tile sums in tile order,
// writes e2 and sets the counter back to 0. The counters are a
// zero-initialised __device__ array of the library, one per row index:
// it needs no memset a call, so CUDA-graph capture and replay see one
// kernel, and every launch leaves it at 0. Calls on one device must not
// run concurrently on two streams, since they would share counters (the
// port issues its solver steps on one stream). This was chosen over a
// thread-block cluster a row (at most 16 blocks: 8 rows would fill 128
// of the 132 SMs with tiles of 12,288 columns, and a row of more than 16
// tiles still needs a pass over partials) and over keeping two kernels
// (a second launch costs more than the 64-float pass it runs).
//
// Determinism: within a tile, each thread sums its columns in a fixed
// order, warps reduce with shuffles and warp 0 sums the warp sums; across
// tiles, lane j of the last block's warp 0 adds tiles j, j + 32, ... and
// the warp reduces with shuffles. The tiling depends on D alone, so a
// row's bits do not depend on B, the grid, the row's neighbours, the
// load width or which block finishes last; there are no floating-point
// atomics. The same inputs give the same bits on every run, and a batch
// half gives its rows' bits (the chunked-equals-monolithic rule and the
// sharded step rely on that).
//
// The same kernel is K4, the per-rank body of the sharded step that
// replaces sharded_error_step of src/repro/kernels/solver_step/ops.py
// (the TPU kernel under shard_map). solver_step_error_sums runs it on one
// rank's block: rows of the rank's batch shard and a contiguous column
// range of the flattened state, read in place through a row stride (the
// block of a (B, D) state is B rows of D_loc columns, D apart), and it
// writes the raw fp32 row sum of squared scaled residuals instead of the
// normalised e2. The caller all-reduces those sums over the ranks that
// split the columns and takes sqrt(sum / D): exact, with no sqrt ->
// square -> x D_loc round trip. A column range may start anywhere, so its
// rows are often off 16 bytes: the wrapper then asks for scalar loads.
// x'' is the same arithmetic per element, so K4's x'' equals K1's columns
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                          // consecutive columns a run
constexpr int kItems = 3;                        // runs a thread a tile
constexpr int kTile = kThreads * kItems * kVec;  // 3072 columns a block
constexpr int kMaxRows = 65535;                  // gridDim.y: rows a launch

// One ticket counter a row of a launch, zero when the library loads; each
// multi-tile launch returns the counters it used to 0. A batch of more
// than kMaxRows rows is launched by the wrapper in ranges of rows
// (solver_step/ops.py kernel_config), each on its rows' slices of the
// operands; consecutive launches on one stream reuse the counters, which
// the one before has set back to 0.
__device__ unsigned int g_row_tickets[kMaxRows];

// Every operand element is read once: loads are evict-first (ld.global.cs)
__device__ __forceinline__ float load(const float* p, long long i) { return __ldcs(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ldcs(p + i));
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// kVec consecutive elements as one 16-byte (fp32) or 8-byte (bf16) access
__device__ __forceinline__ void load4(const float* p, long long i, float (&v)[kVec]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p + i));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i, float (&v)[kVec]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p + i));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, long long i, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, const float (&v)[kVec]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p + i) = q;
}

// the run of kVec columns at p + i, `left` of them inside the row
template <typename T>
__device__ __forceinline__ void load_run(const T* p, long long i, long long left, int vec,
                                         float (&v)[kVec]) {
  if (vec) {
    load4(p, i, v);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = e < left ? load(p, i + e) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) error_step_kernel(
    const T* __restrict__ x, const T* __restrict__ xp, const T* __restrict__ s2,
    const T* __restrict__ z, const T* __restrict__ xv,
    const float* __restrict__ e0, const float* __restrict__ d1,
    const float* __restrict__ d2, const float* __restrict__ eps_abs,
    const float* __restrict__ eps_rel, T* __restrict__ xh,
    float* __restrict__ partial, float* __restrict__ e2, long long D,
    long long ld_in, long long ld_out, int n_tiles, int use_prev, int vec, int raw) {
  const int tile = blockIdx.x;
  const int row = blockIdx.y;
  const float c0 = e0[row], c1 = d1[row], c2 = d2[row];
  const float ea = eps_abs[row], er = eps_rel[row];
  const long long base = row * ld_in, out_base = row * ld_out;
  const long long begin = static_cast<long long>(tile) * kTile;

  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long col = begin + (static_cast<long long>(k) * kThreads + threadIdx.x) * kVec;
    const long long left = D - col;
    if (left <= 0) continue;
    const long long i = base + col;
    float vx[kVec], vxp[kVec], vs[kVec], vz[kVec], vv[kVec], hi[kVec];
    load_run(x, i, left, vec, vx);
    load_run(xp, i, left, vec, vxp);
    load_run(s2, i, left, vec, vs);
    load_run(z, i, left, vec, vz);
    if (use_prev) load_run(xv, i, left, vec, vv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      // x~ as three fused multiply-adds, x - e0*x' first (ref.py emulates them)
      const float x_tilde = fmaf(c2, vz[e], fmaf(c1, vs[e], fmaf(-c0, vxp[e], vx[e])));
      hi[e] = 0.5f * (vxp[e] + x_tilde);
      float mag = fabsf(vxp[e]);
      if (use_prev) mag = fmaxf(mag, fabsf(vv[e]));
      const float r = (vxp[e] - hi[e]) / fmaxf(ea, er * mag);
      if (e < left) acc = fmaf(r, r, acc);
    }
    if (vec) {
      store4(xh, out_base + col, hi);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (e < left) store(xh, out_base + col + e, hi[e]);
    }
  }

  // the tile's sum: shuffles within each warp, then warp 0 over the warps
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  float sum = warp_sum(lane < kThreads / 32 ? warp_sums[lane] : 0.f);
  if (n_tiles > 1) {
    // the row's last block to finish adds the tile sums, in tile order
    unsigned ticket = 0;
    if (lane == 0) {
      partial[static_cast<long long>(row) * n_tiles + tile] = sum;
      __threadfence();
      ticket = atomicAdd(&g_row_tickets[row], 1u);
    }
    ticket = __shfl_sync(0xffffffffu, ticket, 0);
    if (ticket != static_cast<unsigned>(n_tiles - 1)) return;
    __threadfence();
    sum = 0.f;
    for (int j = lane; j < n_tiles; j += 32)
      sum += __ldcg(partial + static_cast<long long>(row) * n_tiles + j);
    sum = warp_sum(sum);
    if (lane == 0) g_row_tickets[row] = 0;
  }
  if (lane == 0) e2[row] = raw ? sum : sqrtf(sum / static_cast<float>(D));
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int launch_error(const void* x, const void* xp, const void* s2, const void* z,
                 const void* xv, const void* e0, const void* d1, const void* d2,
                 const void* eps_abs, const void* eps_rel, void* xh, void* e2,
                 void* partial, long long B, long long D, long long ld_in,
                 long long ld_out, int dtype, int use_prev, int vec, int raw,
                 void* stream) {
  if (B <= 0 || B > kMaxRows || D <= 0 || ld_in < D || ld_out < D || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (D + kTile - 1) / kTile;
  if (n_tiles > 2147483647LL || (n_tiles > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    // every row of every operand starts on a run of kVec elements
    const uintptr_t bytes = kVec * (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
    const void* ptrs[] = {x, xp, s2, z, xv, xh};
    for (const void* p : ptrs)
      if (!aligned(p, bytes)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D % kVec || ld_in % kVec || ld_out % kVec)
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_e0 = static_cast<const float*>(e0);
  const float* f_d1 = static_cast<const float*>(d1);
  const float* f_d2 = static_cast<const float*>(d2);
  const float* f_ea = static_cast<const float*>(eps_abs);
  const float* f_er = static_cast<const float*>(eps_rel);
  float* f_part = static_cast<float*>(partial);
  float* f_e2 = static_cast<float*>(e2);
  const int tiles = static_cast<int>(n_tiles);
  if (dtype == 0) {
    error_step_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(xp),
        static_cast<const float*>(s2), static_cast<const float*>(z),
        static_cast<const float*>(xv), f_e0, f_d1, f_d2, f_ea, f_er,
        static_cast<float*>(xh), f_part, f_e2, D, ld_in, ld_out, tiles, use_prev, vec, raw);
  } else {
    using bf = __nv_bfloat16;
    error_step_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(xp),
        static_cast<const bf*>(s2), static_cast<const bf*>(z),
        static_cast<const bf*>(xv), f_e0, f_d1, f_d2, f_ea, f_er,
        static_cast<bf*>(xh), f_part, f_e2, D, ld_in, ld_out, tiles, use_prev, vec, raw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, x', s2, z, x'_prev and x'' share it).
// Coefficients and tolerances are (B,) float32; partial is (B, tiles)
// float32 scratch with tiles = ceil(D / 3072), needed (non-null) only when
// tiles > 1. `vec` asks for kVec-element loads and stores (the wrapper's
// choice; refused with cudaErrorMisalignedAddress where a row is not
// aligned for them). Launches one kernel on `stream`; returns
// cudaGetLastError().
extern "C" int solver_step_error(const void* x, const void* xp, const void* s2,
                                 const void* z, const void* xv, const void* e0,
                                 const void* d1, const void* d2,
                                 const void* eps_abs, const void* eps_rel,
                                 void* xh, void* e2, void* partial, long long B,
                                 long long D, int dtype, int use_prev, int vec,
                                 void* stream) {
  return launch_error(x, xp, s2, z, xv, e0, d1, d2, eps_abs, eps_rel, xh, e2,
                      partial, B, D, D, D, dtype, use_prev, vec, 0, stream);
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
                                      int vec, void* stream) {
  return launch_error(x, xp, s2, z, xv, e0, d1, d2, eps_abs, eps_rel, xh, sums,
                      partial, B, D, ld_in, ld_out, dtype, use_prev, vec, 1, stream);
}
