// Fused GroupNorm -> SiLU over (B, H, C) activations:
//
//   g     = groups (the wrapper has clamped it to min(groups, C))
//   slab  = x[b, :, j*C/g : (j+1)*C/g]          one (sample, group) pair
//   mu    = mean(slab),  var = mean((slab - mu)^2)       fp32, two passes
//   y     = (x - mu) * rsqrt(var + eps) * scale[c] + bias[c]   fp32
//   out   = y * sigmoid(y)                      rounded once to x's dtype
//
// Replaces the TPU kernel groupnorm_silu (_gn_silu_kernel) of
// src/repro/kernels/groupnorm_silu/kernel.py. That kernel holds a block
// of samples in VMEM and folds the C lanes into groups with a one-hot
// membership matmul on the MXU, since lane reshapes are not native to a
// TPU. Here each (sample, group) slab is reduced over its channels
// directly; no membership matrix exists.
//
// What bounds it: at the temporal UNet's sizes, the launch and one trip
// to memory. Per element it reads x once and writes out once and does
// about 11 flops, far below the card's ratio of operations to bytes, and
// a launch moves 0.5-2 MB (0.15-0.6 us at 3.35 TB/s), so the time is the
// launch plus the latency of one load, two reductions and one store.
//
// What the design does about it: two hand-written kernels, chosen before
// the launch by the wrapper (kernel_config in ops.py) from the shape and
// the operands' alignment.
//
// - gn_silu_regs, the register path. Every TRAJ_UNET slab holds 64-256
//   elements, so a team of `team` lanes (a power of two up to a warp,
//   about n/4 of them) holds one slab in registers, `vecs` 4-element
//   vectors a lane: 16-byte loads in fp32, 8-byte in bf16. The mean and
//   then the mean of squared deviations come from those registers (two
//   passes: no E[x^2] - mu^2, which a 1e3 offset would cancel), each
//   reduced by an xor butterfly of __shfl_xor_sync inside the team. No
//   shared memory and no __syncthreads. A block of up to 128 threads
//   (the wrapper's choice; the fastest of 64, 128 and 256 tried on an
//   H100) holds threads/team teams on consecutive slabs, i.e. adjacent
//   groups of one sample, so its warps read adjacent column ranges of the
//   same rows and use whole the 32-byte sectors they touch (a group of 4
//   channels is 16 bytes of a row). A lane loads its scale and bias
//   vectors with x, once
//   where all its vectors share their channels. It takes slabs of up to
//   kRegSlab elements where g and C/(4g) are powers of two (all index
//   arithmetic is shifts and masks: integer division by the runtime
//   group and vector counts was measurably slower), with 16-byte-aligned
//   scale and bias and an x and out aligned to their vector.
// - gn_silu_block, the general path for everything else (slabs up to
//   the wrapper's MAX_SLAB, C/g not a multiple of 4, an unaligned base):
//   one block of 256 threads a slab, staged in shared memory as fp32 on
//   the first pass and reduced across warps through shared memory.
//
// Determinism: a lane (register path) or a thread (general path) sums
// its elements in a fixed order, the butterfly or the warp tree adds in a
// fixed order, and every lane of a butterfly ends with the same bits. No
// atomics, so the same inputs give the same bits on every run; the
// solver's accept decisions downstream depend on that. The order depends
// on the shape alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // general path: threads a slab
constexpr int kWarps = kThreads / 32;
constexpr int kRegSlab = 1024;         // register path: largest slab
constexpr int kMaxVecs = kRegSlab / 4 / 32;  // vectors a lane at most

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// four consecutive elements at p + i: one 16-byte (fp32) or 8-byte (bf16) access
__device__ __forceinline__ void load4(const float* p, long long i, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p + i);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, long long i, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p + i) = q;
}

// y * sigmoid(y) with the hardware exponential and division (__expf:
// 2 + 1.17|y| ulps; __fdividef: 2 ulps). The error is at most about
// 2 ulps of y plus 2e-7 (1.2e-6 at |y| = 5), inside the kernel's 1e-5
// bound for |y| below 40; a y below -87 gives -0 where silu(y) is below
// 1e-36. The IEEE expf and division were slower by a tenth of the
// kernel's time at the temporal UNet's shapes on an H100.
__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// Sum over the `team` lanes (a power of two) that share v's team; every
// lane of the team gets the same bits (each step adds the same two values).
__device__ __forceinline__ float team_sum(float v, int team) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < team) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Register path. A lane of a team holds the slab's vectors q = lane,
// lane + team, ... (row h = q / cv, channels 4 (q % cv) + 0..3 of the
// group, with cv = C/g/4 vectors a row); VECS bounds the count. team, g
// and cv are powers of two, passed as their logarithms; inv_n = 1/(H C/g)
// comes from the host. Offsets within a sample fit an int (H C < 2^31).
template <typename T, int VECS>
__global__ void __launch_bounds__(kThreads) gn_silu_regs(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int slabs, int H,
    int C, int team_log, int group_log, int cv_log, float eps, float inv_n) {
  const int team = 1 << team_log, cv = 1 << cv_log, cg = 4 << cv_log;
  const int lane = threadIdx.x & (team - 1);
  const int slab = (blockIdx.x * blockDim.x + threadIdx.x) >> team_log;
  const bool live = slab < slabs;  // a dead team still joins the shuffles
  const int sample = slab >> group_log, group = slab & ((1 << group_log) - 1);
  const int nvec = H << cv_log;
  const long long base = static_cast<long long>(sample) * H * C + group * cg;
  const T* xs = x + base;
  T* os = out + base;
  // team >= cv: every vector of a lane covers the same four channels
  const bool same_channels = team_log >= cv_log;

  int at[VECS];
  bool has[VECS];
  float v[VECS][4];
  float4 sc[VECS], bi[VECS];  // loaded with x, ahead of the reductions
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int q = lane + (k << team_log);
    const int ch = group * cg + 4 * (q & (cv - 1));
    has[k] = live && q < nvec;  // has[k] implies has[0]
    at[k] = (q >> cv_log) * C + 4 * (q & (cv - 1));
    if (has[k]) {
      load4(xs, at[k], v[k]);
      if (k == 0 || !same_channels) {
        sc[k] = *reinterpret_cast<const float4*>(scale + ch);
        bi[k] = *reinterpret_cast<const float4*>(bias + ch);
      } else {
        sc[k] = sc[0], bi[k] = bi[0];
      }
      acc += (v[k][0] + v[k][1]) + (v[k][2] + v[k][3]);
    }
  }
  const float mu = team_sum(acc, team) * inv_n;
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if (has[k]) {
      const float d0 = v[k][0] - mu, d1 = v[k][1] - mu, d2 = v[k][2] - mu, d3 = v[k][3] - mu;
      acc += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  }
  const float rstd = rsqrtf(team_sum(acc, team) * inv_n + eps);
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if (has[k]) {
      const float4 s = sc[k], b = bi[k];
      float y[4] = {(v[k][0] - mu) * rstd * s.x + b.x, (v[k][1] - mu) * rstd * s.y + b.y,
                    (v[k][2] - mu) * rstd * s.z + b.z, (v[k][3] - mu) * rstd * s.w + b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = silu(y[e]);
      store4(os, at[k], y);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order block sum, returned to every thread. `red` holds kWarps + 1
// floats; the trailing __syncthreads lets the next call reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < kWarps ? red[lane] : 0.f;
    r = warp_sum(r);
    if (lane == 0) red[kWarps] = r;
  }
  __syncthreads();
  const float total = red[kWarps];
  __syncthreads();
  return total;
}

// General path: one block a slab, staged in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_silu_block(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int H, int C,
    int groups, float eps) {
  extern __shared__ float slab[];
  __shared__ float red[kWarps + 1];
  const long long sample = blockIdx.x / groups;
  const int group = blockIdx.x % groups;
  const int cg = C / groups;
  const int n = H * cg;
  const long long base = sample * H * C + static_cast<long long>(group) * cg;
  const float inv_n = 1.f / static_cast<float>(n);

  // pass 1: stage the slab, sum it
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int h = i / cg, c = i - h * cg;
    const float v = load(x, base + static_cast<long long>(h) * C + c);
    slab[i] = v;
    acc += v;
  }
  const float mu = block_sum(acc, red) * inv_n;

  // pass 2: mean of squared deviations (no E[x^2] - mu^2 cancellation)
  acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = slab[i] - mu;
    acc += d * d;
  }
  const float rstd = rsqrtf(block_sum(acc, red) * inv_n + eps);

  // pass 3: normalise, affine, SiLU, one rounding at the store
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int h = i / cg, c = i - h * cg;
    const int ch = group * cg + c;
    const float y = (slab[i] - mu) * rstd * scale[ch] + bias[ch];
    store(out, base + static_cast<long long>(h) * C + c, silu(y));
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int log2_exact(int v) {  // log2 of a power of two, else -1
  if (v <= 0 || (v & (v - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename T, int VECS>
void launch_regs(const void* x, const float* scale, const float* bias, void* out,
                 int slabs, int H, int C, int team, int groups, int cv, int threads,
                 float eps, cudaStream_t s) {
  const int per_block = threads / team;
  const unsigned grid = static_cast<unsigned>((slabs + per_block - 1) / per_block);
  gn_silu_regs<T, VECS><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), slabs, H, C,
      log2_exact(team), log2_exact(groups), log2_exact(cv), eps,
      1.f / static_cast<float>(H * (C / groups)));
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* out,
           long long B, int H, int C, int groups, float eps, int path, int team,
           int vecs, int threads, cudaStream_t s) {
  const int cg = C / groups;
  if (B * groups > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = static_cast<int>(B * groups);
  if (path == 0) {
    const size_t smem = static_cast<size_t>(H) * cg * sizeof(float);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    gn_silu_block<T><<<static_cast<unsigned>(slabs), kThreads, smem, s>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(out), H, C, groups, eps);
    return static_cast<int>(cudaGetLastError());
  }
  // register path: the launch shape the wrapper chose, checked here
  const int cv = cg / 4;
  const bool shape_ok = team <= 32 && log2_exact(team) >= 0 && log2_exact(groups) >= 0 &&
                        cg % 4 == 0 && log2_exact(cv) >= 0;
  if (path != 1 || !shape_ok || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || static_cast<long long>(team) * vecs * 4 < static_cast<long long>(H) * cg ||
      H * cg > kRegSlab || static_cast<long long>(H) * C > 2147483647LL ||
      static_cast<long long>(slabs) * team > 2147483647LL - threads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(x, 4 * sizeof(T)) || !aligned(out, 4 * sizeof(T)) || !aligned(scale, 16) ||
      !aligned(bias, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (vecs) {
    case 1: launch_regs<T, 1>(x, scale, bias, out, slabs, H, C, team, groups, cv, threads, eps, s); break;
    case 2: launch_regs<T, 2>(x, scale, bias, out, slabs, H, C, team, groups, cv, threads, eps, s); break;
    case 4: launch_regs<T, 4>(x, scale, bias, out, slabs, H, C, team, groups, cv, threads, eps, s); break;
    case kMaxVecs: launch_regs<T, kMaxVecs>(x, scale, bias, out, slabs, H, C, team, groups, cv, threads, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, H, C) contiguous, dtype 0 = float32, 1 = bfloat16; scale,
// bias: (C,) float32. `groups` divides C. `path` 0 runs the general
// kernel (one block of 256 threads a slab; team, vecs and threads are
// ignored); 1 the register kernel with teams of `team` lanes holding
// `vecs` 4-element vectors each, `threads` threads a block: the launch
// shape of ops.kernel_config. Launches on `stream`; returns
// cudaGetLastError(), or an error code without launching when the
// arguments do not fit the chosen path.
extern "C" int groupnorm_silu_fwd(const void* x, const void* scale,
                                  const void* bias, void* out, long long B,
                                  int H, int C, int groups, float eps,
                                  int dtype, int path, int team, int vecs,
                                  int threads, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || groups <= 0 || C % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_scale = static_cast<const float*>(scale);
  const float* f_bias = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch<float>(x, f_scale, f_bias, out, B, H, C, groups, eps, path, team,
                         vecs, threads, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f_scale, f_bias, out, B, H, C, groups, eps, path,
                                 team, vecs, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
