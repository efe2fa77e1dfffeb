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
// TPU. Here one block owns one (sample, group) slab and sums over its
// channels directly; no membership matrix exists.
//
// What bounds it: memory, and at the temporal UNet's sizes the launch.
// Per element it reads x once and writes out once and does about 15
// flops, far below the card's ratio of operations to bytes. A TRAJ_UNET
// forward at 128 rows moves about 18.9 MB through its 17 launches
// (5.6 us at 3.35 TB/s), far less than 17 launch latencies.
//
// What the design does about it: one HBM read and one HBM write. The
// block stages its slab in shared memory as fp32 on the first pass (the
// mean), and the second pass (squared deviations) and the third (the
// normalised, affine, SiLU store) read it from there. Every slab of the
// temporal UNet holds 128 to 256 elements; the wrapper refuses a slab
// above 48 KB of fp32.
//
// Determinism: each thread sums its elements in a fixed order, warps
// reduce with shuffles, and warp 0 sums the warp partials. No atomics,
// so the same inputs give the same bits on every run; the solver's
// accept decisions downstream depend on that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) gn_silu_kernel(
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
    store(out, base + static_cast<long long>(h) * C + c, y / (1.f + expf(-y)));
  }
}

}  // namespace

// x, out: (B, H, C) contiguous, dtype 0 = float32, 1 = bfloat16; scale,
// bias: (C,) float32. `groups` divides C. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int groupnorm_silu_fwd(const void* x, const void* scale,
                                  const void* bias, void* out, long long B,
                                  int H, int C, int groups, float eps,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || groups <= 0 || C % groups != 0 ||
      B * groups > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(H) * (C / groups) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(B * groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_scale = static_cast<const float*>(scale);
  const float* f_bias = static_cast<const float*>(bias);
  if (dtype == 0) {
    gn_silu_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), f_scale, f_bias, static_cast<float*>(out),
        H, C, groups, eps);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    gn_silu_kernel<bf><<<grid, kThreads, smem, s>>>(
        static_cast<const bf*>(x), f_scale, f_bias, static_cast<bf*>(out), H, C,
        groups, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
