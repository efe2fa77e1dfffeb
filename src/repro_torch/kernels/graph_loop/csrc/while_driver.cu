// The WHILE-node driver of every graphed loop (the device-resident serve,
// the graphed solves) and P2 (horizon_cond), the kernel that decides,
// after every unit of the loop, whether the next unit runs.
//
// No TPU kernel: this is the counterpart of two nested lax.while_loop
// conditions of the reference (src/repro/core/solvers/adaptive.py), which
// XLA compiles into one device program: solve_chunk's, checked after
// every iteration, and solve_horizons', checked after every chunk of at
// most `horizon` iterations. PyTorch exposes only IF-node capture, so the
// WHILE node is built here on the CUDA runtime's graph API (conditional
// nodes: CUDA 12.3 or later in both the toolkit and the driver).
//
// The parent graph, launched once a driver window on the caller's stream:
//   1. horizon_cond(first = 1): n = u = units = 0; evaluates the outer
//      condition, then the inner one, on the carry as it stands, and sets
//      the WHILE handle;
//   2. a WHILE conditional node whose body is
//        a. the unit: the graph PyTorch captured (a child graph node) over
//           the caller's static carry buffers: one Algorithm-1 iteration,
//           one RK45 attempt, one Algorithm-2 or grid step (under a mesh
//           the masked group that ends in the mesh's all-reduce), and
//        b. horizon_cond(first = 0): u += 1, units += 1, the conditions.
// The inner condition (solve_chunk's) holds while
//   live   = any(!done)        (the reference's any(t > t_eps + 1e-12): the
//                               carry's done leaf is t <= t_eps + 1e-12 on
//                               every row, idle slots included),
//   u < horizon and *iterations < max_iters   (the carry's device counter).
// While it holds the next unit runs. When it fails the horizon is over:
// n += 1, u = 0, and the outer condition (solve_horizons') decides,
//   running && !event && n < max_horizons, with
//   running = any(occupied & !done),
//   event   = any(occupied & done)                (compaction), or
//             any(occupied) && !running           (wait_all: the
//                                                  monolithic wave),
// exactly events_pending and the outer loop condition of the reference.
// If it holds but the inner condition fails at the new horizon's start
// (the iteration budget is spent), every later horizon runs no unit and
// changes nothing, so the reference's loop runs empty horizons up to
// max_horizons: P2 sets n = max_horizons and stops. P2 writes
// state = [event, n, u, units] on every evaluation, so after the launch
// the host reads the flag of the carry at exit, the horizons run and the
// units run in one 16-byte read: the window's only device-to-host
// transfer (u is 0 at exit, which only a horizon's end allows).
//
// What bounds P2: the launch. It reads 2*B + 4 bytes (20 at 8 slots) and
// does 4*B comparisons in one block: __syncthreads_or reduces the four
// flags. It exists so that the host reads nothing between units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

#if CUDART_VERSION >= 12030
using Handle = cudaGraphConditionalHandle;
#else
using Handle = unsigned long long;
#endif

__global__ void __launch_bounds__(kThreads) horizon_cond(
    Handle handle, const bool* __restrict__ occupied, const bool* __restrict__ done, int B,
    const int* __restrict__ iterations, int* __restrict__ state, int wait_all, int horizon,
    int max_iters, int max_horizons, int first, int set) {
  int occ = 0, running = 0, occ_done = 0, live = 0;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const bool o = occupied[i], d = done[i];
    occ |= o;
    running |= o && !d;
    occ_done |= o && d;
    live |= !d;
  }
  occ = __syncthreads_or(occ);
  running = __syncthreads_or(running);
  occ_done = __syncthreads_or(occ_done);
  live = __syncthreads_or(live);
  if (threadIdx.x != 0) return;
  const int event = wait_all ? (occ && !running) : occ_done;
  const bool inner = live && *iterations < max_iters;
  int n = first ? 0 : state[1];
  int u = first ? 0 : state[2] + 1;
  const int units = first ? 0 : state[3] + 1;
  int go = !first && inner && u < horizon;
  if (!go) {  // the horizon is over (first: none has begun)
    n += !first;
    u = 0;
    go = running && !event && n < max_horizons;
    if (go && !(inner && horizon > 0)) {  // every later horizon would be empty
      n = max_horizons;
      go = 0;
    }
  }
  state[0] = event;
  state[1] = n;
  state[2] = u;
  state[3] = units;
#if CUDART_VERSION >= 12030
  if (set) cudaGraphSetConditional(handle, go ? 1u : 0u);
#endif
}

struct Driver {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

#define CHECK(call)                                              \
  do {                                                           \
    const cudaError_t err_ = (call);                             \
    if (err_ != cudaSuccess) return static_cast<int>(err_);      \
  } while (0)

}  // namespace

// The CUDA runtime this library was built with and the driver's, as
// cudaRuntimeGetVersion and cudaDriverGetVersion give them (12030 = 12.3).
extern "C" int graph_loop_versions(int* runtime, int* driver) {
  CHECK(cudaRuntimeGetVersion(runtime));
  CHECK(cudaDriverGetVersion(driver));
  return 0;
}

// Builds and instantiates the parent graph around `unit` (a cudaGraph_t,
// which is cloned into the body). occupied and done: (B,) bool on the
// device; iterations: 1 int32 on the device (the carry's counter); state:
// 4 int32 on the device; all four must outlive the driver. Returns 0 and
// the driver in *out, or the CUDA error (cudaErrorNotSupported where the
// toolkit is older than 12.3).
extern "C" int graph_loop_build(void* unit, const void* occupied, const void* done, int B,
                                const void* iterations, void* state, int wait_all, int horizon,
                                int max_iters, int max_horizons, void** out) {
#if CUDART_VERSION >= 12030
  if (B <= 0 || max_horizons <= 0 || horizon <= 0 || unit == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = nullptr;
  CHECK(cudaGraphCreate(&g, 0));
  Handle h;
  CHECK(cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault));
  const bool* occ = static_cast<const bool*>(occupied);
  const bool* dn = static_cast<const bool*>(done);
  const int* it = static_cast<const int*>(iterations);
  int* st = static_cast<int*>(state);
  int first = 1, set = 1;
  void* args[] = {&h,       &occ,     &dn,        &B,            &it,    &st,
                  &wait_all, &horizon, &max_iters, &max_horizons, &first, &set};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(horizon_cond);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(kThreads);
  kp.kernelParams = args;  // the values are copied into the node
  cudaGraphNode_t init, loop, child, cond;
  CHECK(cudaGraphAddKernelNode(&init, g, nullptr, 0, &kp));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  CHECK(cudaGraphAddNode(&loop, g, &init, nullptr, 1, &cp));
#else
  CHECK(cudaGraphAddNode(&loop, g, &init, 1, &cp));
#endif
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  CHECK(cudaGraphAddChildGraphNode(&child, body, nullptr, 0, static_cast<cudaGraph_t>(unit)));
  first = 0;
  CHECK(cudaGraphAddKernelNode(&cond, body, &child, 1, &kp));
  Driver* d = new Driver{g, nullptr};
  const cudaError_t err = cudaGraphInstantiate(&d->exec, g, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    delete d;
    return static_cast<int>(err);
  }
  *out = d;
  return 0;
#else
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// One driver window on `stream`.
extern "C" int graph_loop_launch(void* driver, void* stream) {
  const Driver* d = static_cast<const Driver*>(driver);
  CHECK(cudaGraphLaunch(d->exec, static_cast<cudaStream_t>(stream)));
  return 0;
}

extern "C" int graph_loop_destroy(void* driver) {
  Driver* d = static_cast<Driver*>(driver);
  if (d->exec) CHECK(cudaGraphExecDestroy(d->exec));
  CHECK(cudaGraphDestroy(d->graph));
  delete d;
  return 0;
}

// P2 alone, outside any graph (it sets no handle): the state it writes
// after a unit (first = 0) or before the first (first = 1) on hand-built
// masks, and its time.
extern "C" int graph_loop_cond(const void* occupied, const void* done, int B,
                               const void* iterations, void* state, int wait_all, int horizon,
                               int max_iters, int max_horizons, int first, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  horizon_cond<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Handle{}, static_cast<const bool*>(occupied), static_cast<const bool*>(done), B,
      static_cast<const int*>(iterations), static_cast<int*>(state), wait_all, horizon,
      max_iters, max_horizons, first, 0);
  return static_cast<int>(cudaGetLastError());
}
