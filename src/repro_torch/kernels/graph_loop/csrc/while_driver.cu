// The device-resident serve loop's driver: a CUDA graph whose WHILE node
// replays a captured sync horizon until a serving event is pending, and
// P2 (horizon_cond), the kernel that decides, after every horizon,
// whether the loop goes on.
//
// No TPU kernel: this is the counterpart of the lax.while_loop of
// solve_horizons and its condition events_pending in
// src/repro/core/solvers/adaptive.py, which XLA compiles into one device
// program. PyTorch exposes only IF-node capture, so the WHILE node is
// built here on the CUDA runtime's graph API (conditional nodes: CUDA
// 12.3 or later in both the toolkit and the driver).
//
// The parent graph, launched once a driver window on the caller's stream:
//   1. horizon_cond(first = 1): n = 0; computes the predicate on the carry
//      as it stands and sets the WHILE handle;
//   2. a WHILE conditional node whose body is
//        a. the horizon: the graph PyTorch captured (a child graph node),
//           sync_horizon Algorithm-1 iterations over the server's static
//           carry buffers, and
//        b. horizon_cond(first = 0): n += 1, the predicate again.
// The predicate is running && !event && n < max_horizons, with
//   running = any(occupied & !done),
//   event   = any(occupied & done)                (compaction), or
//             any(occupied) && !running           (wait_all: the
//                                                  monolithic wave),
// exactly events_pending and the loop condition of the reference. P2
// writes state = [event, n] on every evaluation, so after the launch the
// host reads the flag of the carry at exit, and the horizons run, in one
// 8-byte read: the window's only device-to-host transfer.
//
// What bounds P2: the launch. It reads 2*B bytes (16 at 8 slots) and does
// 3*B comparisons in one block: __syncthreads_or reduces the three flags.
// It exists so that the host reads nothing between horizons.

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
    int* __restrict__ state, int wait_all, int max_horizons, int first, int set) {
  int occ = 0, running = 0, occ_done = 0;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const bool o = occupied[i], d = done[i];
    occ |= o;
    running |= o && !d;
    occ_done |= o && d;
  }
  occ = __syncthreads_or(occ);
  running = __syncthreads_or(running);
  occ_done = __syncthreads_or(occ_done);
  if (threadIdx.x != 0) return;
  const int n = first ? 0 : state[1] + 1;
  const int event = wait_all ? (occ && !running) : occ_done;
  state[0] = event;
  state[1] = n;
#if CUDART_VERSION >= 12030
  if (set) cudaGraphSetConditional(handle, running && !event && n < max_horizons ? 1u : 0u);
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

// Builds and instantiates the parent graph around `horizon` (a cudaGraph_t,
// which is cloned into the body). occupied and done: (B,) bool on the
// device; state: 2 int32 on the device; all three must outlive the driver.
// Returns 0 and the driver in *out, or the CUDA error (cudaErrorNotSupported
// where the toolkit is older than 12.3).
extern "C" int graph_loop_build(void* horizon, const void* occupied, const void* done, int B,
                                void* state, int wait_all, int max_horizons, void** out) {
#if CUDART_VERSION >= 12030
  if (B <= 0 || max_horizons <= 0 || horizon == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = nullptr;
  CHECK(cudaGraphCreate(&g, 0));
  Handle h;
  CHECK(cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault));
  const bool* occ = static_cast<const bool*>(occupied);
  const bool* dn = static_cast<const bool*>(done);
  int* st = static_cast<int*>(state);
  int first = 1, set = 1;
  void* args[] = {&h, &occ, &dn, &B, &st, &wait_all, &max_horizons, &first, &set};
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
  CHECK(cudaGraphAddChildGraphNode(&child, body, nullptr, 0, static_cast<cudaGraph_t>(horizon)));
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

// P2 alone, outside any graph (it sets no handle): the flag and n of
// hand-built masks, and its time. first = 1 sets n = 0, else n += 1.
extern "C" int graph_loop_cond(const void* occupied, const void* done, int B, void* state,
                               int wait_all, int max_horizons, int first, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  horizon_cond<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Handle{}, static_cast<const bool*>(occupied), static_cast<const bool*>(done), B,
      static_cast<int*>(state), wait_all, max_horizons, first, 0);
  return static_cast<int>(cudaGetLastError());
}
