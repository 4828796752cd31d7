// What the persistent bf16 recurrence kernels of lstm_fwd.cu and
// lstm_bwd.cu share: the route predicates, the layout of a block's resident
// weight slice, the cluster barrier, the handoff between the clusters of
// the stack's layer wavefront, and the cluster launch.
//
// A cluster is what makes the recurrence one launch: its blocks are
// scheduled together (the launch fails if they cannot be), and its
// hardware barrier (barrier.cluster, release / acquire) replaces the launch
// boundary between steps.  The blocks trade h (forward) and the dh partials
// (backward) through a small scratch buffer in L2 that the barrier orders:
// pushing the same bytes into the peers' shared memory (st.shared::cluster)
// was slower in both kernels at H=512.
//
// A row tile of kRows batch rows runs on one cluster of NB = H / kUnits
// blocks; block j of the cluster owns hidden units U_j = [32 j, 32 j + 32)
// and their four gate columns C_j = {g H + u : g < 4, u in U_j}.  The
// block keeps Wh[:, C_j] (H x 128 bf16, 128 KB at H = 512) in shared memory
// for all steps, stored as Ws[k][p] with the 128 columns permuted to
// p(g, i) = (i / 8) * 32 + g * 8 + i % 8 for unit i of the block and gate
// g: columns [32 q, 32 q + 32) hold the four gates of units 8q..8q+7, so a
// warp that owns them holds all four gates of its units in its mma
// accumulators (the forward) or in its A fragments' rows (the backward).
// The forward reads the slice as B = Wh[k = hidden, n = column]
// (ldmatrix.trans), the backward as B = Wh^T[k = column, n = hidden]
// (ldmatrix): one layout serves both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace lstm_cluster {

constexpr int kRows = 32;       // batch rows of a cluster (two m16 tiles)
constexpr int kUnits = 32;      // hidden units of a block (128 columns)
constexpr int kCols = 4 * kUnits;
constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxBlocks = 16;  // H <= 512: the largest cluster (non-portable)
constexpr int kWsPitch = kCols + 8;    // bf16 per resident slice row

// The persistent kernels run bf16 (dtype 1) at H = 128, 256, 384 or 512
// (a cluster of 4, 8, 12 or 16 blocks), any number of rows.  The one
// predicate of the route; ops/lstm_layer.py persistent_route mirrors it.
inline bool persist_ok(int rows, int hidden, int dtype) {
  return dtype == 1 && rows > 0 && hidden % 128 == 0 && hidden >= 128 &&
         hidden <= kMaxBlocks * kUnits;
}

// The stack's layer wavefront (lstm_fwd_stack_persist, lstm_bwd_stack_persist)
// runs 2L - 1 clusters of NB blocks per row tile, all resident at once, so
// it takes (2L - 1) NB <= kStackMaxBlocks: 6 clusters of 16 (the card holds
// 7 at the forward's shared memory), or more of the narrower clusters.  The
// one predicate of that route; ops/lstm_stack.py stack_persistent_route
// mirrors it.
constexpr int kStackMaxBlocks = 96;
// Depth, in steps, of the rings through which a projection stage hands its
// products to a recurrence stage (x . Wx up, the dh from above down);
// ops/lstm_stack.py STACK_RING mirrors it.  At least 2: a recurrence loads
// step t + 1's input during step t.
constexpr int kRingDepth = 4;

inline bool stack_persist_ok(int rows, int hidden, int layers, int dtype) {
  return persist_ok(rows, hidden, dtype) && layers >= 2 &&
         (2 * layers - 1) * (hidden / kUnits) <= kStackMaxBlocks;
}

// Position of column (gate g, unit i of the block) in the resident slice.
__host__ __device__ __forceinline__ int slice_col(int g, int i) {
  return (i / 8) * 32 + g * 8 + i % 8;
}

// Stage Wh[:, C_j] of the [H, 4H] weight into ws [H][kWsPitch], in
// 16-byte cp.async pieces (8 units of one gate), as one committed group;
// the caller waits for it.
__device__ __forceinline__ void stage_slice(const __nv_bfloat16* __restrict__ wh,
                                            int hidden, int u0,
                                            __nv_bfloat16* ws) {
  const int pieces = hidden * 16;          // per row: 4 gates x 4 octets
  for (int e = threadIdx.x; e < pieces; e += blockDim.x) {
    const int k = e / 16, g = (e % 16) / 4, oct = e % 4;
    mma::cp_async16(ws + (size_t)k * kWsPitch + slice_col(g, 8 * oct),
                    wh + (size_t)k * 4 * hidden + (size_t)g * hidden + u0 +
                        8 * oct);
  }
  mma::cp_async_commit();
}

// ---------------------------------------------------------------------------
// Cluster primitives (PTX ISA: %cluster_ctarank, barrier.cluster)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Cluster barrier: every thread of every block of the cluster arrives,
// releasing its earlier writes at cluster scope, then waits, acquiring
// everyone's.
__device__ __forceinline__ void sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Handoff between clusters (the stack's wavefront)
// ---------------------------------------------------------------------------
//
// A cluster barrier cannot span two clusters, so the stages of the stack
// hand off through L2 with step flags, [NB] words a stage and row tile:
// block j of a producer stage, after a barrier over its threads, stores
// the number of steps it has finished into flag j with release semantics
// at .gpu scope (a plain store: no atomics); a consumer's lanes 0..NB-1
// spin with acquire loads until every flag reaches the step it needs, then
// a block barrier lets its other threads read what the producers wrote
// (with .cg loads: the data is read from L2, never from a stale L1 line).

// One thread of each block of a stage, after a barrier over its block:
// publish that the block has finished `steps` steps, releasing every
// write of the block before it.
__device__ __forceinline__ void publish(unsigned* flags, unsigned steps) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(flags + rank()),
               "r"(steps)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// One thread: return once *flag >= steps.  The clusters of a launch are all
// resident (a cooperative launch), so a producer a step ahead answers
// within microseconds; a wait of kSpinLimitNs means the wavefront is
// broken, and the kernel traps (the launch fails) instead of hanging.
constexpr unsigned long long kSpinLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void spin_until(const unsigned* flag,
                                           unsigned steps) {
  if (load_acquire(flag) >= steps) return;
  const unsigned long long t0 = now_ns();
  while (load_acquire(flag) < steps) {
    __nanosleep(20);
    if (now_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// Every thread of the block: return once all NB blocks of the stage whose
// flags these are have finished `steps` steps.
template <int NB>
__device__ __forceinline__ void wait_for(const unsigned* flags,
                                         unsigned steps) {
  if (threadIdx.x < NB) spin_until(flags + threadIdx.x, steps);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Launch `kernel` on a grid of (NB, clusters) blocks in clusters of (NB, 1).
// A cluster that cannot be scheduled fails the launch; nothing else runs in
// its place.  resident: the clusters wait on one another, so all must be
// resident at once: a cooperative launch, which the runtime refuses
// (cudaErrorCooperativeLaunchTooLarge) before anything runs where the card
// cannot hold them together, so it never hangs.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int nb, int clusters,
                            bool resident, size_t smem, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, clusters, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = resident ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  // a refused launch leaves its (non-sticky) error as the thread's last
  // error: take it, so that the next launch check does not report it again
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// One cluster per 32-row tile.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int nb, int rows, size_t smem,
                   cudaStream_t stream, Args... args) {
  return launch_clusters(kernel, nb, (rows + kRows - 1) / kRows, false, smem,
                         stream, args...);
}

// How many clusters of `kernel` the card holds at once (0: none fits).
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int nb, size_t smem) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace lstm_cluster
