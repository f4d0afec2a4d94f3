// The global layout of the straight frame kernels (straight_frames.cu's K1
// and straight_frames_sorted.cu's K3): the scenes one block cannot hold,
// past MAX_BLOCK_THREADS = 1024 slots (one thread a slot) or past a block's
// 227 KB of shared memory (the rows and the ballot words grow with the
// lanes), up to STRAIGHT_GLOBAL_SLOTS = 8192.
//
// One env is a thread-block cluster of N = ceil(V / 512) blocks (at most
// 16) of G threads, G the fewest multiple of 32 with N G >= V; slot i is
// thread i % G of rank i / G, so a warp never straddles two blocks.  The
// env's rows and ballot words, which the block layout keeps in shared
// memory, sit in a slab of global memory the wrapper takes from torch's
// allocator (from the graph's pool when captured), carved for the env's
// N G threads exactly as a block's shared memory is carved for its
// threads: every stride, walk and tie rule of the block layout holds, and
// a slot reads another slot's row at the same index wherever it lies.  A
// block keeps only the lane offsets in shared memory (lane_offset).  The
// barrier is cluster.sync(), whose arrive / wait are release / acquire at
// cluster scope, so a slab word one block writes before it is seen by
// every block of the cluster after it; the slab is never read through the
// non-coherent path.  A block writes its warps' ballot words through a view
// of the rows whose word base starts at its first warp (Rows::at_warp), so
// the shared ballot_word keeps indexing by threadIdx.x.  Registers are
// capped at 128 a thread (__launch_bounds__(512)).

#pragma once

#include <cooperative_groups.h>

#include "straight_common.cuh"

namespace cg = cooperative_groups;

#define STRAIGHT_GLOBAL_THREADS 512
#define STRAIGHT_GLOBAL_BLOCKS 16
#define STRAIGHT_GLOBAL_SLOTS (STRAIGHT_GLOBAL_BLOCKS * STRAIGHT_GLOBAL_THREADS)
#define STRAIGHT_PORTABLE_CLUSTER 8

// The (B, V) field pointers of a frame kernel's entry, in the order of
// ops/straight_frames.py::_IN_FIELDS and _OUT_FIELDS, and the Fields they
// make: the head of every entry's parameter list.
#define STRAIGHT_FIELD_PARAMS                                                              \
  const float *pos, const float *heading, const float *speed, const int *lane,            \
      const int *target_lane, const float *target_speed, const float *timer,              \
      const uint8_t *crashed, const uint8_t *impact_pending, const float *impact,         \
      const float *steering, const float *accel, const float *delta, const int *kind,     \
      const float *length, const float *width, const uint8_t *check_collisions,           \
      const uint8_t *collidable, const uint8_t *enable_lane_change,                       \
      const float *mobil_gain, const float *mobil_max_braking, const float *accel_params, \
      const float *steer_params, float *pos_out, float *heading_out, float *speed_out,    \
      int *lane_out, int *target_lane_out, float *timer_out, uint8_t *crashed_out,        \
      uint8_t *impact_pending_out, float *impact_out, float *steering_out, float *accel_out
#define STRAIGHT_FIELDS                                                                    \
  Fields {                                                                                 \
    pos, heading, speed, lane, target_lane, target_speed, timer, crashed, impact_pending,  \
        impact, steering, accel, delta, kind, length, width, check_collisions, collidable, \
        enable_lane_change, mobil_gain, mobil_max_braking, accel_params, steer_params,     \
        pos_out, heading_out, speed_out, lane_out, target_lane_out, timer_out, crashed_out, \
        impact_pending_out, impact_out, steering_out, accel_out                            \
  }

// Blocks an env of V slots takes in the global layout, and threads a block.
__host__ __device__ __forceinline__ int global_blocks(int V) {
  return (V + STRAIGHT_GLOBAL_THREADS - 1) / STRAIGHT_GLOBAL_THREADS;
}
__host__ __device__ __forceinline__ int global_threads(int V) {
  const int per = (V + global_blocks(V) - 1) / global_blocks(V);
  return (per + 31) / 32 * 32;
}

// Where this thread's slot lies: its env, its slot i, the env's threads n
// (its slots rounded up), the env's index of the block's first warp, and
// the block's rank among the env's blocks.
struct Place {
  int env, i, n, warp0, rank, blocks;
};

template <bool kGlobal>
__device__ __forceinline__ Place place() {
  if constexpr (kGlobal) {
    const cg::cluster_group c = cg::this_cluster();
    const int nb = static_cast<int>(c.num_blocks()), rank = static_cast<int>(c.block_rank());
    const int first = rank * static_cast<int>(blockDim.x);
    return {static_cast<int>(blockIdx.x) / nb, first + static_cast<int>(threadIdx.x),
            nb * static_cast<int>(blockDim.x), first / 32, rank, nb};
  } else {
    return {static_cast<int>(blockIdx.x), static_cast<int>(threadIdx.x),
            static_cast<int>(blockDim.x), 0, 0, 1};
  }
}

// The barrier between the phases of a frame: the block's, or the env's
// cluster's in the global layout; every thread of the env reaches it.
template <bool kGlobal>
__device__ __forceinline__ void env_sync() {
  if constexpr (kGlobal)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The launch configuration of `grid` blocks of `threads` threads in
// clusters of `blocks`, with `smem` bytes of dynamic shared memory; attr
// holds the cluster's shape and lives as long as the configuration.
inline cudaLaunchConfig_t global_config(int blocks, int threads, int grid, size_t smem,
                                        void* stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch of a global frame kernel: one env a cluster of global_blocks(V)
// blocks of global_threads(V) threads, the lane offsets in shared memory.
// Over STRAIGHT_PORTABLE_CLUSTER blocks the non-portable cluster size is
// allowed once per instantiation (variant: bit 0 the Linear rows', bit 1
// K1's objects one) and card; whether such a cluster
// fits the card is asked once per instantiation, card and shape (none:
// cudaErrorLaunchOutOfResources, which the wrapper raises).  Returns the
// CUDA error code.
template <typename Kernel, typename... Args>
int launch_global(Kernel kernel, int variant, int B, int V, int L, void* stream, Args... args) {
  if (V < 1 || V > STRAIGHT_GLOBAL_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = global_blocks(V), G = global_threads(V);
  const size_t smem = static_cast<size_t>(lane_offset_words(L)) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // set once per instantiation and card, before the occupancy query and
  // the launch: a launch under stream capture calls no function attribute
  static bool nonportable[4][64] = {};
  bool& set = nonportable[variant & 3][dev & 63];
  if (!set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  if (smem > 48 * 1024) {  // past 12,288 lanes
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      global_config(nb, G, nb * (B > 0 ? B : 1), smem, stream, &attr);
  static size_t fits[4][64][STRAIGHT_GLOBAL_BLOCKS + 1][STRAIGHT_GLOBAL_THREADS / 32 + 1] = {};
  size_t& fit = fits[variant & 3][dev & 63][nb][G / 32];
  if (smem + 1 > fit) {  // fit: the bytes asked + 1 (0: never asked)
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    fit = smem + 1;
  }
  if (B > 0) {
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `blocks` blocks of `threads` threads of a global
// frame kernel the card holds at once, with the lane offsets of L lanes in
// shared memory (tools/cluster_fit.py); -1 on an error.
template <typename Kernel>
int global_cluster_fit(Kernel kernel, int blocks, int threads, int L) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
      cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      global_config(blocks, threads, blocks,
                    static_cast<size_t>(lane_offset_words(L)) * sizeof(float), nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters;
}
