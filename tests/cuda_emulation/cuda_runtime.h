// A stand-in for <cuda_runtime.h> that lets g++ compile the port's CUDA
// sources and run them on the CPU, for tests on machines without nvcc.
//
// A launch runs its thread blocks one after another, or with clusters its
// clusters one after another, the blocks of a cluster together; the threads
// of a block are OS threads, `__syncthreads()` is a barrier over them, the
// cluster barrier one over all threads of the cluster's blocks, and
// warp-wide operations (shuffles) exchange their operands through a slot
// array of the warp between two barriers of its 32 threads. Dynamic shared
// memory is a buffer of each block filled with NaN before it starts. Only
// what the sources under twoforone_torch/ops/csrc use is provided.
//
// The sources reach the launch syntax, the clustered launch, the count of
// resident clusters and the dynamic shared memory through the TILE_LAUNCH,
// TILE_LAUNCH_CLUSTER, TILE_MAX_ACTIVE_CLUSTERS and TILE_DYNAMIC_SMEM macros
// (tile_gemm.cuh), which are defined here for the CPU, and a block's place in
// its cluster through shim::cluster_rank() and its kin. Asynchronous copies
// are plain copies there (the sources' PTX has scalar forms without
// __CUDA_ARCH__), so a wait on a copy group returns at once.

#pragma once

#include <pthread.h>

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)

using std::max;
using std::min;

struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct uint3 { unsigned x, y, z; };

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaDevAttrMultiProcessorCount = 16;

namespace shim {

constexpr int MAX_SMEM_BYTES = 227 * 1024;

struct Block {
  pthread_barrier_t all;
  std::vector<pthread_barrier_t> warp;
  std::vector<float> slot_f;      // 32 floats per warp
  alignas(16) unsigned char smem[MAX_SMEM_BYTES];
};

inline thread_local Block* block_of_thread = nullptr;
inline Block*& current() { return block_of_thread; }

// The cluster of the calling thread: its rank, the cluster's index and the
// number of clusters of the launch, and the barrier over its threads.
struct ClusterPlace {
  int rank = 0, index = 0, count = 1;
  pthread_barrier_t* all = nullptr;
};
inline thread_local ClusterPlace cluster_of_thread;

inline cudaError_t& last_error() {
  static cudaError_t err = cudaSuccess;
  return err;
}

}  // namespace shim

inline thread_local uint3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { pthread_barrier_wait(&shim::current()->all); }

namespace shim {
inline int cluster_rank() { return cluster_of_thread.rank; }
inline int cluster_index() { return cluster_of_thread.index; }
inline int cluster_count() { return cluster_of_thread.count; }
inline void cluster_sync() {
  if (cluster_of_thread.all) pthread_barrier_wait(cluster_of_thread.all);
}
}  // namespace shim

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  shim::Block* b = shim::current();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  b->slot_f[warp * 32 + lane] = v;
  pthread_barrier_wait(&b->warp[warp]);
  const float got = b->slot_f[warp * 32 + (lane ^ lane_mask)];
  pthread_barrier_wait(&b->warp[warp]);
  return got;
}

inline void __syncwarp(unsigned = 0xffffffffu) {}
inline float __ldg(const float* p) { return *p; }
inline float rsqrtf(float v) { return 1.f / sqrtf(v); }

template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= shim::MAX_SMEM_BYTES ? cudaSuccess : cudaErrorInvalidValue;
}
// The emulated card: EMU_SM_COUNT SMs (2 where unset), each holding
// EMU_BLOCKS_PER_SM blocks, or where that is unset as many as its threads
// (2048) and shared memory allow. The persistent grids follow these numbers,
// so a test picks a grid of a few blocks through them.
namespace shim {
inline int env_int(const char* name, int fallback) {
  const char* v = std::getenv(name);
  return v && *v ? std::atoi(v) : fallback;
}
}  // namespace shim
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int threads,
                                                          size_t smem) {
  const int fit = (int)std::min<size_t>(2048 / std::max(threads, 1),
                                        shim::MAX_SMEM_BYTES / std::max<size_t>(smem, 1));
  *blocks = shim::env_int("EMU_BLOCKS_PER_SM", fit);
  return cudaSuccess;
}
namespace shim {
// Clusters of `cluster` blocks that the emulated card keeps resident: its
// resident blocks (SMs times blocks an SM) divided by the cluster size.
inline cudaError_t max_active_clusters(int* count, int cluster, int threads, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, 0, threads, smem);
  *count = env_int("EMU_SM_COUNT", 2) * per_sm / std::max(cluster, 1);
  return cudaSuccess;
}
}  // namespace shim
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = shim::env_int("EMU_SM_COUNT", 2);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t err = shim::last_error();
  shim::last_error() = cudaSuccess;
  return err;
}
inline const char* cudaGetErrorString(cudaError_t err) {
  return err == cudaSuccess ? "no error" : "invalid value";
}

namespace shim {

inline float4* dynamic_smem() { return reinterpret_cast<float4*>(current()->smem); }

// Runs `body` once per thread of every block: clusters of `cluster` blocks
// in order, the blocks of a cluster at once (a launch without clusters has
// clusters of one block).
inline void launch(int grid, int block_threads, size_t smem_bytes,
                   const std::function<void()>& body, int cluster = 1) {
  if (grid < 1 || block_threads < 1 || block_threads % 32 || smem_bytes > MAX_SMEM_BYTES
      || cluster < 1 || grid % cluster) {
    last_error() = cudaErrorInvalidValue;
    return;
  }
  const int warps = block_threads / 32;
  std::vector<Block*> blocks(cluster);
  for (auto& b : blocks) {
    b = new Block;
    pthread_barrier_init(&b->all, nullptr, block_threads);
    b->warp.resize(warps);
    for (auto& w : b->warp) pthread_barrier_init(&w, nullptr, 32);
    b->slot_f.resize(warps * 32);
  }
  pthread_barrier_t all;
  pthread_barrier_init(&all, nullptr, cluster * block_threads);
  for (int c = 0; c < grid / cluster; ++c) {
    std::vector<std::thread> threads;
    for (int rank = 0; rank < cluster; ++rank) {
      Block* b = blocks[rank];
      float* s = reinterpret_cast<float*>(b->smem);
      std::fill(s, s + MAX_SMEM_BYTES / 4, std::numeric_limits<float>::quiet_NaN());
      const int blk = c * cluster + rank;
      for (int tid = 0; tid < block_threads; ++tid)
        threads.emplace_back([=, &body, &all] {
          block_of_thread = b;
          if (cluster > 1) cluster_of_thread = {rank, c, grid / cluster, &all};
          threadIdx = {(unsigned)tid, 0, 0};
          blockIdx = {(unsigned)blk, 0, 0};
          blockDim = {(unsigned)block_threads, 1, 1};
          gridDim = {(unsigned)grid, 1, 1};
          body();
        });
    }
    for (auto& th : threads) th.join();
  }
  pthread_barrier_destroy(&all);
  for (auto& b : blocks) {
    pthread_barrier_destroy(&b->all);
    for (auto& w : b->warp) pthread_barrier_destroy(&w);
    delete b;
  }
}

}  // namespace shim

#define TILE_DYNAMIC_SMEM(name) float4* name = shim::dynamic_smem()
#define TILE_LAUNCH(kernel, grid, block, smem, stream, ...) \
  shim::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#define TILE_LAUNCH_CLUSTER(kernel, grid, cluster, block, smem, stream, ...) \
  (shim::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); }, cluster), cudaSuccess)
#define TILE_MAX_ACTIVE_CLUSTERS(count, kernel, cluster, block, smem) \
  shim::max_active_clusters(count, cluster, block, smem)
