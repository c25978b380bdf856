// A stand-in for <cuda_runtime.h> that lets g++ compile the port's CUDA
// sources and run them on the CPU, for tests on machines without nvcc.
//
// A launch runs its thread blocks one after another; the threads of a block
// are OS threads, `__syncthreads()` is a barrier over them, and warp-wide
// operations (shuffles) exchange their operands through
// a slot array of the warp between two barriers of its 32 threads. Dynamic
// shared memory is a buffer filled with NaN before every block. Only what
// the sources under twoforone_torch/ops/csrc use is provided.
//
// The sources reach the launch syntax and the dynamic shared memory through
// the TILE_LAUNCH and TILE_DYNAMIC_SMEM macros (tile_gemm.cuh), which are
// defined here for the CPU. Asynchronous copies are plain copies there (the
// sources' PTX has scalar forms without __CUDA_ARCH__), so a wait on a copy
// group returns at once.

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

inline Block*& current() {
  static Block* block = nullptr;
  return block;
}

inline cudaError_t& last_error() {
  static cudaError_t err = cudaSuccess;
  return err;
}

}  // namespace shim

inline thread_local uint3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { pthread_barrier_wait(&shim::current()->all); }

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

// Runs `body` once per thread of every block, blocks in order.
inline void launch(int grid, int block_threads, size_t smem_bytes,
                   const std::function<void()>& body) {
  if (grid < 1 || block_threads < 1 || block_threads % 32 || smem_bytes > MAX_SMEM_BYTES) {
    last_error() = cudaErrorInvalidValue;
    return;
  }
  const int warps = block_threads / 32;
  Block* b = new Block;
  pthread_barrier_init(&b->all, nullptr, block_threads);
  b->warp.resize(warps);
  for (auto& w : b->warp) pthread_barrier_init(&w, nullptr, 32);
  b->slot_f.resize(warps * 32);
  current() = b;
  for (int blk = 0; blk < grid; ++blk) {
    float* s = reinterpret_cast<float*>(b->smem);
    std::fill(s, s + MAX_SMEM_BYTES / 4, std::numeric_limits<float>::quiet_NaN());
    std::vector<std::thread> threads;
    for (int tid = 0; tid < block_threads; ++tid)
      threads.emplace_back([=, &body] {
        threadIdx = {(unsigned)tid, 0, 0};
        blockIdx = {(unsigned)blk, 0, 0};
        blockDim = {(unsigned)block_threads, 1, 1};
        gridDim = {(unsigned)grid, 1, 1};
        body();
      });
    for (auto& th : threads) th.join();
  }
  current() = nullptr;
  pthread_barrier_destroy(&b->all);
  for (auto& w : b->warp) pthread_barrier_destroy(&w);
  delete b;
}

}  // namespace shim

#define TILE_DYNAMIC_SMEM(name) float4* name = shim::dynamic_smem()
#define TILE_LAUNCH(kernel, grid, block, smem, stream, ...) \
  shim::launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
