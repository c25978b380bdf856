// Tile core of the two whole-force kernels (fused_score_cl.cu, fused_score.cu).
//
// A thread block works on a *tile* of several chains at once: the rows of all
// its chains, padded to a multiple of 16, form one (rows x K) activation
// matrix in the block's global scratch, so that every projection of the
// network is one product (rows x K) . (K x out) and a weight element fetched
// once feeds `rows` multiply-adds instead of one chain's bead count.
//
// gemm<TM, NARROW>() computes such a product:
// - the weight matrix and the activations are cut into chunks along K and
//   along the output columns (see Shape); the chunks travel from global memory
//   (weights: L2) into a ring of STAGES shared-memory slots by 16-byte
//   cp.async copies, two chunks ahead of the one being multiplied, with one
//   block-wide barrier per chunk. (One bulk copy of the copy engine per row
//   of a chunk was tried in their place: rows of 64 to 1024 bytes are too
//   small for it, the products ran at 0.6 of their rate.)
// - the chunk product is float32 register tiles on the CUDA cores: a thread
//   keeps TR x 8 outputs and reads its rows and columns from the staged chunk
//   as float4 (see Shape for how threads are laid out). (The three-pass TF32
//   split on the tensor cores, mma.sync m16n8k8, was tried in its place and
//   was no faster inside the kernels; PERF.md has both times.)
// - the epilogue adds the bias and stores, accumulates, also stores GELU of
//   the result, or multiplies by GELU' of a stored pre-activation.
// Each output element is a sum over k in an order that does not depend on the
// row's position in the tile, on the tile's size or on its tile-mates, so a
// chain's result has the same bits whatever batch it arrives in.
//
// The header also holds the row-wise pieces both kernels share (LayerNorm,
// gated residuals and their backward) and the attention block, which works
// from shared memory on one chain and a group of its heads at a time.
//
// A tile may also be shared by the blocks of a thread-block cluster (K1 at a
// few chains, see fused_score_cl.cu): then gemm() takes block `rank` of
// `ranks` and computes that block's share of the output columns, and the
// attention block that block's share of the heads. A share never cuts a sum:
// each output element is summed by one thread in the order above.
// Everything here compiles as plain C++ too (the inline PTX has scalar forms
// under #ifndef __CUDA_ARCH__), which the CPU emulation in tests/ uses.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

#ifdef __CUDACC__
#define TILE_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#define TILE_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
// A launch of `grid` blocks in clusters of `cluster`, and how many such
// clusters of `kernel` the card keeps resident at once.
#define TILE_LAUNCH_CLUSTER(kernel, grid, cluster, block, smem, stream, ...) \
  tile::launch_clusters(kernel, grid, cluster, block, smem, stream, __VA_ARGS__)
#define TILE_MAX_ACTIVE_CLUSTERS(count, kernel, cluster, block, smem) \
  tile::max_active_clusters(count, kernel, cluster, block, smem)
#endif
// Without nvcc the including translation unit supplies the four macros.

namespace tile {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int KC = 32;          // depth of a staged chunk
constexpr int XS = KC + 4;      // shared-memory row stride of an activation chunk
constexpr int OC = 128;         // output columns of a staged weight chunk
constexpr int WS = OC + 8;      // shared-memory row stride of a weight chunk
constexpr int STAGES = 3;       // ring of staged chunks
constexpr int MIN_BLOCKS = 2;   // thread blocks an SM holds (128 registers a thread)
constexpr int MAX_TM = 5;       // a tile has 16 * TM rows, at most 80

// Floats of shared memory that gemm() needs for a tile of `rows` rows.
// Must match tile_plan.py::gemm_smem_floats.
__host__ __device__ inline long long gemm_smem_floats(int rows) {
  return (long long)STAGES * ((long long)rows * XS + (long long)KC * WS);
}

__host__ __device__ inline long long round4(long long v) { return (v + 3) & ~3LL; }

// ------------------------------------------------------------ PTX pieces

// 16 bytes from global to shared memory without passing through registers.
__device__ inline void cp_async16(float* smem_dst, const float* gmem_src) {
#ifdef __CUDA_ARCH__
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
#else
  for (int i = 0; i < 4; ++i) smem_dst[i] = gmem_src[i];
#endif
}

__device__ inline void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most `PENDING` of this thread's committed groups are in flight.
template <int PENDING>
__device__ inline void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
#endif
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ clusters

// This block's rank in its cluster, the cluster's index in the grid and the
// number of clusters; a launch without clusters is one of one block each.
__device__ inline int cluster_rank() {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
#elif defined(__CUDACC__)
  return 0;
#else
  return shim::cluster_rank();
#endif
}

__device__ inline int cluster_index() {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
#elif defined(__CUDACC__)
  return 0;
#else
  return shim::cluster_index();
#endif
}

__device__ inline int cluster_count() {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return (int)r;
#elif defined(__CUDACC__)
  return 1;
#else
  return shim::cluster_count();
#endif
}

// Every thread of every block of the cluster arrives; what each wrote before
// (global and shared memory) is seen by all after.
__device__ inline void cluster_sync() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#elif !defined(__CUDACC__)
  shim::cluster_sync();
#endif
}

#ifdef __CUDACC__
template <class... P, class... A>
inline cudaError_t launch_clusters(void (*kernel)(P...), int grid, int cluster, int block,
                                   size_t smem, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class... P>
inline cudaError_t max_active_clusters(int* count, void (*kernel)(P...), int cluster, int block,
                                       size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}
#endif

// Block `rank` of `ranks` that share a tile: the rows of the row-wise pieces
// and the output columns of a product it takes (contiguous, a multiple of 4
// wide), and a barrier over the blocks where one reads what another wrote.
// One block alone (ranks 1) takes everything and needs no barrier.
struct Part {
  int rank = 0, ranks = 1;
  __device__ void sync() const {
    if (ranks > 1) cluster_sync();
  }
  // First column of this block's share of `out` (a multiple of 4) columns.
  __device__ int col0(int out) const { return 4 * (out / 4 * rank / ranks); }
  __device__ int cols(int out) const { return 4 * (out / 4 * (rank + 1) / ranks) - col0(out); }
};

__device__ inline float gelu(float x) { return 0.5f * x * (1.f + erff(x * 0.70710678118654752f)); }

__device__ inline float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f))
         + x * 0.39894228040143268f * expf(-0.5f * x * x);
}

__device__ inline float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ inline void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ inline float sum4(float4 v) { return (v.x + v.y) + (v.z + v.w); }
__device__ inline float dot4(float4 a, float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

// ------------------------------------------------------------ the product

// What the epilogue of a product does with val = sum + bias.
enum Epilogue {
  EPI_STORE,            // Y = val
  EPI_ACCUMULATE,       // Y += val
  EPI_STORE_AND_GELU,   // Y = val, AUX = gelu(val)
  EPI_TIMES_GELU_GRAD,  // Y = val * gelu'(AUX)
};

// How a product of a tile of 16 * TM rows is cut: the chunk that is staged at
// a time (KCH deep, NCOLS output columns, with padded row strides XSW and WSW
// in shared memory) and a thread's share of it.
//
// Shared memory hands a warp 32 floats a cycle, and a thread that keeps TR x 8
// outputs reads TR + 8 floats for every 8 TR multiply-adds, while four
// schedulers issue multiply-adds side by side: the product runs at the
// multiply-adds' rate only from about 8 x 8 outputs a thread on, and at a
// fifth of it at 1 x 8. So threads are laid out in RG groups along the rows,
// TR = rows / RG rows a thread, and 8 columns. A narrow product (64 output
// columns a pass) has too few columns for all threads: there RG is 8, and four
// groups of threads each take a quarter of every chunk's depth, their sums
// added at the end in the order of the groups; a tile of 80 rows goes through
// it as two halves of 40, so that a thread's share stays within its registers
// and every sum has the same order whatever the tile's size. A wide product
// keeps RG = 16 and stages 128 columns, except on tiles of 16 rows, where
// RG = 8 and 256 columns at half the depth give a thread two rows. (On the
// card, 1000 chains of chignolin: the narrow products take 0.6 of their time
// with the split; the taller wide tiles were faster alone and slower inside
// the kernel above 16 rows, 2.32 ms against 2.15 for the call.)
//
// A block's share of a product (Part) has fewer columns: a wide share of 16
// rows takes the 256-column shape where its width is a multiple of 256, else
// the 128-column one; a narrow share of at most 32 (16) columns stages 32
// (16) columns, four (two) a thread, at twice the depth where a slot holds
// that, so that it takes half the chunks. Its depth groups are those of the
// 64-column shape: group q takes depths 8q .. 8q + 7 of every 32, in order.
// Wide or narrow, every output element's sum is the same in every shape.
template <int TM, bool NARROW, int NC = NARROW ? 64 : (TM == 1 ? 256 : 128)>
struct Shape {
  static constexpr int PASSES = NARROW && TM > 4 ? 2 : 1;  // row halves taken in turn
  static constexpr int ROWS = 16 * TM / PASSES;           // rows staged and multiplied at a time
  static constexpr int RG = NARROW || NC == 256 ? 8 : 16;
  static constexpr int TR = ROWS / RG;
  static constexpr int KSPLIT = NARROW ? 4 : 1;  // groups that share out a chunk's depth
  static constexpr int NCOLS = NC;
  static constexpr int TC = NARROW ? NC / 8 : 8;  // output columns of a thread
  // A narrow share stages twice the depth where the slot holds it.
  static constexpr bool DEEP = NARROW && NC < 64 && ROWS * 68 + 64 * (NC + 8) <= ROWS * XS + KC * WS;
  static constexpr int KCH = NC == 256 ? 16 : DEEP ? 64 : 32;
  static constexpr int XSW = KCH + 4, WSW = NCOLS + 8;
  static constexpr int SLOT = ROWS * XSW + KCH * WSW;
  static_assert(NCOLS == (NARROW ? 8 : NTHREADS / RG) * TC, "threads cover the columns");
  static_assert(SLOT <= ROWS * XS + KC * WS, "a slot of the ring holds every chunk shape");
  static_assert(KSPLIT * ROWS * NCOLS <= STAGES * (ROWS * XS + KC * WS),
                "the ring holds the partial sums of a split product");
};

// Copies chunk (k0, o0) of X (rows x K) and W (K x cols, rows ld apart) into
// one ring slot; what lies beyond K or cols is zero-filled. Requires K % 4 ==
// cols % 4 == ld % 4 == 0 and 16-byte aligned X, W.
template <class S>
__device__ inline void stage_chunk(const float* X, int K, const float* __restrict__ W, int ld,
                                   int cols, int k0, int o0, float* slot) {
  const float4 zero = {0.f, 0.f, 0.f, 0.f};
  float* xs = slot;
  float* ws = slot + S::ROWS * S::XSW;
  for (int idx = threadIdx.x; idx < S::ROWS * (S::KCH / 4); idx += NTHREADS) {
    const int r = idx / (S::KCH / 4), k = k0 + (idx % (S::KCH / 4)) * 4;
    float* dst = xs + r * S::XSW + (k - k0);
    if (k < K)
      cp_async16(dst, X + (size_t)r * K + k);
    else
      store4(dst, zero);
  }
  constexpr int c4 = S::NCOLS / 4;
  for (int idx = threadIdx.x; idx < S::KCH * c4; idx += NTHREADS) {
    const int kk = idx / c4, o = (idx % c4) * 4;
    float* dst = ws + kk * S::WSW + o;
    if (k0 + kk < K && o0 + o < cols)
      cp_async16(dst, W + (size_t)(k0 + kk) * ld + o0 + o);
    else
      store4(dst, zero);
  }
}

// What is stored at Y[at] for val = sum + bias.
__device__ inline float finish(float val, int epi, const float* Y, float* AUX, size_t at) {
  if (epi == EPI_ACCUMULATE) return Y[at] + val;
  if (epi == EPI_STORE_AND_GELU) AUX[at] = gelu(val);
  if (epi == EPI_TIMES_GELU_GRAD) return val * gelu_grad(AUX[at]);
  return val;
}

// Stores four neighbouring results of a row: Y[at .. at + 3] from sums v.
__device__ inline void finish4(float4 v, const float* __restrict__ bias, int col, int epi,
                               float* Y, float* AUX, size_t at) {
  const float4 b = bias ? load4(bias + col) : float4{0.f, 0.f, 0.f, 0.f};
  store4(Y + at, float4{finish(v.x + b.x, epi, Y, AUX, at), finish(v.y + b.y, epi, Y, AUX, at + 1),
                        finish(v.z + b.z, epi, Y, AUX, at + 2),
                        finish(v.w + b.w, epi, Y, AUX, at + 3)});
}

// acc[m][0..TC-1] += a[m] (4 depths of TR rows) times rows k .. k + 3 of the
// weight chunk at ws: with TC = 8 columns c0 .. c0 + 3 and c1 .. c1 + 3, with
// TC = 4 or 2 columns c0 .. c0 + TC - 1.
template <int TR, int TC>
__device__ inline void tile_fma(float (&acc)[TR][TC], const float4 (&a)[TR], const float* ws,
                                int wsw, int c0, int c1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float b[TC];
    if constexpr (TC == 2) {
      const float2 b0 = load2(ws + kk * wsw + c0);
      b[0] = b0.x; b[1] = b0.y;
    } else {
      const float4 b0 = load4(ws + kk * wsw + c0);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      if constexpr (TC == 8) {
        const float4 b1 = load4(ws + kk * wsw + c1);
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
      }
    }
#pragma unroll
    for (int m = 0; m < TR; ++m) {
      const float av = kk == 0 ? a[m].x : kk == 1 ? a[m].y : kk == 2 ? a[m].z : a[m].w;
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[m][j] = fmaf(av, b[j], acc[m][j]);
    }
  }
}

// A wide product: every thread works on whole chunks. One pass of the ring
// over all (output chunk, depth chunk) steps. W, Y and AUX have rows ld
// floats apart, of which the product takes the first `cols`.
template <int TM, int NC>
__device__ inline void gemm_whole_chunks(const float* X, int K, const float* __restrict__ W,
                                         const float* __restrict__ bias, float* Y, int ld,
                                         int cols, int epi, float* AUX, float* smem) {
  using S = Shape<TM, false, NC>;
  const int n_kc = (K + S::KCH - 1) / S::KCH, n_oc = (cols + S::NCOLS - 1) / S::NCOLS;
  const int steps = n_oc * n_kc;
  // Blocks start at different output chunks, so that the blocks of a launch do
  // not all ask L2 for the same weight lines at once. The order along K, which
  // is the order of every sum, is the same for all.
  const int rot = blockIdx.x % n_oc;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // Thread (ty, tx) owns rows ty + RG m and columns 4 tx .. 4 tx + 3 and the
  // same half a chunk further on. A warp is 4 tx by 8 ty, so that the lanes
  // that load together share a weight address or a row.
  const int tx = S::RG == 8 ? warp * 4 + lane % 4 : (warp % 4) * 4 + lane % 4;
  const int ty = S::RG == 8 ? lane / 4 : (warp / 4) * 8 + lane / 4;
  float acc[S::TR][8];

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      stage_chunk<S>(X, K, W, ld, cols, (s % n_kc) * S::KCH,
                     ((s / n_kc + rot) % n_oc) * S::NCOLS, smem + s * S::SLOT);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // Chunk s has landed for every thread, and every thread is done with
    // chunk s - 1, whose slot the next copy overwrites.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < steps)
      stage_chunk<S>(X, K, W, ld, cols, (nxt % n_kc) * S::KCH,
                     ((nxt / n_kc + rot) % n_oc) * S::NCOLS, smem + (nxt % STAGES) * S::SLOT);
    cp_async_commit();

    const float* xs = smem + (s % STAGES) * S::SLOT;
    const float* ws = xs + S::ROWS * S::XSW;
    const int kc = s % n_kc, o0 = ((s / n_kc + rot) % n_oc) * S::NCOLS;

    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < S::TR; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
    }
#pragma unroll 4
    for (int k4 = 0; k4 < S::KCH; k4 += 4) {
      float4 a[S::TR];
#pragma unroll
      for (int m = 0; m < S::TR; ++m) a[m] = load4(xs + (ty + S::RG * m) * S::XSW + k4);
      tile_fma<S::TR, 8>(acc, a, ws + k4 * S::WSW, S::WSW, 4 * tx, S::NCOLS / 2 + 4 * tx);
    }
    if (kc == n_kc - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = o0 + h * (S::NCOLS / 2) + 4 * tx;
        if (col < cols) {
#pragma unroll
          for (int m = 0; m < S::TR; ++m)
            finish4(float4{acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2],
                           acc[m][4 * h + 3]},
                    bias, col, epi, Y, AUX, (size_t)(ty + S::RG * m) * ld + col);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A narrow product: NC output columns a pass (64, or 32 or 16 for a block's
// share), the depth of every chunk split over KSPLIT groups of threads. Group
// q takes depths 8q .. 8q + 7 of every 32 of each chunk, in order; in it
// thread (ty, tx) owns rows ty + RG m and TC columns (64: 4 tx .. 4 tx + 3 and
// 32 + 4 tx .. 32 + 4 tx + 3; 32 and 16: TC tx .. TC tx + TC - 1). At the end
// of a pass the groups' sums meet in the ring and are added in the order of
// the groups. A tile of 80 rows makes two passes, one for each half.
template <int TM, int NC>
__device__ inline void gemm_split_depth(const float* X0, int K, const float* __restrict__ W,
                                        const float* __restrict__ bias, float* Y, int ld, int cols,
                                        int epi, float* AUX, float* smem) {
  using S = Shape<TM, true, NC>;
  constexpr int GROUP = NTHREADS / S::KSPLIT, KQ = 32 / S::KSPLIT, TC = S::TC;
  const int q = threadIdx.x / GROUP, tx = threadIdx.x % 8, ty = (threadIdx.x % GROUP) / 8;
  const int c0 = TC == 8 ? 4 * tx : TC * tx, c1 = NC / 2 + 4 * tx;
  const int n_kc = (K + S::KCH - 1) / S::KCH;
  float acc[S::TR][TC];
  for (int pass = 0; pass < S::PASSES * ((cols + S::NCOLS - 1) / S::NCOLS); ++pass) {
    const int o0 = (pass / S::PASSES) * S::NCOLS, row0 = (pass % S::PASSES) * S::ROWS;
    const float* X = X0 + (size_t)row0 * K;
#pragma unroll
    for (int m = 0; m < S::TR; ++m)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[m][j] = 0.f;
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_kc) stage_chunk<S>(X, K, W, ld, cols, s * S::KCH, o0, smem + s * S::SLOT);
      cp_async_commit();
    }
    for (int s = 0; s < n_kc; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nxt = s + STAGES - 1;
      if (nxt < n_kc)
        stage_chunk<S>(X, K, W, ld, cols, nxt * S::KCH, o0, smem + (nxt % STAGES) * S::SLOT);
      cp_async_commit();
      const float* xs = smem + (s % STAGES) * S::SLOT;
      const float* ws = xs + S::ROWS * S::XSW;
#pragma unroll
      for (int k32 = 0; k32 < S::KCH; k32 += 32) {
#pragma unroll
        for (int k4 = k32 + q * KQ; k4 < k32 + q * KQ + KQ; k4 += 4) {
          float4 a[S::TR];
#pragma unroll
          for (int m = 0; m < S::TR; ++m) a[m] = load4(xs + (ty + S::RG * m) * S::XSW + k4);
          tile_fma<S::TR, TC>(acc, a, ws + k4 * S::WSW, S::WSW, c0, c1);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring: the sums take its place
#pragma unroll
    for (int m = 0; m < S::TR; ++m) {
      float* dst = smem + ((size_t)q * S::ROWS + ty + S::RG * m) * NC;
#pragma unroll
      for (int j = 0; j < TC; j += 4)
        if constexpr (TC == 2)
          dst[c0] = acc[m][0], dst[c0 + 1] = acc[m][1];
        else
          store4(dst + (j < 4 ? c0 : c1), float4{acc[m][j], acc[m][j + 1], acc[m][j + 2],
                                                 acc[m][j + 3]});
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < S::ROWS * (NC / 4); idx += NTHREADS) {
      const int r = idx / (NC / 4), c4 = (idx % (NC / 4)) * 4;
      if (o0 + c4 < cols) {
        float4 v = load4(smem + (size_t)r * NC + c4);
#pragma unroll
        for (int p = 1; p < S::KSPLIT; ++p) {
          const float4 w = load4(smem + ((size_t)p * S::ROWS + r) * NC + c4);
          v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        finish4(v, bias, o0 + c4, epi, Y, AUX, (size_t)(row0 + r) * ld + o0 + c4);
      }
    }
    __syncthreads();
  }
}

// Y (= or +=) X . W (+ bias) over a tile of 16 * TM rows; see the head of the
// file. X (rows x K), Y and AUX (rows x out) in the block's global scratch,
// W (K x out) row-major and bias in global memory; `smem` holds
// gemm_smem_floats(16 * TM) floats. NARROW products stage 64 output columns at
// a time (for out <= 64, or a few times that), the others 128 or 256. With
// part.ranks > 1 the block computes its share of the columns (Part::cols from
// Part::col0), the other blocks of the cluster the rest. Every thread of the
// block must call it; it starts and ends with the block in step.
template <int TM, bool NARROW>
__device__ __noinline__ void gemm(const float* X, int K, const float* __restrict__ W,
                                  const float* __restrict__ bias, float* Y, int out, int epi,
                                  float* AUX, float* smem, Part part = Part()) {
  if (part.ranks == 1) {
    if constexpr (NARROW)
      gemm_split_depth<TM, 64>(X, K, W, bias, Y, out, out, epi, AUX, smem);
    else
      gemm_whole_chunks<TM, TM == 1 ? 256 : 128>(X, K, W, bias, Y, out, out, epi, AUX, smem);
    return;
  }
  const int c0 = part.col0(out), cols = part.cols(out);
  W += c0;
  Y += c0;
  if (bias) bias += c0;
  if (AUX) AUX += c0;
  if constexpr (NARROW) {
    if (cols <= 16)
      gemm_split_depth<TM, 16>(X, K, W, bias, Y, out, cols, epi, AUX, smem);
    else if (cols <= 32)
      gemm_split_depth<TM, 32>(X, K, W, bias, Y, out, cols, epi, AUX, smem);
    else
      gemm_split_depth<TM, 64>(X, K, W, bias, Y, out, cols, epi, AUX, smem);
  } else if constexpr (TM == 1) {
    if (cols % 256 == 0)
      gemm_whole_chunks<1, 256>(X, K, W, bias, Y, out, cols, epi, AUX, smem);
    else
      gemm_whole_chunks<1, 128>(X, K, W, bias, Y, out, cols, epi, AUX, smem);
  } else {
    gemm_whole_chunks<TM, 128>(X, K, W, bias, Y, out, cols, epi, AUX, smem);
  }
}

// ------------------------------------------------------------ row-wise pieces
// X, Y, ... are (rows x c) row-major in the block's global scratch, c a
// multiple of 4. ROW_LANES lanes share a row, each on float4 pieces of it, so
// a block works on ROW_SLOTS rows at once; `rows` is a multiple of 16, so the
// lanes of a warp stay together. Each piece ends with the block in step.

constexpr int ROW_LANES = 8;
constexpr int ROW_SLOTS = NTHREADS / ROW_LANES;

// Sum over the ROW_LANES lanes that share a row.
__device__ inline float row_sum(float v) {
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}


// Mean and 1 / sqrt(variance + 1e-5) of row x (c floats), for the lanes of the row.
__device__ inline void row_stats(const float* x, int c, int sub, float& mu, float& rs) {
  float s = 0.f;
  for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) s += sum4(load4(x + j));
  mu = row_sum(s) / c;
  float q = 0.f;
  for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
    float4 v = load4(x + j);
    v.x -= mu; v.y -= mu; v.z -= mu; v.w -= mu;
    q += dot4(v, v);
  }
  rs = rsqrtf(row_sum(q) / c + 1e-5f);
}

// LayerNorm over the features of each row (eps 1e-5).
__device__ inline void layer_norm(const float* X, float* Y, const float* __restrict__ g,
                                  const float* __restrict__ b, int rows, int c) {
  const int slot = threadIdx.x / ROW_LANES, sub = threadIdx.x % ROW_LANES;
  for (int r = slot; r < rows; r += ROW_SLOTS) {
    const float* x = X + (size_t)r * c;
    float mu, rs;
    row_stats(x, c, sub, mu, rs);
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
      const float4 v = load4(x + j), gg = load4(g + j), bb = load4(b + j);
      store4(Y + (size_t)r * c + j,
             float4{(v.x - mu) * rs * gg.x + bb.x, (v.y - mu) * rs * gg.y + bb.y,
                    (v.z - mu) * rs * gg.z + bb.z, (v.w - mu) * rs * gg.w + bb.w});
    }
  }
  __syncthreads();
}

// DX += d LN(X) / dX applied to DY (the LayerNorm input gradient).
__device__ inline void layer_norm_bwd(const float* X, const float* DY,
                                      const float* __restrict__ g, float* DX, int rows, int c) {
  const int slot = threadIdx.x / ROW_LANES, sub = threadIdx.x % ROW_LANES;
  for (int r = slot; r < rows; r += ROW_SLOTS) {
    const float* x = X + (size_t)r * c;
    const float* dy = DY + (size_t)r * c;
    float mu, rs;
    row_stats(x, c, sub, mu, rs);
    float s1 = 0.f, s2 = 0.f;
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
      const float4 v = load4(x + j), d = load4(dy + j), gg = load4(g + j);
      const float4 gy = {d.x * gg.x, d.y * gg.y, d.z * gg.z, d.w * gg.w};
      s1 += sum4(gy);
      s2 += dot4(gy, float4{(v.x - mu) * rs, (v.y - mu) * rs, (v.z - mu) * rs, (v.w - mu) * rs});
    }
    s1 = row_sum(s1) / c;
    s2 = row_sum(s2) / c;
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
      const float4 v = load4(x + j), d = load4(dy + j), gg = load4(g + j);
      float4 o = load4(DX + (size_t)r * c + j);
      o.x += rs * (d.x * gg.x - s1 - (v.x - mu) * rs * s2);
      o.y += rs * (d.y * gg.y - s1 - (v.y - mu) * rs * s2);
      o.z += rs * (d.z * gg.z - s1 - (v.z - mu) * rs * s2);
      o.w += rs * (d.w * gg.w - s1 - (v.w - mu) * rs * s2);
      store4(DX + (size_t)r * c + j, o);
    }
  }
  __syncthreads();
}

// Gated residual: g = sigmoid(a.ga + h.gh); Hout = a g + h (1 - g); G[r] = g.
__device__ inline void gate_fwd(const float* A, const float* Hin, const float* __restrict__ ga,
                                const float* __restrict__ gh, float* G, float* Hout, int rows,
                                int c) {
  const int slot = threadIdx.x / ROW_LANES, sub = threadIdx.x % ROW_LANES;
  for (int r = slot; r < rows; r += ROW_SLOTS) {
    const float* a = A + (size_t)r * c;
    const float* h = Hin + (size_t)r * c;
    float s = 0.f;
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES)
      s += dot4(load4(a + j), load4(ga + j)) + dot4(load4(h + j), load4(gh + j));
    const float gate = 1.f / (1.f + expf(-row_sum(s)));
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
      const float4 av = load4(a + j), hv = load4(h + j);
      store4(Hout + (size_t)r * c + j,
             float4{av.x * gate + hv.x * (1.f - gate), av.y * gate + hv.y * (1.f - gate),
                    av.z * gate + hv.z * (1.f - gate), av.w * gate + hv.w * (1.f - gate)});
    }
    if (sub == 0) G[r] = gate;
  }
  __syncthreads();
}

// Backward of gate_fwd. On entry DH = dL/dHout; on exit DH = dL/dHin through
// the gate and DA = dL/da.
__device__ inline void gate_bwd(const float* A, const float* Hin, const float* G,
                                const float* __restrict__ ga, const float* __restrict__ gh,
                                float* DH, float* DA, int rows, int c) {
  const int slot = threadIdx.x / ROW_LANES, sub = threadIdx.x % ROW_LANES;
  for (int r = slot; r < rows; r += ROW_SLOTS) {
    const size_t at = (size_t)r * c;
    const float gate = G[r];
    float dg = 0.f;
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
      const float4 av = load4(A + at + j), hv = load4(Hin + at + j);
      dg += dot4(load4(DH + at + j),
                 float4{av.x - hv.x, av.y - hv.y, av.z - hv.z, av.w - hv.w});
    }
    const float ds = row_sum(dg) * gate * (1.f - gate);
    for (int j = 4 * sub; j < c; j += 4 * ROW_LANES) {
      const float4 dd = load4(DH + at + j), a4 = load4(ga + j), h4 = load4(gh + j);
      store4(DA + at + j, float4{dd.x * gate + ds * a4.x, dd.y * gate + ds * a4.y,
                                 dd.z * gate + ds * a4.z, dd.w * gate + ds * a4.w});
      store4(DH + at + j,
             float4{dd.x * (1.f - gate) + ds * h4.x, dd.y * (1.f - gate) + ds * h4.y,
                    dd.z * (1.f - gate) + ds * h4.z, dd.w * (1.f - gate) + ds * h4.w});
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ attention pieces
// A tile holds `chains` chains of n beads: row r = chain * n + bead. The
// attention block works on one *unit* at a time, one chain and a group of its
// heads, whose slices of q, k, v (and of the output gradient in the backward)
// are first copied into shared memory side by side, one row a bead, so that
// the N^2 work reads shared memory and each residual leaves global memory once,
// in whole rows. The pieces below work on such a unit: operands carry their row
// stride (ld*), per-head matrices are [head][i][j] and per-head row vectors
// [head][i] of the unit, X the unit's chain's centred coordinates.

// Largest unit, in floats (100 KB): two blocks still fit an SM.
constexpr long long UNIT_CAP_FLOATS = 25600;

// Floats of a unit of `group` heads: n rows of `mats` slices, and the per-head
// matrices (P, and dS in the backward, where mats is 4).
__host__ __device__ inline long long unit_floats(int n, int group, int dh, int mats) {
  return (long long)n * (mats * group * dh + 4) + (mats - 2) * round4((long long)group * n * n);
}

// Heads of a unit: the largest divisor of `heads` whose backward unit fits; 0
// if one head does not. Must match tile_plan.py::head_group.
__host__ __device__ inline int head_group(int n, int heads, int dh) {
  for (int g = heads; g >= 1; --g)
    if (heads % g == 0 && unit_floats(n, g, dh, 4) <= UNIT_CAP_FLOATS) return g;
  return 0;
}

// Floats of shared memory that the products and the attention units of a tile
// share. Must match tile_plan.py::work_smem_floats.
__host__ __device__ inline long long work_smem_floats(int rows, int n, int heads, int dh) {
  const long long ring = gemm_smem_floats(rows);
  const long long unit = unit_floats(n, head_group(n, heads, dh), dh, 4);
  return ring > unit ? ring : unit;
}

// Starts the copy of rows x width floats (width a multiple of 4, 16-byte
// aligned rows) from global memory (row stride ld_src) to shared memory.
__device__ inline void stage_rows(const float* src, int ld_src, float* dst, int ld_dst, int rows,
                                  int width) {
  const int w4 = width / 4;
  for (int idx = threadIdx.x; idx < rows * w4; idx += NTHREADS) {
    const int r = idx / w4, e = (idx % w4) * 4;
    cp_async16(dst + r * ld_dst + e, src + (size_t)r * ld_src + e);
  }
}

// K[i, e] += xc_i . Kc[:, e] and V likewise over the unit's `width` columns;
// kc points at the unit's first column of Kc, whose rows are ldk apart.
__device__ inline void add_edge_terms(const float* X, const float* __restrict__ kc, int ldk,
                                      float* K, float* V, int ld, int n, int width) {
  const int w4 = width / 4;
  for (int idx = threadIdx.x; idx < n * w4; idx += NTHREADS) {
    const int r = idx / w4, e = (idx % w4) * 4;
    float4 a = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float xc = X[r * 3 + c];
      const float4 kv = load4(kc + c * ldk + e);
      a.x += xc * kv.x; a.y += xc * kv.y; a.z += xc * kv.z; a.w += xc * kv.w;
    }
    float4 kk = load4(K + r * ld + e), vv = load4(V + r * ld + e);
    kk.x += a.x; kk.y += a.y; kk.z += a.z; kk.w += a.w;
    vv.x += a.x; vv.y += a.y; vv.z += a.z; vv.w += a.w;
    store4(K + r * ld + e, kk);
    store4(V + r * ld + e, vv);
  }
  __syncthreads();
}

// |x_i - x_j|^2 from the differences (rows i, j of X).
__device__ inline float sq_dist(const float* X, int i, int j) {
  const float a = X[i * 3] - X[j * 3], b = X[i * 3 + 1] - X[j * 3 + 1],
              c = X[i * 3 + 2] - X[j * 3 + 2];
  return a * a + b * b + c * c;
}

// Out[h][i][j] = sum_d A[i, h dh + d] B[j, h dh + d]
//                [+ coef[h][i] (|x_i - x_j|^2 [- shift[h][i]])];
// a thread forms four neighbouring j of one i, so that a piece of row i read
// once meets four rows of B and the four sums run side by side.
__device__ inline void head_dots(const float* A, int lda, const float* B, int ldb, float* Out,
                                 const float* coef, const float* shift, const float* X, int n,
                                 int heads, int dh) {
  constexpr int JB = 4;
  const int njb = (n + JB - 1) / JB;
  for (int idx = threadIdx.x; idx < heads * n * njb; idx += NTHREADS) {
    const int j0 = (idx % njb) * JB, i = (idx / njb) % n, h = idx / (njb * n);
    const float* a = A + i * lda + h * dh;
    const float* b[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)  // keys past the chain's last bead repeat it, unstored
      b[jj] = B + min(j0 + jj, n - 1) * ldb + h * dh;
    float s[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) s[jj] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < dh; dd += 4) {
      const float4 av = load4(a + dd);
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) s[jj] += dot4(av, load4(b[jj] + dd));
    }
    const int row = h * n + i;
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int jn = j0 + jj;
      if (jn < n) {
        float v = s[jj];
        if (coef) v += coef[row] * (sq_dist(X, i, jn) - (shift ? shift[row] : 0.f));
        Out[row * n + jn] = v;
      }
    }
  }
  __syncthreads();
}

// P = softmax_j(scale * P) over each of the `rows` rows of n, in place.
__device__ inline void softmax_rows(float* P, float scale, int rows, int n) {
  for (int row = threadIdx.x; row < rows; row += NTHREADS) {
    float* p = P + row * n;
    float m = scale * p[0];
    for (int j = 1; j < n; ++j) m = fmaxf(m, scale * p[j]);
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      p[j] = expf(scale * p[j] - m);
      s += p[j];
    }
    const float inv = 1.f / s;
    for (int j = 0; j < n; ++j) p[j] *= inv;
  }
  __syncthreads();
}

// dS = scale * P * (dP - sum_j P dP) over each row, in place in DS (= dP).
__device__ inline void softmax_rows_bwd(const float* P, float* DS, float scale, int rows, int n) {
  for (int row = threadIdx.x; row < rows; row += NTHREADS) {
    const float* p = P + row * n;
    float* ds = DS + row * n;
    float tot = 0.f;
    for (int j = 0; j < n; ++j) tot += p[j] * ds[j];
    for (int j = 0; j < n; ++j) ds[j] = scale * p[j] * (ds[j] - tot);
  }
  __syncthreads();
}

// Out[h][i] = sum_j M[h][i][j] |x_i - x_j|^2.
__device__ inline void rows_times_dist(const float* M, const float* X, float* Out, int n,
                                       int heads) {
  for (int row = threadIdx.x; row < heads * n; row += NTHREADS) {
    const int i = row % n;
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += M[row * n + j] * sq_dist(X, i, j);
    Out[row] = s;
  }
  __syncthreads();
}

// The coordinate gradient through the squared distances. With the gradient
// of d_ij summed over the unit's heads, D_ij = sum_h (g[h][i] P[h][i][j]
// + qs[h][i] dS[h][i][j]):  DX[i, a] += 2 sum_j (D_ij + D_ji) (x_i - x_j)[a].
__device__ inline void dist_bwd(const float* P, const float* DS, const float* g, const float* qs,
                                const float* X, float* DX, int n, int heads) {
  for (int idx = threadIdx.x; idx < n * 3; idx += NTHREADS) {
    const int a = idx % 3, i = idx / 3;
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      float dd = 0.f;
      for (int h = 0; h < heads; ++h) {
        const int ri = h * n + i, rj = h * n + j;
        dd += g[ri] * P[ri * n + j] + qs[ri] * DS[ri * n + j] + g[rj] * P[rj * n + i]
              + qs[rj] * DS[rj * n + i];
      }
      s += dd * (X[i * 3 + a] - X[j * 3 + a]);
    }
    DX[idx] += 2.f * s;
  }
  __syncthreads();
}

// Y[i, e] = sum_j M[h][i][j] Z[j, e] with h = e / dh (transpose_m: M[h][j][i])
// over the unit's heads * dh columns; a thread forms four columns e of four
// rows i, so that a value of Z read once feeds four rows. With kc (the unit's
// first column of Kc, rows ldk apart), Y[i, e] -= xc_i . Kc[:, e]; with kd
// (likewise), Y[i, e] += kd[e] vec[h][i].
__device__ inline void head_mix(const float* M, const float* Z, int ldz, float* Y, int ldy, int n,
                                int heads, int dh, bool transpose_m, const float* X,
                                const float* __restrict__ kc, int ldk,
                                const float* __restrict__ kd, const float* vec) {
  constexpr int IB = 4;
  const int w4 = heads * dh / 4, nib = (n + IB - 1) / IB;
  const float4 zero = {0.f, 0.f, 0.f, 0.f};
  for (int idx = threadIdx.x; idx < nib * w4; idx += NTHREADS) {
    const int e = (idx % w4) * 4, i0 = (idx / w4) * IB, h = e / dh;
    const float* m = M + h * n * n;
    // Rows past the chain's last bead repeat it and are not stored.
    int at[IB];
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) {
      const int i = min(i0 + ii, n - 1);
      at[ii] = transpose_m ? i : i * n;
    }
    const int step = transpose_m ? n : 1;
    float4 s[IB];
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) s[ii] = zero;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 z = load4(Z + j * ldz + e);
#pragma unroll
      for (int ii = 0; ii < IB; ++ii) {
        const float w = m[at[ii] + j * step];
        s[ii].x += w * z.x; s[ii].y += w * z.y; s[ii].z += w * z.z; s[ii].w += w * z.w;
      }
    }
#pragma unroll
    for (int ii = 0; ii < IB; ++ii) {
      const int i = i0 + ii;
      if (i < n) {
        float4 v = s[ii];
        if (kc) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float xa = X[i * 3 + a];
            const float4 kv = load4(kc + a * ldk + e);
            v.x -= xa * kv.x; v.y -= xa * kv.y; v.z -= xa * kv.z; v.w -= xa * kv.w;
          }
        }
        if (kd) {
          const float f = vec[h * n + i];
          const float4 kv = load4(kd + e);
          v.x += f * kv.x; v.y += f * kv.y; v.z += f * kv.z; v.w += f * kv.w;
        }
        store4(Y + (size_t)i * ldy + e, v);
      }
    }
  }
  __syncthreads();
}

// What the attention block of a layer reads and writes, for a tile.
struct Attention {
  int chains, n, heads, dh, rows;  // rows of the tile, those beyond chains * n padding
  int head0 = 0, part_heads = 0;   // this block's heads: head0 on, part_heads of them (0: all)
  float scale;
  const float* x;   // (chains * n, 3) centred coordinates, shared memory
  float* dx;        // their gradient, shared memory
  const float* kc;  // (3, inner) or null: coordinate differences on the edges
  const float* kd;  // (inner) or null: squared distances on the edges
  float* qkv;       // (rows, 3 inner): q | k | v, without the edge terms
  float* p;         // [chain][head][i][j] softmax, a residual
  float* qs;        // [chain][head][i] q_i . kd, a residual (with kd)
  float* fd;        // [chain][head][i] sum_j P_ij d_ij, a residual (with kd)
};

// Sets the rows of Y (ld floats each, `width` of them written) beyond the
// tile's real rows to zero.
__device__ inline void zero_padding_rows(float* Y, int ld, int width, int real, int rows) {
  const int w4 = width / 4;
  const float4 zero = {0.f, 0.f, 0.f, 0.f};
  for (int idx = threadIdx.x; idx < (rows - real) * w4; idx += NTHREADS)
    store4(Y + (size_t)(real + idx / w4) * ld + (idx % w4) * 4, zero);
}

// Forward of the attention block: per head P = softmax_j(scale (q_i . k'_j
// [+ qs_i d_ij])) and U_i = (P v')_i [- xc_i Kc] [+ kd sum_j P_ij d_ij], with
// k' = k + xc Kc and v' likewise where kc is given. U is (rows, inner).
__device__ inline void attention_fwd(const Attention& t, float* U, float* smem) {
  const int n = t.n, I = t.heads * t.dh, I3 = 3 * I;
  const int hb = t.head0, he = t.part_heads ? hb + t.part_heads : t.heads;
  const int G = head_group(n, he - hb, t.dh), W = G * t.dh, ld = 3 * W + 4;
  float *sq = smem, *sk = smem + W, *sv = smem + 2 * W, *sp = smem + n * ld;
  zero_padding_rows(U + hb * t.dh, I, (he - hb) * t.dh, t.chains * n, t.rows);
  for (int c = 0; c < t.chains; ++c) {
    const float* xc = t.x + c * n * 3;
    for (int g0 = hb; g0 < he; g0 += G) {
      const float* src = t.qkv + (size_t)c * n * I3 + g0 * t.dh;
      const int vecs = (c * t.heads + g0) * n;  // the unit's place among [chain][head][i]
      stage_rows(src, I3, sq, ld, n, W);
      stage_rows(src + I, I3, sk, ld, n, W);
      stage_rows(src + 2 * I, I3, sv, ld, n, W);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (t.kc) add_edge_terms(xc, t.kc + g0 * t.dh, I, sk, sv, ld, n, W);
      head_dots(sq, ld, sk, ld, sp, t.kd ? t.qs + vecs : nullptr, nullptr, xc, n, G, t.dh);
      softmax_rows(sp, t.scale, G * n, n);
      if (t.kd) rows_times_dist(sp, xc, t.fd + vecs, n, G);
      for (int i = threadIdx.x; i < G * n * n; i += NTHREADS) t.p[(size_t)vecs * n + i] = sp[i];
      head_mix(sp, sv, ld, U + (size_t)c * n * I + g0 * t.dh, I, n, G, t.dh, false, xc,
               t.kc ? t.kc + g0 * t.dh : nullptr, I, t.kd ? t.kd + g0 * t.dh : nullptr,
               t.kd ? t.fd + vecs : nullptr);
    }
  }
}

// Backward of attention_fwd: from DU = dL/dU (rows, inner) the gradients
// DQKV = dq | dk' | dv' (rows, 3 inner), and the part of dL/dxc that passes
// through the squared distances (into t.dx). g (with kd) is [chain][head][i]
// du_i . kd; dqs is room for as many floats. A block with a share of the
// heads reads and writes only their columns.
__device__ inline void attention_bwd(const Attention& t, const float* DU, float* DQKV,
                                     const float* g, float* dqs, float* smem) {
  const int n = t.n, I = t.heads * t.dh, I3 = 3 * I;
  const int hb = t.head0, he = t.part_heads ? hb + t.part_heads : t.heads;
  const int G = head_group(n, he - hb, t.dh), W = G * t.dh, ld = 4 * W + 4;
  float *sq = smem, *sk = smem + W, *sv = smem + 2 * W, *sdu = smem + 3 * W;
  float *sp = smem + n * ld, *sds = sp + round4((long long)G * n * n);
  if (he - hb == t.heads)
    zero_padding_rows(DQKV, I3, I3, t.chains * n, t.rows);
  else
    for (int part = 0; part < 3; ++part)
      zero_padding_rows(DQKV + part * I + hb * t.dh, I3, (he - hb) * t.dh, t.chains * n, t.rows);
  for (int c = 0; c < t.chains; ++c) {
    const float* xc = t.x + c * n * 3;
    for (int g0 = hb; g0 < he; g0 += G) {
      const float* src = t.qkv + (size_t)c * n * I3 + g0 * t.dh;
      float* dst = DQKV + (size_t)c * n * I3 + g0 * t.dh;
      const int vecs = (c * t.heads + g0) * n;
      stage_rows(src, I3, sq, ld, n, W);
      stage_rows(src + I, I3, sk, ld, n, W);
      stage_rows(src + 2 * I, I3, sv, ld, n, W);
      stage_rows(DU + (size_t)c * n * I + g0 * t.dh, I, sdu, ld, n, W);
      cp_async_commit();
      for (int i = threadIdx.x; i < G * n * n; i += NTHREADS) sp[i] = t.p[(size_t)vecs * n + i];
      cp_async_wait<0>();
      __syncthreads();
      if (t.kc) add_edge_terms(xc, t.kc + g0 * t.dh, I, sk, sv, ld, n, W);
      // dP_ij = du_i . v'_j + g_i d_ij, then through the softmax. The softmax
      // backward ignores what is constant along a row, so g_i (d_ij - fd_i)
      // with fd_i = sum_j P_ij d_ij stands for g_i d_ij: it keeps two large
      // terms from cancelling when the scores are sharp.
      head_dots(sdu, ld, sv, ld, sds, t.kd ? g + vecs : nullptr, t.kd ? t.fd + vecs : nullptr,
                xc, n, G, t.dh);
      softmax_rows_bwd(sp, sds, t.scale, G * n, n);
      // Through S_ij += qs_i d_ij with qs_i = q_i . kd per head:
      // dq_i += kd sum_j dS_ij d_ij.
      if (t.kd) rows_times_dist(sds, xc, dqs + vecs, n, G);
      head_mix(sp, sdu, ld, dst + 2 * I, I3, n, G, t.dh, true, nullptr, nullptr, 0, nullptr,
               nullptr);  // dv' = P^T du
      head_mix(sds, sk, ld, dst, I3, n, G, t.dh, false, nullptr, nullptr, 0,
               t.kd ? t.kd + g0 * t.dh : nullptr, t.kd ? dqs + vecs : nullptr);  // dq = dS k' + ...
      head_mix(sds, sq, ld, dst + I, I3, n, G, t.dh, true, nullptr, nullptr, 0, nullptr,
               nullptr);  // dk' = dS^T q
      // Through the d_ij themselves (in the scores and in the values).
      if (t.kd) dist_bwd(sp, sds, g + vecs, t.qs + vecs, xc, t.dx + c * n * 3, n, G);
    }
  }
}

// DX[r, a] += sign * sum_e (A + B)[r, e] M[a, e] for a < 3 (M is (3, width)): a
// coordinate gradient through a 3-row map. ROW_LANES lanes a row, real rows
// only; width a multiple of 4.
__device__ inline void three_row_bwd(const float* A, int lda, const float* B, int ldb, float sign,
                                     const float* __restrict__ M, float* DX, int real_rows,
                                     int width) {
  const int slot = threadIdx.x / ROW_LANES, sub = threadIdx.x % ROW_LANES;
  // Every lane of a warp takes the same number of turns (the sums are warp-wide).
  const int turns = (real_rows + ROW_SLOTS - 1) / ROW_SLOTS;
  for (int turn = 0; turn < turns; ++turn) {
    const int r = turn * ROW_SLOTS + slot;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    if (r < real_rows) {
#pragma unroll 2
      for (int e = 4 * sub; e < width; e += 4 * ROW_LANES) {
        float4 v = load4(A + (size_t)r * lda + e);
        if (B) {
          const float4 w = load4(B + (size_t)r * ldb + e);
          v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        s0 += dot4(v, load4(M + e));
        s1 += dot4(v, load4(M + width + e));
        s2 += dot4(v, load4(M + 2 * width + e));
      }
    }
    s0 = row_sum(s0);
    s1 = row_sum(s1);
    s2 = row_sum(s2);
    if (sub == 0 && r < real_rows) {
      DX[r * 3] += sign * s0;
      DX[r * 3 + 1] += sign * s1;
      DX[r * 3 + 2] += sign * s2;
    }
  }
  __syncthreads();
}

// Loads the coordinates of `chains` chains starting at chain b0 into xs
// (centred per chain) and sets their gradient dxs to zero; `mean` holds
// 3 * chains floats.
__device__ inline void load_centred(const float* __restrict__ x, long long b0, int chains, int n,
                                    float* xs, float* dxs, float* mean) {
  for (int i = threadIdx.x; i < 3 * n * chains; i += NTHREADS) {
    xs[i] = x[b0 * 3 * n + i];
    dxs[i] = 0.f;
  }
  __syncthreads();
  for (int ca = threadIdx.x; ca < 3 * chains; ca += NTHREADS) {
    const int c = ca / 3, a = ca % 3;
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += xs[(c * n + r) * 3 + a];
    mean[ca] = s / n;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * n * chains; i += NTHREADS)
    xs[i] -= mean[(i / (3 * n)) * 3 + i % 3];
  __syncthreads();
}

}  // namespace tile
