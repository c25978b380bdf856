// Fused conservative force evaluation of the graph-transformer energy model.
//
// Replaces: twoforone_tpu/ops/fused_score_cl.py::make_fused_force_kernel_cl
// (the chain-lane Pallas kernel, body `kernel`, pallas_call in `call_cl`).
//
// What it computes, per chain b (x: (B, N, 3) row-major):
//   xc = x - mean_beads(x)
//   h  = h0 + t * wt                                          (N, C)
//   per layer:  hl = LN1(h)
//               q = hl Wq + bq,  k' = hl Wk + bk + xc Kc,  v' = hl Wv + bv + xc Kc
//               P_h = softmax_j(scale * q_h k'_h^T),  o_h = P_h v'_h   (per head)
//               a = (o - xc Kc) Wo + bo
//               h = h + g1 (a - h),   g1 = sigmoid(a.ga1 + h.gh1)
//               f = gelu(LN2(h) W1 + b1) W2 + b2
//               h = h + g2 (f - h),   g2 = sigmoid(f.ga2 + h.gh2)
//   E = sum_i h_i . wdec + bdec,    out = -dE/dxc   (no projection afterwards)
// The edge terms enter keys and values through Kc = W_emb W_e; the terms of
// the JAX transcription that are constant along a softmax row (q.b_comb,
// -q K_diff x_i) cancel and are dropped; the value-side bias survives in bo.
// The backward forms input gradients only, in reverse layer order, in the
// same launch; no weight gradient is ever formed.
//
// What bounds it on the H100: operations. About 22 MFLOP per chain per call
// at the chignolin width (N=10, C=64, 3 layers, 8 x 64 heads) against 240
// bytes of coordinates in and out per chain. The residuals the backward needs
// (about 0.26 MB a chain) pass through the block's scratch in global memory:
// 0.5 GB written and read per 1000 chains, half of the operation bound's time
// at the card's memory rate if all of it reached device memory. At a few
// chains (the paper's 100) a call is a chain of dependent phases on each
// block instead: a tile of one chain is 16 rows, and each staged chunk of a
// product, each attention pass and each row-wise piece waits on the one
// before, at a tenth of an SM's rate.
//
// What the design does about it: several chains per tile (tile_gemm.cuh). A
// fixed grid of thread blocks, two to an SM, walks over tiles of T chains;
// the Python wrapper picks T from the chain count (ops/tile_plan.py), so that
// many chains share each pass over the weights and a small batch still
// spreads over all SMs. Where the tiles are fewer than half the resident
// blocks, the plan gives each tile to a thread-block cluster of 2 or 4 blocks
// (the largest that divides the heads and whose clusters the card keeps
// resident at once): they share the tile's scratch, each computes its share
// of every product's output columns and of the heads, and they meet at a
// cluster barrier where one reads what another wrote, so that each chain's
// chain of phases is shorter. No sum is split between blocks: a chain's force
// has the same bits on any cluster size. A tile's T * N rows (padded to a multiple of 16) go
// through every projection as one product, with the weights staged through
// shared memory by asynchronous copies and multiplied in float32 register
// tiles. The three input projections
// are one product against [Wq | Wk | Wv], and their three backward products
// one against the stacked transposes. LayerNorm and the gates run over all
// rows of the tile, eight lanes a row. The attention block takes one chain and
// a group of its heads at a time, copies their slices of q, k, v into shared
// memory and does the N^2 work there. Rows beyond the tile's chains hold zeros
// or values derived from zeros and reach no chain's result, and no sum depends
// on where in a tile a chain sits.

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "tile_gemm.cuh"

namespace {

using namespace tile;

constexpr int MAX_N = 64;

struct Dims {
  int n, c, heads, dh, inner, ff, layers;
  float scale;
};

__host__ __device__ inline long long layer_floats(const Dims& d) {
  const long long C = d.c, I = d.inner, F = d.ff;
  return 2 * C + 3 * C * I + 3 * I + 3 * I + I * C + C + 2 * C + 2 * C + C * F + F + F * C + C
         + 2 * C + 3 * I * C + C * I + F * C + C * F;
}

__host__ __device__ inline long long weight_floats(const Dims& d) {
  return d.layers * layer_floats(d) + (long long)d.n * d.c + 2LL * d.c + 1;
}

// Floats of one per-head matrix set [chain][head][i][j] of a tile.
__host__ __device__ inline long long heads_floats(const Dims& d, int chains) {
  return round4((long long)chains * d.heads * d.n * d.n);
}

// Residuals kept for the backward, per layer, for a tile of `rows` rows.
__host__ __device__ inline long long resid_floats(const Dims& d, int chains, int rows) {
  const long long R = rows, C = d.c, I = d.inner, F = d.ff;
  return 4 * R * C + 3 * R * I + heads_floats(d, chains) + R * F + 2 * R;
}

// Working buffers of one block, beside the residuals.
__host__ __device__ inline long long work_floats(const Dims& d, int rows) {
  const long long R = rows, C = d.c, I = d.inner, F = d.ff;
  return 3 * R * C + 5 * R * I + R * F;
}

// Must match tile_plan.py::plan_tiles (scratch_floats).
__host__ __device__ inline long long block_scratch_floats(const Dims& d, int chains, int rows) {
  return d.layers * resid_floats(d, chains, rows) + work_floats(d, rows);
}

// Must match tile_plan.py::plan_tiles (smem_bytes).
__host__ __device__ inline long long smem_floats(const Dims& d, int chains, int rows) {
  return work_smem_floats(rows, d.n, d.heads, d.dh) + 2 * round4(3LL * chains * d.n)
         + round4(3LL * chains);
}

struct LayerW {
  const float *ln1_g, *ln1_b, *wqkv, *bqkv, *kc, *wo, *bo, *ga1, *gh1;
  const float *ln2_g, *ln2_b, *w1, *b1, *w2, *b2, *ga2, *gh2;
  const float *wqkvT, *woT, *w1T, *w2T;
};

// Must match _LAYER_ORDER in fused_score_cl.py.
__device__ LayerW layer_weights(const float* w, const Dims& d, int l) {
  const long long C = d.c, I = d.inner, F = d.ff;
  const float* p = w + l * layer_floats(d);
  LayerW L;
  L.ln1_g = p; p += C;  L.ln1_b = p; p += C;
  L.wqkv = p; p += 3 * C * I; L.bqkv = p; p += 3 * I;
  L.kc = p; p += 3 * I;
  L.wo = p; p += I * C; L.bo = p; p += C;
  L.ga1 = p; p += C;    L.gh1 = p; p += C;
  L.ln2_g = p; p += C;  L.ln2_b = p; p += C;
  L.w1 = p; p += C * F; L.b1 = p; p += F;
  L.w2 = p; p += F * C; L.b2 = p; p += C;
  L.ga2 = p; p += C;    L.gh2 = p; p += C;
  L.wqkvT = p; p += 3 * I * C;
  L.woT = p; p += C * I; L.w1T = p; p += F * C; L.w2T = p;
  return L;
}

struct Resid {
  float *hin, *qkv, *p, *a, *g1, *hmid, *f1, *f, *g2;
};

__device__ Resid resid(float* base, const Dims& d, int chains, int rows) {
  const long long R = rows, C = d.c, I = d.inner, F = d.ff;
  Resid Rs;
  float* p = base;
  Rs.hin = p; p += R * C;
  Rs.qkv = p; p += 3 * R * I;
  Rs.p = p; p += heads_floats(d, chains);
  Rs.a = p; p += R * C;
  Rs.g1 = p; p += R;
  Rs.hmid = p; p += R * C;
  Rs.f1 = p; p += R * F;
  Rs.f = p; p += R * C;
  Rs.g2 = p;
  return Rs;
}

struct Work {
  float *hl, *t1, *dh, *u, *du, *dqkv, *df1;
};

__device__ Work work(float* base, const Dims& d, int rows) {
  const long long R = rows, C = d.c, I = d.inner;
  Work Wk;
  float* p = base;
  Wk.hl = p; p += R * C;
  Wk.t1 = p; p += R * C;
  Wk.dh = p; p += R * C;
  Wk.u = p; p += R * I;
  Wk.du = p; p += R * I;
  Wk.dqkv = p; p += 3 * R * I;
  Wk.df1 = p;
  return Wk;
}

// The attention block of layer W on a tile of `chains` chains (production
// edges: coordinate differences, no distances), over block part.rank's share
// of the heads.
__device__ Attention attention(const Dims& d, const LayerW& W, const Resid& R, int chains, int rows,
                               const float* xs, float* dxs, const Part& part) {
  Attention t;
  t.chains = chains; t.n = d.n; t.heads = d.heads; t.dh = d.dh; t.rows = rows;
  t.part_heads = d.heads / part.ranks;
  t.head0 = part.rank * t.part_heads;
  t.scale = d.scale;
  t.x = xs; t.dx = dxs;
  t.kc = W.kc; t.kd = nullptr;
  t.qkv = R.qkv; t.p = R.p; t.qs = nullptr; t.fd = nullptr;
  return t;
}

// A tile is shared by the `cluster` blocks of a thread-block cluster (1, 2
// or 4): each takes a share of every product's output columns and of the
// attention's heads, and a contiguous share of the rows in the row-wise
// pieces, and they meet at a cluster barrier (part.sync) wherever one reads
// what another wrote. The coordinate gradient is summed by every block whole,
// in its own shared memory, and block 0 stores the force. At cluster 1 the
// barriers are not taken and the block does all of it.
template <int TM>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_force_cl_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ w, float* scratch, float t, int batch,
                      int tile_chains, int cluster, Dims d) {
  TILE_DYNAMIC_SMEM(smem4);
  constexpr int ROWS = 16 * TM;
  const int n = d.n, C = d.c, I = d.inner, F = d.ff, I3 = 3 * d.inner;
  float* gemm_smem = reinterpret_cast<float*>(smem4);  // the products' ring, the attention's units
  float* xs = gemm_smem + work_smem_floats(ROWS, d.n, d.heads, d.dh);
  float* dxs = xs + round4(3LL * tile_chains * n);
  float* mean = dxs + round4(3LL * tile_chains * n);
  const float* h0 = w + d.layers * layer_floats(d);
  const float* wt = h0 + n * C;
  const float* wdec = wt + C;
  Part part;
  int group = blockIdx.x, groups = gridDim.x;  // the tile-sharing group: a block or a cluster
  if (cluster > 1) {
    part.rank = cluster_rank();
    part.ranks = cluster;
    group = cluster_index();
    groups = cluster_count();
  }
  // This block's rows in the row-wise pieces.
  const int own = ROWS / part.ranks, r0 = part.rank * own;
  const long long per_layer = resid_floats(d, tile_chains, ROWS);
  float* mine = scratch + (size_t)group * block_scratch_floats(d, tile_chains, ROWS);
  const Work Wk = work(mine + d.layers * per_layer, d, ROWS);
  const int tiles = (batch + tile_chains - 1) / tile_chains;

  for (int tile_i = group; tile_i < tiles; tile_i += groups) {
    const long long b0 = (long long)tile_i * tile_chains;
    const int chains = min(tile_chains, (int)(batch - b0));
    const int real = chains * n;
    load_centred(x, b0, chains, n, xs, dxs, mean);
    {
      float* hin = resid(mine, d, tile_chains, ROWS).hin;
      for (int i = r0 * C + threadIdx.x; i < (r0 + own) * C; i += NTHREADS) {
        const int r = i / C, k = i % C;
        hin[i] = r < real ? __ldg(h0 + (r % n) * C + k) + t * __ldg(wt + k) : 0.f;
      }
    }
    __syncthreads();

    // -------------------------------------------------------------- forward
    for (int l = 0; l < d.layers; ++l) {
      const LayerW W = layer_weights(w, d, l);
      const Resid R = resid(mine + l * per_layer, d, tile_chains, ROWS);
      // The last layer's output feeds only the energy, which is not returned.
      float* hnext =
          l + 1 < d.layers ? resid(mine + (l + 1) * per_layer, d, tile_chains, ROWS).hin : Wk.t1;
      const size_t o = (size_t)r0 * C;  // this block's first row in the row-wise pieces
      layer_norm(R.hin + o, Wk.hl + o, W.ln1_g, W.ln1_b, own, C);
      part.sync();
      gemm<TM, false>(Wk.hl, C, W.wqkv, W.bqkv, R.qkv, I3, EPI_STORE, nullptr, gemm_smem, part);
      part.sync();
      attention_fwd(attention(d, W, R, chains, ROWS, xs, dxs, part), Wk.u, gemm_smem);
      part.sync();
      gemm<TM, true>(Wk.u, I, W.wo, W.bo, R.a, C, EPI_STORE, nullptr, gemm_smem, part);
      part.sync();
      gate_fwd(R.a + o, R.hin + o, W.ga1, W.gh1, R.g1 + r0, R.hmid + o, own, C);
      layer_norm(R.hmid + o, Wk.hl + o, W.ln2_g, W.ln2_b, own, C);
      part.sync();
      gemm<TM, false>(Wk.hl, C, W.w1, W.b1, R.f1, F, EPI_STORE_AND_GELU, Wk.df1, gemm_smem, part);
      part.sync();
      gemm<TM, true>(Wk.df1, F, W.w2, W.b2, R.f, C, EPI_STORE, nullptr, gemm_smem, part);
      part.sync();
      gate_fwd(R.f + o, R.hmid + o, W.ga2, W.gh2, R.g2 + r0, hnext + o, own, C);
    }

    // ------------------------------------------------------------- backward
    for (int i = r0 * C + threadIdx.x; i < (r0 + own) * C; i += NTHREADS)
      Wk.dh[i] = __ldg(wdec + i % C);
    __syncthreads();
    for (int l = d.layers - 1; l >= 0; --l) {
      const LayerW W = layer_weights(w, d, l);
      const Resid R = resid(mine + l * per_layer, d, tile_chains, ROWS);
      const size_t o = (size_t)r0 * C;
      // Feed-forward gated residual.
      gate_bwd(R.f + o, R.hmid + o, R.g2 + r0, W.ga2, W.gh2, Wk.dh + o, Wk.t1 + o, own,
               C);  // t1 = df
      part.sync();
      gemm<TM, false>(Wk.t1, C, W.w2T, nullptr, Wk.df1, F, EPI_TIMES_GELU_GRAD, R.f1, gemm_smem,
                      part);  // d (pre-activation)
      part.sync();
      gemm<TM, true>(Wk.df1, F, W.w1T, nullptr, Wk.hl, C, EPI_STORE, nullptr, gemm_smem,
                     part);  // d LN2 out
      part.sync();
      layer_norm_bwd(R.hmid + o, Wk.hl + o, W.ln2_g, Wk.dh + o, own, C);
      // Attention gated residual.
      gate_bwd(R.a + o, R.hin + o, R.g1 + r0, W.ga1, W.gh1, Wk.dh + o, Wk.t1 + o, own,
               C);  // t1 = da
      part.sync();
      // du: this block's columns are its heads' columns, which its attention
      // reads; the coordinate gradient through du reads them all.
      gemm<TM, false>(Wk.t1, C, W.woT, nullptr, Wk.du, I, EPI_STORE, nullptr, gemm_smem, part);
      attention_bwd(attention(d, W, R, chains, ROWS, xs, dxs, part), Wk.du, Wk.dqkv, nullptr,
                    nullptr, gemm_smem);
      part.sync();
      three_row_bwd(Wk.du, I, nullptr, 0, -1.f, W.kc, dxs, real, I);
      const float *dk = Wk.dqkv + I, *dv = Wk.dqkv + 2 * I;
      three_row_bwd(dk, I3, dv, I3, 1.f, W.kc, dxs, real, I);
      gemm<TM, true>(Wk.dqkv, I3, W.wqkvT, nullptr, Wk.hl, C, EPI_STORE, nullptr, gemm_smem,
                     part);
      part.sync();
      layer_norm_bwd(R.hin + o, Wk.hl + o, W.ln1_g, Wk.dh + o, own, C);
    }
    if (part.rank == 0)
      for (int i = threadIdx.x; i < 3 * real; i += NTHREADS) out[b0 * 3 * n + i] = -dxs[i];
    __syncthreads();
  }
}

Dims make_dims(int n, int c, int heads, int dh, int ff, int layers) {
  Dims d;
  d.n = n; d.c = c; d.heads = heads; d.dh = dh; d.inner = heads * dh; d.ff = ff;
  d.layers = layers;
  d.scale = (float)(1.0 / std::sqrt((double)dh));
  return d;
}

bool plan_ok(const Dims& d, int batch, int tile_chains, int row_blocks, int blocks, int cluster) {
  const int tiles = (batch + tile_chains - 1) / tile_chains;
  return d.n >= 1 && d.n <= MAX_N && d.c >= 4 && d.heads >= 1 && d.dh >= 4 && d.ff >= 4
         && d.layers >= 1 && d.c % 4 == 0 && d.dh % 4 == 0 && d.ff % 4 == 0 && batch >= 1
         && tile_chains >= 1 && row_blocks >= 1 && row_blocks <= MAX_TM
         && tile_chains * d.n <= 16 * row_blocks && head_group(d.n, d.heads, d.dh) >= 1
         && (cluster == 1 || cluster == 2 || cluster == 4) && d.heads % cluster == 0
         && blocks >= 1 && blocks % cluster == 0 && blocks / cluster <= tiles;
}

template <int TM>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(fused_force_cl_kernel<TM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Clusters of `cluster` blocks of 16 * TM rows that the current card keeps
// resident at once, asked once for each (card, TM, cluster, smem).
template <int TM>
cudaError_t resident_clusters(int cluster, size_t smem, int* count) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, size_t>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, cluster, smem);
  std::lock_guard<std::mutex> hold(lock);
  const auto it = known.find(key);
  if (it != known.end()) {
    *count = it->second;
    return cudaSuccess;
  }
  err = set_smem<TM>(smem);
  if (err == cudaSuccess)
    err = TILE_MAX_ACTIVE_CLUSTERS(count, fused_force_cl_kernel<TM>, cluster, NTHREADS, smem);
  if (err == cudaSuccess) known[key] = *count;
  return err;
}

template <int TM>
cudaError_t launch(const float* x, float* out, const float* w, float* scratch, float t, int batch,
                   int tile_chains, int blocks, int cluster, size_t smem, const Dims& d,
                   cudaStream_t stream) {
  cudaError_t err = set_smem<TM>(smem);
  if (err != cudaSuccess) return err;
  if (cluster == 1) {
    TILE_LAUNCH(fused_force_cl_kernel<TM>, blocks, NTHREADS, smem, stream, x, out, w, scratch, t,
                batch, tile_chains, cluster, d);
    return cudaGetLastError();
  }
  // Every cluster of the launch must be resident at once.
  int resident = 0;
  err = resident_clusters<TM>(cluster, smem, &resident);
  if (err != cudaSuccess) return err;
  if (blocks / cluster > resident) return cudaErrorInvalidValue;
  err = TILE_LAUNCH_CLUSTER(fused_force_cl_kernel<TM>, blocks, cluster, NTHREADS, smem, stream, x,
                            out, w, scratch, t, batch, tile_chains, cluster, d);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class F>
cudaError_t by_rows(int row_blocks, F f) {
  switch (row_blocks) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 5>());
  }
}

}  // namespace

extern "C" {

long long fused_force_cl_weight_floats(int n, int c, int heads, int dh, int ff, int layers) {
  return weight_floats(make_dims(n, c, heads, dh, ff, layers));
}

// Scratch floats of ONE tile in flight (one thread block, or the blocks of
// one cluster, which share it) whose tiles hold `tile_chains` chains in
// 16 * row_blocks rows.
long long fused_force_cl_scratch_floats(int n, int c, int heads, int dh, int ff, int layers,
                                        int tile_chains, int row_blocks) {
  return block_scratch_floats(make_dims(n, c, heads, dh, ff, layers), tile_chains,
                              16 * row_blocks);
}

long long fused_force_cl_smem_bytes(int n, int c, int heads, int dh, int ff, int layers,
                                    int tile_chains, int row_blocks) {
  return 4 * smem_floats(make_dims(n, c, heads, dh, ff, layers), tile_chains, 16 * row_blocks);
}

// Clusters of `cluster` blocks (16 * row_blocks rows, smem_bytes of shared
// memory each) that the current card keeps resident at once; a negative
// cudaError_t code if the card cannot say.
int fused_force_cl_resident_clusters(int row_blocks, int cluster, int smem_bytes) {
  if (row_blocks < 1 || row_blocks > MAX_TM || cluster < 1) return -(int)cudaErrorInvalidValue;
  int count = 0;
  const cudaError_t err = by_rows(row_blocks, [&](auto tm) {
    return resident_clusters<decltype(tm)::value>(cluster, (size_t)smem_bytes, &count);
  });
  return err == cudaSuccess ? count : -(int)err;
}

const char* cudaGetErrorString_port(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches `blocks` thread blocks, in clusters of `cluster` (1, 2 or 4) that
// share a tile, that walk over the tiles of `tile_chains` chains (16 *
// row_blocks rows each) on `stream`; `scratch` holds blocks / cluster *
// scratch_floats floats. The plan (tile_chains, row_blocks, blocks, cluster,
// scratch_floats, smem_bytes) comes from the caller and is held against this
// file's own formulas, and a clustered launch against the card's count of
// resident clusters. Returns a cudaError_t code (0 on success): a refused
// launch never runs, so the caller must check it.
int fused_force_cl_launch(const float* x, float* out, const float* w, float* scratch, float t,
                          int batch, int tile_chains, int row_blocks, int blocks, int cluster,
                          long long scratch_floats, int smem_bytes, int n, int c, int heads,
                          int dh, int ff, int layers, void* stream) {
  const Dims d = make_dims(n, c, heads, dh, ff, layers);
  if (!plan_ok(d, batch, tile_chains, row_blocks, blocks, cluster)
      || scratch_floats != block_scratch_floats(d, tile_chains, 16 * row_blocks)
      || smem_bytes != 4 * smem_floats(d, tile_chains, 16 * row_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  return (int)by_rows(row_blocks, [&](auto tm) {
    return launch<decltype(tm)::value>(x, out, w, scratch, t, batch, tile_chains, blocks, cluster,
                                       smem, d, s);
  });
}

}  // extern "C"
