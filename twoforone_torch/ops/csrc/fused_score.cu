// Fused conservative force evaluation of the graph-transformer energy model,
// for every edge configuration.
//
// Replaces: twoforone_tpu/ops/fused_score.py::make_fused_force_kernel
// (the head-packed Pallas kernel, body `kernel`, pallas_call in `call`).
//
// What it computes, per chain (x: (B, N, 3) row-major), with the flags
// `intrinsic` (coordinate differences on the edges), `distances` (squared
// distances on the edges) and `abs_coords` (coordinates in the node features):
//   xc = x - mean_beads(x),  d_ij = |xc_i - xc_j|^2
//   h  = h0 + t * wt [+ xc Wx]                                          (N, C)
//   per layer:  hl = LN1(h);  q = hl Wq + bq
//               k' = hl Wk + bk [+ xc Kc],  v' = hl Wv + bv [+ xc Kc]
//               per head: S_ij = q_i . k'_j [+ (q_i . kd) d_ij]
//                         P = softmax_j(scale * S)
//                         u_i = (P v')_i [- xc_i Kc] [+ kd sum_j P_ij d_ij]
//               a = u Wo + bo
//               h = h + g1 (a - h),   g1 = sigmoid(a.ga1 + h.gh1)
//               f = gelu(LN2(h) W1 + b1) W2 + b2
//               h = h + g2 (f - h),   g2 = sigmoid(f.ga2 + h.gh2)
//   E = sum_i h_i . wdec + bdec,    out = -dE/dxc   (no projection afterwards)
// Kc (3, inner) and kd (inner) are the rows of W_emb W_e for the difference
// and the distance channels. This is softmax(scale * q.(k + e_ij)) and
// sum_j P_ij (v_j + e_ij) for the edge e_ij = bc + (xc_j - xc_i) Kc + d_ij kd:
// the score terms that are constant along a softmax row (q.bc, -q Kc xc_i)
// cancel and are dropped; the value-side bias survives in bo = bc Wo + b_out.
// Squared distances are formed from coordinate differences, never as
// |xc_i|^2 + |xc_j|^2 - 2 xc_i . xc_j, which cancels in f32. The backward forms
// input gradients only, written out by hand in reverse layer order in the
// same launch; no weight gradient is ever formed.
//
// What bounds it on the H100: operations. About 22 MFLOP per chain per call
// at the chignolin width (N=10, C=64, 3 layers, 8 x 64 heads) against 240
// bytes of coordinates in and out per chain. The residuals the backward needs
// (about 0.26 MB a chain at that width) pass through the block's scratch in
// global memory.
//
// What the design does about it: the tile core of tile_gemm.cuh, as in
// fused_score_cl.cu. A fixed grid of thread blocks, two to an SM, walks over
// tiles of T chains (ops/tile_plan.py picks T from the chain count); a tile's
// T * N rows, padded to a multiple of 16, go through every projection as one
// product with the weights staged through shared memory by asynchronous
// copies and multiplied in float32 register tiles. Activations, residuals and gradients live in the block's
// global scratch, so the bead count is not tied to the shared memory of an SM.
// The attention block takes one chain and a group of its heads at a time,
// copies their slices of q, k, v into shared memory and does the N^2 work
// there; the edge flags are kernel arguments. Rows beyond the tile's chains
// hold zeros or values derived from zeros and reach no chain's result, and no
// sum depends on where in a tile a chain sits.

#include "tile_gemm.cuh"

namespace {

using namespace tile;

constexpr int MAX_N = 64;

struct Dims {
  int n, c, heads, dh, inner, ff, layers;
  int intrinsic, distances, abs_coords;
  float scale;
};

__host__ __device__ inline long long layer_floats(const Dims& d) {
  const long long C = d.c, I = d.inner, F = d.ff;
  return 2 * C + 3 * C * I + 3 * I + (d.intrinsic ? 3 * I : 0) + (d.distances ? I : 0) + I * C + C
         + 2 * C + 2 * C + C * F + F + F * C + C + 2 * C + 3 * I * C + C * I + F * C + C * F;
}

__host__ __device__ inline long long weight_floats(const Dims& d) {
  return d.layers * layer_floats(d) + (long long)d.n * d.c + (d.abs_coords ? 3LL * d.c : 0)
         + 2LL * d.c + 1;
}

// Floats of one per-head matrix set [chain][head][i][j] of a tile.
__host__ __device__ inline long long heads_floats(const Dims& d, int chains) {
  return round4((long long)chains * d.heads * d.n * d.n);
}

// Floats of one per-head row vector set [chain][head][i] of a tile.
__host__ __device__ inline long long head_rows_floats(const Dims& d, int chains) {
  return round4((long long)chains * d.heads * d.n);
}

// Residuals kept for the backward, per layer, for a tile of `rows` rows.
__host__ __device__ inline long long resid_floats(const Dims& d, int chains, int rows) {
  const long long R = rows, C = d.c, I = d.inner, F = d.ff;
  return 4 * R * C + 3 * R * I + heads_floats(d, chains) + R * F + 2 * R
         + (d.distances ? 2 * head_rows_floats(d, chains) : 0);
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
         + round4(3LL * chains)
         + (d.distances ? 2 * head_rows_floats(d, chains) : 0);
}

struct LayerW {
  const float *ln1_g, *ln1_b, *wqkv, *bqkv, *kc, *kd, *wo, *bo, *ga1, *gh1;
  const float *ln2_g, *ln2_b, *w1, *b1, *w2, *b2, *ga2, *gh2;
  const float *wqkvT, *woT, *w1T, *w2T;
};

// Must match layer_order() in fused_score.py.
__device__ LayerW layer_weights(const float* w, const Dims& d, int l) {
  const long long C = d.c, I = d.inner, F = d.ff;
  const float* p = w + l * layer_floats(d);
  LayerW L;
  L.ln1_g = p; p += C;  L.ln1_b = p; p += C;
  L.wqkv = p; p += 3 * C * I; L.bqkv = p; p += 3 * I;
  L.kc = nullptr; L.kd = nullptr;
  if (d.intrinsic) { L.kc = p; p += 3 * I; }
  if (d.distances) { L.kd = p; p += I; }
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
  float *hin, *qkv, *p, *a, *g1, *hmid, *f1, *f, *g2, *qs, *fd;
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
  Rs.g2 = p; p += R;
  Rs.qs = p; p += d.distances ? head_rows_floats(d, chains) : 0;
  Rs.fd = p;
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

// Out[c][h][i] = sum_d A[c n + i, h dh + d] kd[h dh + d]. One warp per (c, h, i).
__device__ void head_vec(const float* A, int lda, const float* __restrict__ kd, float* Out,
                         int chains, int n, int heads, int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < chains * heads * n; row += NWARPS) {
    const int i = row % n, h = (row / n) % heads, c = row / (n * heads);
    float s = 0.f;
    for (int dd = lane; dd < dh; dd += 32)
      s += A[(size_t)(c * n + i) * lda + h * dh + dd] * __ldg(kd + h * dh + dd);
    s = warp_sum(s);
    if (lane == 0) Out[row] = s;
  }
  __syncthreads();
}

// The attention block of layer W on a tile of `chains` chains.
__device__ Attention attention(const Dims& d, const LayerW& W, const Resid& R, int chains, int rows,
                               const float* xs, float* dxs) {
  Attention t;
  t.chains = chains; t.n = d.n; t.heads = d.heads; t.dh = d.dh; t.rows = rows;
  t.scale = d.scale;
  t.x = xs; t.dx = dxs;
  t.kc = W.kc; t.kd = W.kd;
  t.qkv = R.qkv; t.p = R.p; t.qs = R.qs; t.fd = R.fd;
  return t;
}

template <int TM>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_force_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ w, float* scratch, float t, int batch,
                   int tile_chains, Dims d) {
  TILE_DYNAMIC_SMEM(smem4);
  constexpr int ROWS = 16 * TM;
  const int n = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads, I3 = 3 * d.inner;
  float* gemm_smem = reinterpret_cast<float*>(smem4);  // the products' ring, the attention's units
  float* xs = gemm_smem + work_smem_floats(ROWS, d.n, d.heads, d.dh);
  float* dxs = xs + round4(3LL * tile_chains * n);
  float* mean = dxs + round4(3LL * tile_chains * n);
  float* sg = mean + round4(3LL * tile_chains);        // with distances only
  float* sdqs = sg + head_rows_floats(d, tile_chains);  // with distances only
  const float* h0 = w + d.layers * layer_floats(d);
  const float* wx = d.abs_coords ? h0 + n * C : nullptr;
  const float* wt = h0 + n * C + (d.abs_coords ? 3 * C : 0);
  const float* wdec = wt + C;
  const long long per_layer = resid_floats(d, tile_chains, ROWS);
  float* mine = scratch + (size_t)blockIdx.x * block_scratch_floats(d, tile_chains, ROWS);
  const Work Wk = work(mine + d.layers * per_layer, d, ROWS);
  const int tiles = (batch + tile_chains - 1) / tile_chains;

  for (int tile_i = blockIdx.x; tile_i < tiles; tile_i += gridDim.x) {
    const long long b0 = (long long)tile_i * tile_chains;
    const int chains = min(tile_chains, (int)(batch - b0));
    const int real = chains * n;
    load_centred(x, b0, chains, n, xs, dxs, mean);
    {
      float* hin = resid(mine, d, tile_chains, ROWS).hin;
      for (int i = threadIdx.x; i < ROWS * C; i += NTHREADS) {
        const int r = i / C, k = i % C;
        float v = 0.f;
        if (r < real) {
          v = __ldg(h0 + (r % n) * C + k) + t * __ldg(wt + k);
          if (wx)
            v += xs[r * 3] * __ldg(wx + k) + xs[r * 3 + 1] * __ldg(wx + C + k)
                 + xs[r * 3 + 2] * __ldg(wx + 2 * C + k);
        }
        hin[i] = v;
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
      layer_norm(R.hin, Wk.hl, W.ln1_g, W.ln1_b, ROWS, C);
      gemm<TM, false>(Wk.hl, C, W.wqkv, W.bqkv, R.qkv, I3, EPI_STORE, nullptr, gemm_smem);
      if (W.kd) head_vec(R.qkv, I3, W.kd, R.qs, chains, n, H, d.dh);
      attention_fwd(attention(d, W, R, chains, ROWS, xs, dxs), Wk.u, gemm_smem);
      gemm<TM, true>(Wk.u, I, W.wo, W.bo, R.a, C, EPI_STORE, nullptr, gemm_smem);
      gate_fwd(R.a, R.hin, W.ga1, W.gh1, R.g1, R.hmid, ROWS, C);
      layer_norm(R.hmid, Wk.hl, W.ln2_g, W.ln2_b, ROWS, C);
      gemm<TM, false>(Wk.hl, C, W.w1, W.b1, R.f1, F, EPI_STORE_AND_GELU, Wk.df1, gemm_smem);
      gemm<TM, true>(Wk.df1, F, W.w2, W.b2, R.f, C, EPI_STORE, nullptr, gemm_smem);
      gate_fwd(R.f, R.hmid, W.ga2, W.gh2, R.g2, hnext, ROWS, C);
    }

    // ------------------------------------------------------------- backward
    for (int i = threadIdx.x; i < ROWS * C; i += NTHREADS) Wk.dh[i] = __ldg(wdec + i % C);
    __syncthreads();
    for (int l = d.layers - 1; l >= 0; --l) {
      const LayerW W = layer_weights(w, d, l);
      const Resid R = resid(mine + l * per_layer, d, tile_chains, ROWS);
      const float *dk = Wk.dqkv + I, *dv = Wk.dqkv + 2 * I;
      // Feed-forward gated residual.
      gate_bwd(R.f, R.hmid, R.g2, W.ga2, W.gh2, Wk.dh, Wk.t1, ROWS, C);  // t1 = df
      gemm<TM, false>(Wk.t1, C, W.w2T, nullptr, Wk.df1, F, EPI_TIMES_GELU_GRAD, R.f1,
                      gemm_smem);  // d (pre-activation)
      gemm<TM, true>(Wk.df1, F, W.w1T, nullptr, Wk.hl, C, EPI_STORE, nullptr,
                     gemm_smem);  // d LN2 out
      layer_norm_bwd(R.hmid, Wk.hl, W.ln2_g, Wk.dh, ROWS, C);
      // Attention gated residual.
      gate_bwd(R.a, R.hin, R.g1, W.ga1, W.gh1, Wk.dh, Wk.t1, ROWS, C);  // t1 = da
      gemm<TM, false>(Wk.t1, C, W.woT, nullptr, Wk.du, I, EPI_STORE, nullptr, gemm_smem);
      if (W.kc) three_row_bwd(Wk.du, I, nullptr, 0, -1.f, W.kc, dxs, real, I);
      // Through kd sum_j P_ij d_ij: g_i = du_i . kd per head.
      if (W.kd) head_vec(Wk.du, I, W.kd, sg, chains, n, H, d.dh);
      attention_bwd(attention(d, W, R, chains, ROWS, xs, dxs), Wk.du, Wk.dqkv, sg, sdqs,
                    gemm_smem);
      if (W.kc) three_row_bwd(dk, I3, dv, I3, 1.f, W.kc, dxs, real, I);
      gemm<TM, true>(Wk.dqkv, I3, W.wqkvT, nullptr, Wk.hl, C, EPI_STORE, nullptr, gemm_smem);
      layer_norm_bwd(R.hin, Wk.hl, W.ln1_g, Wk.dh, ROWS, C);
    }
    if (wx) three_row_bwd(Wk.dh, C, nullptr, 0, 1.f, wx, dxs, real, C);  // h = ... + xc Wx
    for (int i = threadIdx.x; i < 3 * real; i += NTHREADS) out[b0 * 3 * n + i] = -dxs[i];
    __syncthreads();
  }
}

Dims make_dims(int n, int c, int heads, int dh, int ff, int layers, int intrinsic, int distances,
               int abs_coords) {
  Dims d;
  d.n = n; d.c = c; d.heads = heads; d.dh = dh; d.inner = heads * dh; d.ff = ff;
  d.layers = layers;
  d.intrinsic = intrinsic; d.distances = distances; d.abs_coords = abs_coords;
  d.scale = (float)(1.0 / std::sqrt((double)dh));
  return d;
}

bool plan_ok(const Dims& d, int batch, int tile_chains, int row_blocks, int blocks) {
  return d.n >= 1 && d.n <= MAX_N && d.c >= 4 && d.heads >= 1 && d.dh >= 4 && d.ff >= 4
         && d.layers >= 1 && d.c % 4 == 0 && d.dh % 4 == 0 && d.ff % 4 == 0 && batch >= 1
         && tile_chains >= 1 && row_blocks >= 1 && row_blocks <= MAX_TM
         && tile_chains * d.n <= 16 * row_blocks && head_group(d.n, d.heads, d.dh) >= 1
         && blocks >= 1
         && blocks <= (batch + tile_chains - 1) / tile_chains;
}

template <int TM>
cudaError_t launch(const float* x, float* out, const float* w, float* scratch, float t, int batch,
                   int tile_chains, int blocks, size_t smem, const Dims& d, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_force_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  TILE_LAUNCH(fused_force_kernel<TM>, blocks, NTHREADS, smem, stream, x, out, w, scratch, t,
              batch, tile_chains, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

long long fused_force_weight_floats(int n, int c, int heads, int dh, int ff, int layers,
                                    int intrinsic, int distances, int abs_coords) {
  return weight_floats(make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords));
}

// Scratch floats of ONE thread block whose tiles hold `tile_chains` chains in
// 16 * row_blocks rows.
long long fused_force_scratch_floats(int n, int c, int heads, int dh, int ff, int layers,
                                     int intrinsic, int distances, int abs_coords,
                                     int tile_chains, int row_blocks) {
  return block_scratch_floats(
      make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords), tile_chains,
      16 * row_blocks);
}

long long fused_force_smem_bytes(int n, int c, int heads, int dh, int ff, int layers,
                                 int intrinsic, int distances, int abs_coords, int tile_chains,
                                 int row_blocks) {
  return 4 * smem_floats(make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords),
                         tile_chains, 16 * row_blocks);
}

const char* fused_force_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches `blocks` thread blocks that walk over the tiles of `tile_chains`
// chains (16 * row_blocks rows each) on `stream`; `scratch` holds blocks *
// scratch_floats floats. The plan (tile_chains, row_blocks, blocks,
// scratch_floats, smem_bytes) comes from the caller and is held against this
// file's own formulas. Returns a cudaError_t code (0 on success): a refused
// launch never runs, so the caller must check it.
int fused_force_launch(const float* x, float* out, const float* w, float* scratch, float t,
                       int batch, int tile_chains, int row_blocks, int blocks,
                       long long scratch_floats, int smem_bytes, int n, int c, int heads, int dh,
                       int ff, int layers, int intrinsic, int distances, int abs_coords,
                       void* stream) {
  const Dims d = make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords);
  if (!plan_ok(d, batch, tile_chains, row_blocks, blocks)
      || scratch_floats != block_scratch_floats(d, tile_chains, 16 * row_blocks)
      || smem_bytes != 4 * smem_floats(d, tile_chains, 16 * row_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  switch (row_blocks) {
    case 1: return (int)launch<1>(x, out, w, scratch, t, batch, tile_chains, blocks, smem, d, s);
    case 2: return (int)launch<2>(x, out, w, scratch, t, batch, tile_chains, blocks, smem, d, s);
    case 3: return (int)launch<3>(x, out, w, scratch, t, batch, tile_chains, blocks, smem, d, s);
    case 4: return (int)launch<4>(x, out, w, scratch, t, batch, tile_chains, blocks, smem, d, s);
    default: return (int)launch<5>(x, out, w, scratch, t, batch, tile_chains, blocks, smem, d, s);
  }
}

}  // extern "C"
