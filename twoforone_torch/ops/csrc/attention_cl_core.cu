// Geometric edge-biased attention core: forward and hand-derived backward.
//
// Replaces: twoforone_tpu/ops/attention_cl_core.py::make_cl_attention_core
// (`fwd_call` with body `_fwd_kernel`, and `bwd_call` with body `_bwd_kernel`).
//
// What it computes, per chain b and head h (scale = dh^-0.5):
//   sim[i,j]   = q_i . k_j + qb_i + qkd_i . (x_j - x_i)
//   attn[i,:]  = softmax_j(scale * sim[i,:])        (row maximum subtracted)
//   out[i,:]   = sum_j attn[i,j] v_j
//   fdiff[i,:] = sum_j attn[i,j] x_j - x_i
// and, given dout and dfd, the gradients dq, dk, dv, dqb, dqkd and dx, the
// last summed over heads. The backward recomputes attn from the saved
// inputs, as the Pallas kernel does.
//
// Layout (row-major, float32): q, k, v, out, dout, dq, dk, dv (B, N, H, dh);
// x, dx (B, N, 3); qb, dqb (B, H, N); qkd, fdiff, dfd, dqkd (B, H, N, 3).
// N <= 32 and dh <= 64 are run-time arguments; any B, any H.
//
// What bounds it on the H100: bytes. Per (chain, head) the forward moves
// 4 (4 N dh + 7 N) bytes for about 4 N^2 dh operations and the backward
// 4 (7 N dh + 11 N) bytes for about 10 N^2 dh: at N = 20, dh = 64 that is
// 0.3 and 0.45 operations per byte, against the card's ~20 FP32 operations
// per byte of device memory. So the design keeps loads in flight all the
// time and keeps the arithmetic short enough to hide behind them:
//
// - A *unit* is one (chain, head): N rows of dh floats of each of q, k, v
//   (and dout), rows heads * dh apart in global memory, and the unit's small
//   vectors. A fixed grid of persistent blocks (as many as the SMs hold)
//   walks over the units; the forward takes units strided over all (chain,
//   head) pairs, the backward whole chains, their heads in order.
// - Each block stages the *next* unit into one half of a double buffer in
//   shared memory with 16-byte cp.async copies (4-byte ones where dh is not
//   a multiple of 4 or a pointer is not 16-byte aligned) while it computes
//   the current unit from the other half, so the copies of one unit fly
//   during the arithmetic of the one before. (A unit's rows are 256 bytes
//   each, heads * dh floats apart: a copy-engine bulk copy per row was slower
//   than cp.async for such rows in the whole-force kernels.)
// - The edge terms ride in the products. A staged row carries four more
//   columns: q'_i = [q_i, qkd_i, 0], k'_j = [k_j, x_j, 0], v'_j = [v_j, x_j, 0]
//   and dout'_i = [dout_i, dfd_i, 0]. Then q'_i . k'_j is sim[i,j] less
//   qb_i - qkd_i . x_i, a constant along row i that the softmax does not see
//   (so the kernel leaves it out); attn v' gives out and fdiff + x_i in one
//   product; dout'_i . v'_j is dL/dattn[i,j]; and the backward's products
//   dsim k', dsim^T q', attn^T dout' give dq with sum_j dsim_ij x_j (hence
//   dqkd), dk with sum_i dsim_ij qkd_i and dv with sum_i attn_ij dfd_i (the
//   two sums of dx). Only the row maximum and sums stay warp reductions.
// - Every product is a float32 register tile on the CUDA cores: a thread
//   forms a 2 x 2 block of sim in the forward and 4 x 4 blocks of sim and
//   dL/dattn in the backward from float4 reads of q and k rows, and the
//   N x dh products two (forward) or four (backward) rows by four columns.
//   A thread's rows are r, r + ceil(N/T), ..., so neighbouring threads read
//   neighbouring rows, and rows are an odd number of 16-byte groups apart in
//   shared memory, so those reads fall in different banks. Four neighbouring
//   lanes share a softmax row, so every row of a unit is done at once with
//   two shuffles a reduction (PERF.md has the times of the other layouts
//   tried: one lane a column, smaller and larger tiles, 256 threads).
// - dx is summed over heads inside the backward: the thread that owns
//   (bead j, component c) keeps the sum in a register while its block walks
//   the chain's heads in order, and writes it once. No atomics anywhere:
//   every sum has a fixed order that depends on neither the grid nor the
//   batch, so a chain gets the same bits alone or inside any batch, and two
//   calls give the same bits.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "tile_gemm.cuh"

namespace {

using tile::cp_async16;
using tile::cp_async_commit;
using tile::cp_async_wait;
using tile::load4;
using tile::store4;

constexpr int MAX_N = 32;   // RL lanes a softmax row: RL N <= NTHREADS
constexpr int MAX_DH = 64;
constexpr int NTHREADS = 128;
constexpr int PS = MAX_N + 4;  // row stride of the N x N tiles
constexpr int FWD_MATS = 3;    // q', k', v'
constexpr int BWD_MATS = 4;    // q', k', v', dout'
// Register tiles: sim (and dL/dattn) tiles of SIM_RI x SIM_RJ, and TR rows
// by four columns in the N x dh products.
constexpr int FWD_SIM_RI = 2, FWD_SIM_RJ = 2, FWD_TR = 2;
constexpr int BWD_SIM_RI = 4, BWD_SIM_RJ = 4, BWD_TR = 4;
constexpr int RL = 4;              // neighbouring lanes that share a softmax row
constexpr int RCOLS = MAX_N / RL;  // columns of that row each of them holds
constexpr unsigned FULL = 0xffffffffu;

// 4 bytes from global to shared memory without passing through registers.
__device__ inline void cp_async4(float* smem_dst, const float* gmem_src) {
#ifdef __CUDA_ARCH__
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
#else
  *smem_dst = *gmem_src;
#endif
}

// Maximum and sum over the RL lanes of a softmax row.
__device__ inline float row_lanes_max(float v) {
#pragma unroll
  for (int o = 1; o < RL; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ inline float row_lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < RL; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ inline void fma4(float& acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ inline void axpy4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__host__ __device__ inline int round4i(int v) { return (v + 3) & ~3; }

// Shared-memory row stride of a staged matrix: dh rounded up to a multiple
// of 4, four columns of edge terms, and up to an odd number of 16-byte groups
// (see the head of the file).
__host__ __device__ inline int row_stride(int dh) { return 4 * ((round4i(dh) / 4 + 1) | 1); }

__host__ __device__ inline int buffer_floats(int n, int dh, int mats) {
  return mats * n * row_stride(dh);
}

// Floats of shared memory: a double buffer of units, the N x N tiles (attn,
// and dsim in the backward), and in the backward the row sums of dsim and one
// head's share of dx.
__host__ __device__ inline long long fwd_smem_floats(int n, int dh) {
  return 2LL * buffer_floats(n, dh, FWD_MATS) + n * PS;
}

__host__ __device__ inline long long bwd_smem_floats(int n, int dh) {
  return 2LL * buffer_floats(n, dh, BWD_MATS) + 2 * n * PS + 4 * n;
}

struct Dims {
  int batch, n, heads, dh;
  int dhp, ld;  // dh rounded up to 4 (where the edge columns start); row stride
  float scale;
  bool vec;     // 16-byte copies and stores
};

// Zeroes the columns that no copy writes, in every matrix of both halves of
// the double buffer: dh .. dhp - 1 and the last edge column.
__device__ inline void zero_pad_columns(float* smem, int mats, const Dims& d) {
  const int pad = d.dhp - d.dh + 1;
  for (int idx = threadIdx.x; idx < 2 * mats * d.n * pad; idx += NTHREADS) {
    const int row = idx / pad, c = idx % pad;
    smem[row * d.ld + (c == pad - 1 ? d.dhp + 3 : d.dh + c)] = 0.f;
  }
}

// Starts the copy of a unit's matrix into shared memory (rows ld apart):
// rows 0..n-1 of dh floats, gs apart in global memory, then the three edge
// values of each row from `edge` (3 a row, contiguous) into columns dhp..dhp+2.
__device__ inline void stage_matrix(const float* src, size_t gs, const float* edge, float* dst,
                                    const Dims& d) {
  const int c4 = d.vec ? d.dh / 4 : d.dh;  // pieces of a row: float4s or floats
  int i = threadIdx.x / c4, c = threadIdx.x % c4;
  const int di = NTHREADS / c4, dc = NTHREADS % c4;
  for (; i < d.n; i += di, c += dc) {
    if (c >= c4) {
      c -= c4;
      if (++i >= d.n) break;
    }
    if (d.vec)
      cp_async16(dst + i * d.ld + 4 * c, src + i * gs + 4 * c);
    else
      cp_async4(dst + i * d.ld + c, src + i * gs + c);
  }
  for (int idx = threadIdx.x; idx < 3 * d.n; idx += NTHREADS)
    cp_async4(dst + (idx / 3) * d.ld + d.dhp + idx % 3, edge + idx);
}

// Offsets of unit (b, h): its first q-like row, and its (b, h) slice of
// the per-head vectors (qb; times 3 for qkd, dfd).
__device__ inline size_t mat_base(const Dims& d, int b, int h) {
  return ((size_t)b * d.n * d.heads + h) * d.dh;
}
__device__ inline size_t head_base(const Dims& d, int b, int h) {
  return ((size_t)b * d.heads + h) * d.n;
}

// Stages unit (b, h) into `buf` as one cp.async group: mats[m] with the edge
// values edges[m] (x: per chain; qkd, dfd: per head).
template <int MATS>
__device__ inline void stage_unit(const Dims& d, int b, int h, float* buf,
                                  const float* const (&mats)[MATS],
                                  const bool (&per_head)[MATS], const float* const (&edges)[MATS]) {
  const size_t base = mat_base(d, b, h), gs = (size_t)d.heads * d.dh;
  const size_t xb = (size_t)b * d.n * 3, hb = head_base(d, b, h) * 3;
#pragma unroll
  for (int m = 0; m < MATS; ++m)
    stage_matrix(mats[m] + base, gs, edges[m] + (per_head[m] ? hb : xb), buf + m * d.n * d.ld, d);
  cp_async_commit();
}

// A thread's TR rows of a register tile: r0, r0 + nq, ..., r0 + (TR-1) nq
// with nq = ceil(n / TR), so that neighbouring threads take neighbouring
// rows. The first `real` of them are rows < n; the others are read as row
// n - 1 and not stored.
template <int TR>
struct Rows {
  int row[TR];
  int real;
  __device__ Rows(int r0, int nq, int n) {
    real = 0;
#pragma unroll
    for (int e = 0; e < TR; ++e) {
      real += r0 + e * nq < n;
      row[e] = min(r0 + e * nq, n - 1);
    }
  }
};

// Tasks of dots<RI, RJ> for n rows: one for each RI x RJ block.
template <int RI, int RJ>
__device__ inline int dot_tasks(int n) {
  return ((n + RI - 1) / RI) * ((n + RJ - 1) / RJ);
}

// Out[i][j] = scale * A_i . B_j over the dhp + 4 staged columns, for the
// RI x RJ block of (i, j) of task t: rows i0 + e ceil(n / RI) of A and
// j0 + f ceil(n / RJ) of B.
template <int RI, int RJ>
__device__ inline void dots(const float* A, const float* B, float* Out, float scale, int t,
                            const Dims& d) {
  const int ni = (d.n + RI - 1) / RI, nj = (d.n + RJ - 1) / RJ, width = d.dhp + 4;
  const Rows<RI> ri(t / nj, ni, d.n);
  const Rows<RJ> rj(t % nj, nj, d.n);
  float acc[RI][RJ] = {};
#pragma unroll 2
  for (int c = 0; c < width; c += 4) {
    float4 a[RI], b[RJ];
#pragma unroll
    for (int e = 0; e < RI; ++e) a[e] = load4(A + ri.row[e] * d.ld + c);
#pragma unroll
    for (int f = 0; f < RJ; ++f) b[f] = load4(B + rj.row[f] * d.ld + c);
#pragma unroll
    for (int e = 0; e < RI; ++e)
#pragma unroll
      for (int f = 0; f < RJ; ++f) fma4(acc[e][f], a[e], b[f]);
  }
#pragma unroll
  for (int e = 0; e < RI; ++e)
#pragma unroll
    for (int f = 0; f < RJ; ++f)
      if (e < ri.real && f < rj.real) Out[ri.row[e] * PS + rj.row[f]] = scale * acc[e][f];
}

// Stores four columns c..c+3 of a row of a (B, N, H, dh) output (those < dh).
__device__ inline void store_row4(float* dst, float4 v, int c, const Dims& d) {
  if (d.vec) {
    store4(dst + c, v);
    return;
  }
  if (c < d.dh) dst[c] = v.x;
  if (c + 1 < d.dh) dst[c + 1] = v.y;
  if (c + 2 < d.dh) dst[c + 2] = v.z;
  if (c + 3 < d.dh) dst[c + 3] = v.w;
}

// attn of row threadIdx.x / RL of P, from sim in P: the RL lanes of a row
// take columns g, g + RL, g + 2 RL, ... (g = threadIdx.x % RL), so all rows of
// a unit are done at once (RL n <= NTHREADS). p[k] is attn at column
// g + RL k (0 beyond n, and everywhere for a row beyond n). Called by whole
// warps, those with a lane below RL n.
__device__ inline void softmax_row(const float* P, int n, float (&p)[RCOLS]) {
  const int r = threadIdx.x / RL, g = threadIdx.x % RL;
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < RCOLS; ++k) {
    const int j = g + RL * k;
    p[k] = r < n && j < n ? P[r * PS + j] : -INFINITY;
    m = fmaxf(m, p[k]);
  }
  m = row_lanes_max(m);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < RCOLS; ++k) {
    p[k] = r < n && g + RL * k < n ? expf(p[k] - m) : 0.f;
    sum += p[k];
  }
  sum = row_lanes_sum(sum);
#pragma unroll
  for (int k = 0; k < RCOLS; ++k) p[k] = r < n ? p[k] / sum : 0.f;
}

__global__ void __launch_bounds__(NTHREADS)
cl_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ x,
                        const float* __restrict__ qkd, float* __restrict__ out,
                        float* __restrict__ fdiff, Dims d) {
  TILE_DYNAMIC_SMEM(smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  const int half = buffer_floats(d.n, d.dh, FWD_MATS);
  float* P = smem + 2 * half;  // (n, PS) sim, then attn
  const int n = d.n, mat = n * d.ld, nq = (n + FWD_TR - 1) / FWD_TR, groups = d.dhp / 4 + 1;
  const int sim_tasks = dot_tasks<FWD_SIM_RI, FWD_SIM_RJ>(n);
  const int warp = threadIdx.x / 32;
  const int units = d.batch * d.heads;
  const float* const mats[FWD_MATS] = {q, k, v};
  const bool per_head[FWD_MATS] = {true, false, false};
  const float* const edges[FWD_MATS] = {qkd, x, x};

  zero_pad_columns(smem, FWD_MATS, d);
  int u = blockIdx.x;
  stage_unit(d, u / d.heads, u % d.heads, smem, mats, per_head, edges);
  for (int it = 0; u < units; ++it, u += gridDim.x) {
    const int b = u / d.heads, h = u % d.heads;
    const float* buf = smem + (it & 1) * half;
    const int next = u + gridDim.x;
    if (next < units) {
      stage_unit(d, next / d.heads, next % d.heads, smem + ((it + 1) & 1) * half, mats, per_head,
                 edges);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float *Q = buf, *K = buf + mat, *V = buf + 2 * mat;

    // sim less its row constants, scaled.
    for (int t = threadIdx.x; t < sim_tasks; t += NTHREADS)
      dots<FWD_SIM_RI, FWD_SIM_RJ>(Q, K, P, d.scale, t, d);
    __syncthreads();

    if (warp * 32 < RL * n) {
      float p[RCOLS];
      softmax_row(P, n, p);
      const int r = threadIdx.x / RL, g = threadIdx.x % RL;
#pragma unroll
      for (int k = 0; k < RCOLS; ++k)
        if (r < n && g + RL * k < n) P[r * PS + g + RL * k] = p[k];
    }
    __syncthreads();

    // out and fdiff = attn v', two rows by four columns a thread.
    const size_t base = mat_base(d, b, h), gs = (size_t)d.heads * d.dh;
    const size_t hb = head_base(d, b, h);
    for (int task = threadIdx.x; task < nq * groups; task += NTHREADS) {
      const int c = (task % groups) * 4;
      const Rows<FWD_TR> rr(task / groups, nq, n);
      float4 o[FWD_TR];
#pragma unroll
      for (int e = 0; e < FWD_TR; ++e) o[e] = float4{0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < n; ++j) {
        const float4 vj = load4(V + j * d.ld + c);
#pragma unroll
        for (int e = 0; e < FWD_TR; ++e) axpy4(o[e], P[rr.row[e] * PS + j], vj);
      }
#pragma unroll
      for (int e = 0; e < FWD_TR; ++e) {
        if (e >= rr.real) continue;
        const int r = rr.row[e];
        if (c < d.dhp) {
          store_row4(out + base + r * gs, o[e], c, d);
        } else {  // the edge columns: sum_j attn_rj x_j
          const float* xr = V + r * d.ld + c;
          float* f = fdiff + (hb + r) * 3;
          f[0] = o[e].x - xr[0];
          f[1] = o[e].y - xr[1];
          f[2] = o[e].z - xr[2];
        }
      }
    }
    __syncthreads();  // the buffer is staged into again two units on
  }
}

// Four blocks an SM: as many as its shared memory holds at trp-cage width, so
// registers are capped at 128 a thread (uncapped, 142 left room for three).
__global__ void __launch_bounds__(NTHREADS, 4)
cl_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ x,
                        const float* __restrict__ qkd, const float* __restrict__ dout,
                        const float* __restrict__ dfd, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dqb, float* __restrict__ dqkd,
                        float* __restrict__ dx, Dims d) {
  TILE_DYNAMIC_SMEM(smem4);
  float* smem = reinterpret_cast<float*>(smem4);
  const int half = buffer_floats(d.n, d.dh, BWD_MATS);
  const int n = d.n, mat = n * d.ld, nq = (n + BWD_TR - 1) / BWD_TR, groups = d.dhp / 4 + 1;
  // Tasks of the sim product on slots 0.., those of the dL/dattn product from
  // the first warp after them, so that no warp mixes the two.
  const int sim_tasks = dot_tasks<BWD_SIM_RI, BWD_SIM_RJ>(n);
  const int second = (sim_tasks + 31) / 32 * 32;
  float* P = smem + 2 * half;  // (n, PS) sim, then attn
  float* DS = P + n * PS;      // (n, PS) dL/dattn, then dsim
  float* SROW = DS + n * PS;   // (n,) sum_j dsim[i, j]
  float* DXH = SROW + n;       // (n, 3) this head's share of dx
  const int warp = threadIdx.x / 32;
  const int heads = d.heads;
  const float* const mats[BWD_MATS] = {q, k, v, dout};
  const bool per_head[BWD_MATS] = {true, false, false, true};
  const float* const edges[BWD_MATS] = {qkd, x, x, dfd};
  // This block's it-th unit: head it % heads of its (it / heads)-th chain.
  auto chain_of = [&](int it) { return (int)blockIdx.x + (it / heads) * (int)gridDim.x; };

  float dx_sum = 0.f;  // thread t < 3n: dx[b, t / 3, t % 3] over the heads so far
  zero_pad_columns(smem, BWD_MATS, d);
  stage_unit(d, blockIdx.x, 0, smem, mats, per_head, edges);
  for (int it = 0; chain_of(it) < d.batch; ++it) {
    const int b = chain_of(it), h = it % heads;
    const float* buf = smem + (it & 1) * half;
    if (chain_of(it + 1) < d.batch) {
      stage_unit(d, chain_of(it + 1), (it + 1) % heads, smem + ((it + 1) & 1) * half, mats,
                 per_head, edges);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float *Q = buf, *K = buf + mat, *V = buf + 2 * mat, *DO = buf + 3 * mat;

    // sim less its row constants, scaled, and dL/dattn = dout'_i . v'_j, by
    // different warps.
    for (int t = threadIdx.x; t < 2 * second; t += NTHREADS) {
      if (t < sim_tasks)
        dots<BWD_SIM_RI, BWD_SIM_RJ>(Q, K, P, d.scale, t, d);
      else if (t >= second && t < second + sim_tasks)
        dots<BWD_SIM_RI, BWD_SIM_RJ>(DO, V, DS, 1.f, t - second, d);
    }
    __syncthreads();

    // attn, dsim and dqb = sum_j dsim_ij, RL lanes a row.
    const size_t hb = head_base(d, b, h);
    if (warp * 32 < RL * n) {
      float p[RCOLS], a[RCOLS];
      softmax_row(P, n, p);
      const int r = threadIdx.x / RL, g = threadIdx.x % RL;
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < RCOLS; ++k) {
        a[k] = r < n && g + RL * k < n ? DS[r * PS + g + RL * k] : 0.f;
        tot = fmaf(p[k], a[k], tot);
      }
      tot = row_lanes_sum(tot);
      float rs = 0.f;
#pragma unroll
      for (int k = 0; k < RCOLS; ++k) {
        a[k] = d.scale * p[k] * (a[k] - tot);  // dsim
        rs += a[k];
      }
      rs = row_lanes_sum(rs);
      if (r < n) {
#pragma unroll
        for (int k = 0; k < RCOLS; ++k) {
          if (g + RL * k < n) {
            P[r * PS + g + RL * k] = p[k];
            DS[r * PS + g + RL * k] = a[k];
          }
        }
        if (g == 0) dqb[hb + r] = SROW[r] = rs;
      }
    }
    __syncthreads();

    // dq' = dsim k', dk' = dsim^T q', dv' = attn^T dout'; four rows by four
    // columns a thread. The edge columns give dqkd and this head's dx:
    // dx_j = sum_i (dsim_ij qkd_i + attn_ij dfd_i) - (sum_j' dsim_jj') qkd_j - dfd_j.
    const size_t base = mat_base(d, b, h), gs = (size_t)d.heads * d.dh;
    for (int task = threadIdx.x; task < nq * groups; task += NTHREADS) {
      const int c = (task % groups) * 4;
      const Rows<BWD_TR> rr(task / groups, nq, n);
      float4 aq[BWD_TR], ak[BWD_TR], av[BWD_TR];
#pragma unroll
      for (int e = 0; e < BWD_TR; ++e) aq[e] = ak[e] = av[e] = float4{0.f, 0.f, 0.f, 0.f};
      for (int m = 0; m < n; ++m) {
        const float4 km = load4(K + m * d.ld + c);
        const float4 qm = load4(Q + m * d.ld + c);
        const float4 om = load4(DO + m * d.ld + c);
#pragma unroll
        for (int e = 0; e < BWD_TR; ++e) {
          axpy4(aq[e], DS[rr.row[e] * PS + m], km);
          axpy4(ak[e], DS[m * PS + rr.row[e]], qm);
          axpy4(av[e], P[m * PS + rr.row[e]], om);
        }
      }
#pragma unroll
      for (int e = 0; e < BWD_TR; ++e) {
        if (e >= rr.real) continue;
        const int r = rr.row[e];
        if (c < d.dhp) {
          const size_t at = base + r * gs;
          store_row4(dq + at, aq[e], c, d);
          store_row4(dk + at, ak[e], c, d);
          store_row4(dv + at, av[e], c, d);
        } else {
          const float* xr = K + r * d.ld + c;    // x_r
          const float* qr = Q + r * d.ld + c;    // qkd_r
          const float* fr = DO + r * d.ld + c;   // dfd_r
          const float rs = SROW[r];
          float* g = dqkd + (hb + r) * 3;
          g[0] = aq[e].x - rs * xr[0];
          g[1] = aq[e].y - rs * xr[1];
          g[2] = aq[e].z - rs * xr[2];
          DXH[3 * r] = (ak[e].x + av[e].x) - rs * qr[0] - fr[0];
          DXH[3 * r + 1] = (ak[e].y + av[e].y) - rs * qr[1] - fr[1];
          DXH[3 * r + 2] = (ak[e].z + av[e].z) - rs * qr[2] - fr[2];
        }
      }
    }
    __syncthreads();  // the buffer is staged into again two units on

    // dx summed over the heads in order; written after the chain's last head.
    // (DXH is written again only after the next unit's first two barriers.)
    if ((int)threadIdx.x < 3 * n) {
      dx_sum = (h == 0 ? 0.f : dx_sum) + DXH[threadIdx.x];
      if (h == heads - 1) dx[(size_t)b * n * 3 + threadIdx.x] = dx_sum;
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Dims of a launch, or false where the kernels do not take them.
bool make_dims(int batch, int n, int heads, int dh, bool vec_ptrs, Dims* d) {
  if (!(n >= 1 && n <= MAX_N && dh >= 1 && dh <= MAX_DH && heads >= 1 && batch >= 0
        && (long long)batch * heads <= INT_MAX))
    return false;
  d->batch = batch;
  d->n = n;
  d->heads = heads;
  d->dh = dh;
  d->dhp = round4i(dh);
  d->ld = row_stride(dh);
  d->scale = (float)(1.0 / std::sqrt((double)dh));
  d->vec = dh % 4 == 0 && vec_ptrs;
  return true;
}

// Blocks of the persistent grid for `units` units: at most as many as the
// card holds at once, and no more than it takes to give every block the same
// number of units as the busiest one. Also allows the kernel its shared memory.
template <class Kernel>
cudaError_t grid_for(Kernel kernel, int smem, int units, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int cap = (per_sm > 0 ? per_sm : 1) * sms;
  const int per_block = (units + cap - 1) / cap;
  *grid = (units + per_block - 1) / per_block;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* cudaGetErrorString_port(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Both launch a persistent grid of as many blocks as the card holds at once
// (fewer for a small batch) on `stream`, allocate nothing and return a
// cudaError_t code (0 on success): a refused launch never runs, so the caller
// must check it. Neither takes qb: it adds a constant to a row of sim, which
// the softmax does not see (dqb, a sum of dsim, is formed all the same).
int cl_attention_fwd_launch(const float* q, const float* k, const float* v, const float* x,
                            const float* qkd, float* out, float* fdiff, int batch, int n,
                            int heads, int dh, void* stream) {
  Dims d;
  if (!make_dims(batch, n, heads, dh, aligned16(q) && aligned16(k) && aligned16(v)
                 && aligned16(out), &d))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int smem = (int)fwd_smem_floats(n, dh) * (int)sizeof(float);
  int grid = 0;
  const cudaError_t err = grid_for(cl_attention_fwd_kernel, smem, batch * heads, &grid);
  if (err != cudaSuccess) return (int)err;
  TILE_LAUNCH(cl_attention_fwd_kernel, grid, NTHREADS, smem, (cudaStream_t)stream, q, k, v, x,
              qkd, out, fdiff, d);
  return (int)cudaGetLastError();
}

int cl_attention_bwd_launch(const float* q, const float* k, const float* v, const float* x,
                            const float* qkd, const float* dout, const float* dfd, float* dq,
                            float* dk, float* dv, float* dqb, float* dqkd, float* dx, int batch,
                            int n, int heads, int dh, void* stream) {
  Dims d;
  const bool vec_ptrs = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)
                        && aligned16(dq) && aligned16(dk) && aligned16(dv);
  if (!make_dims(batch, n, heads, dh, vec_ptrs, &d)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int smem = (int)bwd_smem_floats(n, dh) * (int)sizeof(float);
  int grid = 0;
  const cudaError_t err = grid_for(cl_attention_bwd_kernel, smem, batch, &grid);
  if (err != cudaSuccess) return (int)err;
  TILE_LAUNCH(cl_attention_bwd_kernel, grid, NTHREADS, smem, (cudaStream_t)stream, q, k, v, x,
              qkd, dout, dfd, dq, dk, dv, dqb, dqkd, dx, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
