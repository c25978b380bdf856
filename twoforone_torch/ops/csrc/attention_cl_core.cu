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
// and, given dout and dfd, the gradients dq, dk, dv, dqb, dqkd and this
// head's share of dx (the caller sums the shares over heads). The backward
// recomputes attn row by row from the saved inputs, as the Pallas kernel does.
//
// Layout (row-major, float32): q, k, v, out, dout, dq, dk, dv (B, N, H, dh);
// x (B, N, 3); qb, dqb (B, H, N); qkd, fdiff, dfd, dqkd, dxh (B, H, N, 3).
// N <= 32 and dh <= 64 are run-time arguments; any B, any H.
//
// What bounds it on the H100: bytes. Per (chain, head) the forward moves
// 4 (4 N dh + 10 N) bytes for 4 N^2 dh + 12 N^2 operations and the backward
// 4 (7 N dh + 17 N) bytes for about 10 N^2 dh operations: at N = 20, dh = 64
// that is 0.3 and 0.45 operations per byte, far below the card's ~20 FP32
// operations per byte of device memory.
//
// What the design does about it: one thread block per (chain, head) reads
// each input once into shared memory (under 48 KB at the largest shape) and
// writes each output once. One warp takes an attention row, one lane per key
// bead, so the softmax is two warp shuffles; keys and values are stored with
// a row stride of dh + 1 so that the lanes of a row product hit different
// banks. The backward keeps attn and dsim (N x N each) in shared memory and
// forms dk, dv and dx in a second pass, one thread per output element
// looping over rows: no atomics anywhere, so results repeat bit for bit.
// Several chains per block, tensor cores and fusing the q-side projections
// are left for later work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int MAX_N = 32;   // one lane per key bead
constexpr int MAX_DH = 64;  // keeps the backward's shared memory under 48 KB
constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;
constexpr int PSTRIDE = MAX_N + 1;  // row stride of the attn and dsim tiles
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// attn[i, lane] for one row i, computed by a whole warp (0 for lanes >= n).
// qi: the query row (dh); sk: keys, row stride dh + 1; sx: (n, 3).
__device__ inline float attn_row(const float* qi, const float* sk, const float* sx,
                                 float qb_i, const float* qkd_i, const float* xi,
                                 int n, int dh, float scale, int lane) {
  float s = -INFINITY;
  if (lane < n) {
    const float* kj = sk + lane * (dh + 1);
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qi[d], kj[d], acc);
    acc += qb_i;
    for (int c = 0; c < 3; ++c) acc = fmaf(qkd_i[c], sx[lane * 3 + c] - xi[c], acc);
    s = scale * acc;
  }
  const float m = warp_max(s);
  const float e = lane < n ? expf(s - m) : 0.f;
  return e / warp_sum(e);
}

__host__ __device__ inline int fwd_smem_floats(int n, int dh) {
  return 2 * n * dh + n * (dh + 1) + 3 * n + (FWD_THREADS / 32) * 32;
}

__host__ __device__ inline int bwd_smem_floats(int n, int dh) {
  return 2 * n * dh + 2 * n * (dh + 1) + 10 * n + 2 * n * PSTRIDE;
}

__global__ void __launch_bounds__(FWD_THREADS)
cl_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ x,
                        const float* __restrict__ qb, const float* __restrict__ qkd,
                        float* __restrict__ out, float* __restrict__ fdiff,
                        int n, int heads, int dh, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;                  // (n, dh)
  float* sv = sq + n * dh;           // (n, dh)
  float* sk = sv + n * dh;           // (n, dh + 1)
  float* sx = sk + n * (dh + 1);     // (n, 3)
  float* sp = sx + 3 * n;            // one attn row per warp
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = (size_t)heads * dh;           // between beads of q/k/v
  const size_t base = ((size_t)b * n * heads + h) * dh;   // (b, 0, h, 0)
  const size_t bh = ((size_t)b * heads + h) * n;          // (b, h, 0) of the small arrays

  for (int idx = threadIdx.x; idx < n * dh; idx += FWD_THREADS) {
    const int i = idx / dh, d = idx % dh;
    const size_t g = base + i * row_stride + d;
    sq[idx] = q[g];
    sv[idx] = v[g];
    sk[i * (dh + 1) + d] = k[g];
  }
  for (int idx = threadIdx.x; idx < 3 * n; idx += FWD_THREADS)
    sx[idx] = x[(size_t)b * n * 3 + idx];
  __syncthreads();

  float* prow = sp + warp * 32;
  for (int i = warp; i < n; i += FWD_THREADS / 32) {
    const float qkd_i[3] = {qkd[(bh + i) * 3], qkd[(bh + i) * 3 + 1], qkd[(bh + i) * 3 + 2]};
    const float xi[3] = {sx[i * 3], sx[i * 3 + 1], sx[i * 3 + 2]};
    const float p = attn_row(sq + i * dh, sk, sx, qb[bh + i], qkd_i, xi, n, dh, scale, lane);
    prow[lane] = p;
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(prow[j], sv[j * dh + d], acc);
      out[base + i * row_stride + d] = acc;
    }
    for (int c = 0; c < 3; ++c) {
      const float f = warp_sum(lane < n ? p * sx[lane * 3 + c] : 0.f);
      if (lane == 0) fdiff[(bh + i) * 3 + c] = f - xi[c];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
cl_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ x,
                        const float* __restrict__ qb, const float* __restrict__ qkd,
                        const float* __restrict__ dout, const float* __restrict__ dfd,
                        float* __restrict__ dq, float* __restrict__ dk,
                        float* __restrict__ dv, float* __restrict__ dqb,
                        float* __restrict__ dqkd, float* __restrict__ dxh,
                        int n, int heads, int dh, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;                    // (n, dh)
  float* sdo = sq + n * dh;            // (n, dh)
  float* sk = sdo + n * dh;            // (n, dh + 1)
  float* sv = sk + n * (dh + 1);       // (n, dh + 1)
  float* sx = sv + n * (dh + 1);       // (n, 3)
  float* sqkd = sx + 3 * n;            // (n, 3)
  float* sdfd = sqkd + 3 * n;          // (n, 3)
  float* srow = sdfd + 3 * n;          // (n,) sum_j dsim[i, j]
  float* sP = srow + n;                // (n, PSTRIDE) attn
  float* sdS = sP + n * PSTRIDE;       // (n, PSTRIDE) dsim
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = (size_t)heads * dh;
  const size_t base = ((size_t)b * n * heads + h) * dh;
  const size_t bh = ((size_t)b * heads + h) * n;

  for (int idx = threadIdx.x; idx < n * dh; idx += BWD_THREADS) {
    const int i = idx / dh, d = idx % dh;
    const size_t g = base + i * row_stride + d;
    sq[idx] = q[g];
    sdo[idx] = dout[g];
    sk[i * (dh + 1) + d] = k[g];
    sv[i * (dh + 1) + d] = v[g];
  }
  for (int idx = threadIdx.x; idx < 3 * n; idx += BWD_THREADS) {
    sx[idx] = x[(size_t)b * n * 3 + idx];
    sqkd[idx] = qkd[bh * 3 + idx];
    sdfd[idx] = dfd[bh * 3 + idx];
  }
  __syncthreads();

  // Pass 1, one warp per row i: attn, dsim and the row's own outputs.
  for (int i = warp; i < n; i += BWD_THREADS / 32) {
    const float* xi = sx + i * 3;
    const float p = attn_row(sq + i * dh, sk, sx, qb[bh + i], sqkd + i * 3, xi,
                             n, dh, scale, lane);
    // dL/dattn[i, j] = v_j . dout_i + x_j . dfd_i
    float dattn = 0.f;
    if (lane < n) {
      const float* vj = sv + lane * (dh + 1);
      const float* doi = sdo + i * dh;
      for (int d = 0; d < dh; ++d) dattn = fmaf(vj[d], doi[d], dattn);
      for (int c = 0; c < 3; ++c) dattn = fmaf(sx[lane * 3 + c], sdfd[i * 3 + c], dattn);
    }
    const float tot = warp_sum(dattn * p);
    const float ds = scale * p * (dattn - tot);
    sP[i * PSTRIDE + lane] = p;
    sdS[i * PSTRIDE + lane] = ds;
    const float rs = warp_sum(ds);
    if (lane == 0) {
      srow[i] = rs;
      dqb[bh + i] = rs;
    }
    for (int c = 0; c < 3; ++c) {
      const float g = warp_sum(lane < n ? ds * (sx[lane * 3 + c] - xi[c]) : 0.f);
      if (lane == 0) dqkd[(bh + i) * 3 + c] = g;
    }
    __syncwarp();
    const float* dsi = sdS + i * PSTRIDE;
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(dsi[j], sk[j * (dh + 1) + d], acc);
      dq[base + i * row_stride + d] = acc;
    }
  }
  __syncthreads();

  // Pass 2, one thread per output element, summing over rows i in order.
  for (int idx = threadIdx.x; idx < n * dh; idx += BWD_THREADS) {
    const int j = idx / dh, d = idx % dh;
    float ak = 0.f, av = 0.f;
    for (int i = 0; i < n; ++i) {
      ak = fmaf(sdS[i * PSTRIDE + j], sq[i * dh + d], ak);
      av = fmaf(sP[i * PSTRIDE + j], sdo[i * dh + d], av);
    }
    const size_t g = base + j * row_stride + d;
    dk[g] = ak;
    dv[g] = av;
  }
  // dx_j = sum_i (dsim_ij qkd_i + attn_ij dfd_i) - (sum_j' dsim_jj') qkd_j - dfd_j
  for (int idx = threadIdx.x; idx < 3 * n; idx += BWD_THREADS) {
    const int j = idx / 3, c = idx % 3;
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      acc = fmaf(sdS[i * PSTRIDE + j], sqkd[i * 3 + c], acc);
      acc = fmaf(sP[i * PSTRIDE + j], sdfd[i * 3 + c], acc);
    }
    dxh[bh * 3 + idx] = acc - srow[j] * sqkd[idx] - sdfd[idx];
  }
}

bool dims_ok(int batch, int n, int heads, int dh) {
  return n >= 1 && n <= MAX_N && dh >= 1 && dh <= MAX_DH && heads >= 1 && batch >= 0
         && (long long)batch * heads <= INT_MAX;
}

float attn_scale(int dh) { return (float)(1.0 / std::sqrt((double)dh)); }

}  // namespace

extern "C" {

const char* cudaGetErrorString_port(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Both launch one block per (chain, head) on `stream`, allocate nothing and
// return a cudaError_t code (0 on success): a refused launch never runs, so
// the caller must check it.
int cl_attention_fwd_launch(const float* q, const float* k, const float* v, const float* x,
                            const float* qb, const float* qkd, float* out, float* fdiff,
                            int batch, int n, int heads, int dh, void* stream) {
  if (!dims_ok(batch, n, heads, dh)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = (size_t)fwd_smem_floats(n, dh) * sizeof(float);
  cl_attention_fwd_kernel<<<batch * heads, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, x, qb, qkd, out, fdiff, n, heads, dh, attn_scale(dh));
  return (int)cudaGetLastError();
}

int cl_attention_bwd_launch(const float* q, const float* k, const float* v, const float* x,
                            const float* qb, const float* qkd, const float* dout,
                            const float* dfd, float* dq, float* dk, float* dv, float* dqb,
                            float* dqkd, float* dxh, int batch, int n, int heads, int dh,
                            void* stream) {
  if (!dims_ok(batch, n, heads, dh)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = (size_t)bwd_smem_floats(n, dh) * sizeof(float);
  cl_attention_bwd_kernel<<<batch * heads, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, x, qb, qkd, dout, dfd, dq, dk, dv, dqb, dqkd, dxh, n, heads, dh,
      attn_scale(dh));
  return (int)cudaGetLastError();
}

}  // extern "C"
