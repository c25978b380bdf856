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
// bytes of coordinates in and out per chain; the weights (~1.3 MB a layer
// with the transposed copies) are read from L2 by every block.
//
// What the design does about it (simple f32 design on CUDA cores): a fixed
// number of thread blocks, as many as the card keeps resident, each walks
// over its share of the chains. A chain's activations and the residuals the
// backward needs live in the block's own global scratch (it stays in L2: its
// size does not grow with the chain count), so the bead count is not tied to
// the shared memory of an SM. Shared memory holds only the working tiles: the
// input rows of the running matrix product (each thread owns an output column
// and keeps one accumulator per bead row, so a weight element read from L2
// feeds up to MAXR FMAs), the partial sums of a split reduction, and the
// chain's coordinates with their gradient. Attention runs per head over N
// keys straight from that scratch. Tensor cores and several chains per tile
// are left for later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int MAX_N = 64;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

struct Dims {
  int n, c, heads, dh, inner, ff, layers;
  int intrinsic, distances, abs_coords;
  float scale;
};

__host__ __device__ inline long long round4(long long v) { return (v + 3) & ~3LL; }

__host__ __device__ inline long long layer_floats(const Dims& d) {
  const long long C = d.c, I = d.inner, F = d.ff;
  return 2 * C + 3 * (C * I + I) + (d.intrinsic ? 3 * I : 0) + (d.distances ? I : 0) + I * C + C
         + 2 * C + 2 * C + C * F + F + F * C + C + 2 * C + 3 * I * C + C * I + F * C + C * F;
}

__host__ __device__ inline long long weight_floats(const Dims& d) {
  return d.layers * layer_floats(d) + (long long)d.n * d.c + (d.abs_coords ? 3LL * d.c : 0)
         + 2LL * d.c + 1;
}

// Residuals kept for the backward, per layer.
__host__ __device__ inline long long resid_floats(const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  return 4 * round4(N * C) + 3 * round4(N * I) + round4(H * N * N) + round4(N * F)
         + 2 * round4(N) + (d.distances ? 2 * round4(H * N) : 0);
}

// Working buffers of one block, beside the residuals.
__host__ __device__ inline long long work_floats(const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  return 3 * round4(N * C) + 5 * round4(N * I) + round4(H * N * N) + round4(N * F);
}

__host__ __device__ inline long long block_scratch_floats(const Dims& d) {
  return d.layers * resid_floats(d) + work_floats(d);
}

__host__ __device__ inline int max_width(const Dims& d) {
  int m = d.c;
  if (d.inner > m) m = d.inner;
  if (d.ff > m) m = d.ff;
  return m;
}

__host__ __device__ inline long long smem_floats(const Dims& d, int maxr) {
  const long long N = d.n, H = d.heads;
  return 2 * round4(3 * N) + 4 + 2 * round4(H * N) + (long long)maxr * max_width(d)
         + (long long)maxr * NTHREADS;
}

struct LayerW {
  const float *ln1_g, *ln1_b, *wq, *bq, *wk, *bk, *wv, *bv, *kc, *kd, *wo, *bo, *ga1, *gh1;
  const float *ln2_g, *ln2_b, *w1, *b1, *w2, *b2, *ga2, *gh2;
  const float *wqT, *wkT, *wvT, *woT, *w1T, *w2T;
};

// Must match layer_order() in fused_score.py.
__device__ LayerW layer_weights(const float* w, const Dims& d, int l) {
  const long long C = d.c, I = d.inner, F = d.ff;
  const float* p = w + l * layer_floats(d);
  LayerW L;
  L.ln1_g = p; p += C;  L.ln1_b = p; p += C;
  L.wq = p; p += C * I; L.bq = p; p += I;
  L.wk = p; p += C * I; L.bk = p; p += I;
  L.wv = p; p += C * I; L.bv = p; p += I;
  L.kc = nullptr; L.kd = nullptr;
  if (d.intrinsic) { L.kc = p; p += 3 * I; }
  if (d.distances) { L.kd = p; p += I; }
  L.wo = p; p += I * C; L.bo = p; p += C;
  L.ga1 = p; p += C;    L.gh1 = p; p += C;
  L.ln2_g = p; p += C;  L.ln2_b = p; p += C;
  L.w1 = p; p += C * F; L.b1 = p; p += F;
  L.w2 = p; p += F * C; L.b2 = p; p += C;
  L.ga2 = p; p += C;    L.gh2 = p; p += C;
  L.wqT = p; p += I * C; L.wkT = p; p += I * C; L.wvT = p; p += I * C;
  L.woT = p; p += C * I; L.w1T = p; p += F * C; L.w2T = p;
  return L;
}

struct Resid {
  float *hin, *q, *k, *v, *p, *a, *g1, *hmid, *f1, *f, *g2, *qs, *fd;
};

__device__ Resid resid(float* base, const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  Resid R;
  float* p = base;
  R.hin = p; p += round4(N * C);
  R.q = p; p += round4(N * I);
  R.k = p; p += round4(N * I);
  R.v = p; p += round4(N * I);
  R.p = p; p += round4(H * N * N);
  R.a = p; p += round4(N * C);
  R.g1 = p; p += round4(N);
  R.hmid = p; p += round4(N * C);
  R.f1 = p; p += round4(N * F);
  R.f = p; p += round4(N * C);
  R.g2 = p; p += round4(N);
  R.qs = p; p += d.distances ? round4(H * N) : 0;
  R.fd = p;
  return R;
}

struct Work {
  float *hl, *t1, *dh, *u, *du, *dq, *dk, *dv, *ds, *df1;
};

__device__ Work work(float* base, const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, H = d.heads;
  Work Wk;
  float* p = base;
  Wk.hl = p; p += round4(N * C);
  Wk.t1 = p; p += round4(N * C);
  Wk.dh = p; p += round4(N * C);
  Wk.u = p; p += round4(N * I);
  Wk.du = p; p += round4(N * I);
  Wk.dq = p; p += round4(N * I);
  Wk.dk = p; p += round4(N * I);
  Wk.dv = p; p += round4(N * I);
  Wk.ds = p; p += round4(H * N * N);
  Wk.df1 = p;
  return Wk;
}

struct Smem {
  float *x, *dx, *row, *g, *dqs, *xs, *red;
};

__device__ Smem carve(float* s, const Dims& d, int maxr) {
  const long long N = d.n, H = d.heads;
  Smem S;
  S.x = s;   s += round4(3 * N);
  S.dx = s;  s += round4(3 * N);
  S.row = s; s += 4;
  S.g = s;   s += round4(H * N);
  S.dqs = s; s += round4(H * N);
  S.xs = s;  s += (long long)maxr * max_width(d);
  S.red = s;
  return S;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float gelu(float x) { return 0.5f * x * (1.f + erff(x * 0.70710678118654752f)); }

__device__ inline float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f))
         + x * 0.39894228040143268f * expf(-0.5f * x * x);
}

// How a product's input rows are read into shared memory.
enum Stage { STAGE_COPY, STAGE_GELU, STAGE_TIMES_GELU_GRAD };

// Y[r*out + o] (= or +=) sum_i X'[r*in + i] * W[i*out + o] (+ b[o]) for r < n,
// with X' = X, gelu(X) or X * gelu'(AUX) by `stage`. X, AUX and Y in the
// block's global scratch, W (in, out) row-major and b in global memory. The
// rows go through shared memory (xs) MAXR at a time; each thread owns an
// output column and keeps one accumulator per row. When out < NTHREADS the
// reduction over i is split across thread groups whose partial sums pass
// through `red` (MAXR * NTHREADS floats). Requires in % 4 == 0.
template <int MAXR>
__device__ void matmul(const float* X, const float* AUX, Stage stage, int in,
                       const float* __restrict__ W, const float* __restrict__ b, float* Y,
                       int out, int n, bool accumulate, float* xs, float* red) {
  const int ks = out < NTHREADS ? NTHREADS / out : 1;
  const int chunk = (((in + ks - 1) / ks) + 3) & ~3;
  for (int row0 = 0; row0 < n; row0 += MAXR) {
    const int nr = min(MAXR, n - row0);
    const float* Xt = X + (size_t)row0 * in;
    for (int i = threadIdx.x; i < nr * in; i += NTHREADS) {
      float v = Xt[i];
      if (stage == STAGE_GELU) v = gelu(v);
      if (stage == STAGE_TIMES_GELU_GRAD) v *= gelu_grad(AUX[(size_t)row0 * in + i]);
      xs[i] = v;
    }
    __syncthreads();
    float* Yt = Y + (size_t)row0 * out;
    for (int idx = threadIdx.x; idx < out * ks; idx += NTHREADS) {
      const int o = idx % out, s = idx / out;
      const int i0 = s * chunk;
      const int i1 = min(in, i0 + chunk);
      float acc[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
      for (int i = i0; i < i1; i += 4) {
        const float w0 = __ldg(W + (size_t)i * out + o);
        const float w1 = __ldg(W + (size_t)(i + 1) * out + o);
        const float w2 = __ldg(W + (size_t)(i + 2) * out + o);
        const float w3 = __ldg(W + (size_t)(i + 3) * out + o);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < nr) {
            const float4 xv = *reinterpret_cast<const float4*>(xs + r * in + i);
            float a = acc[r];
            a = fmaf(xv.x, w0, a);
            a = fmaf(xv.y, w1, a);
            a = fmaf(xv.z, w2, a);
            a = fmaf(xv.w, w3, a);
            acc[r] = a;
          }
        }
      }
      if (ks == 1) {
        const float bias = b ? __ldg(b + o) : 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < nr) {
            const float val = acc[r] + bias;
            Yt[r * out + o] = accumulate ? Yt[r * out + o] + val : val;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < nr) red[(s * nr + r) * out + o] = acc[r];
      }
    }
    if (ks > 1) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * out; idx += NTHREADS) {
        const int o = idx % out;
        float val = b ? __ldg(b + o) : 0.f;
        for (int s = 0; s < ks; ++s) val += red[s * nr * out + idx];
        Yt[idx] = accumulate ? Yt[idx] + val : val;
      }
    }
    __syncthreads();
  }
}

// LayerNorm over the features of each row (eps 1e-5), one warp per row.
__device__ void layer_norm(const float* X, float* Y, const float* __restrict__ g,
                           const float* __restrict__ b, int n, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARPS) {
    const float* x = X + r * c;
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += x[j];
    const float mu = warp_sum(s) / c;
    float v = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float dv = x[j] - mu;
      v += dv * dv;
    }
    const float rs = rsqrtf(warp_sum(v) / c + 1e-5f);
    for (int j = lane; j < c; j += 32)
      Y[r * c + j] = (x[j] - mu) * rs * __ldg(g + j) + __ldg(b + j);
  }
  __syncthreads();
}

// DX += d LN(X) / dX applied to DY (the LayerNorm input gradient).
__device__ void layer_norm_bwd(const float* X, const float* DY, const float* __restrict__ g,
                               float* DX, int n, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARPS) {
    const float* x = X + r * c;
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += x[j];
    const float mu = warp_sum(s) / c;
    float v = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float dv = x[j] - mu;
      v += dv * dv;
    }
    const float rs = rsqrtf(warp_sum(v) / c + 1e-5f);
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float gy = DY[r * c + j] * __ldg(g + j);
      s1 += gy;
      s2 += gy * (x[j] - mu) * rs;
    }
    s1 = warp_sum(s1) / c;
    s2 = warp_sum(s2) / c;
    for (int j = lane; j < c; j += 32) {
      const float xh = (x[j] - mu) * rs;
      const float gy = DY[r * c + j] * __ldg(g + j);
      DX[r * c + j] += rs * (gy - s1 - xh * s2);
    }
  }
  __syncthreads();
}

// Gated residual: g = sigmoid(a.ga + h.gh); Hout = a g + h (1 - g); G[r] = g.
__device__ void gate_fwd(const float* A, const float* Hin, const float* __restrict__ ga,
                         const float* __restrict__ gh, float* G, float* Hout, int n, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARPS) {
    float s = 0.f;
    for (int j = lane; j < c; j += 32)
      s += A[r * c + j] * __ldg(ga + j) + Hin[r * c + j] * __ldg(gh + j);
    const float g = 1.f / (1.f + expf(-warp_sum(s)));
    for (int j = lane; j < c; j += 32)
      Hout[r * c + j] = A[r * c + j] * g + Hin[r * c + j] * (1.f - g);
    if (lane == 0) G[r] = g;
  }
  __syncthreads();
}

// Backward of gate_fwd. On entry DH = dL/dHout; on exit DH = dL/dHin through
// the gate and DA = dL/da.
__device__ void gate_bwd(const float* A, const float* Hin, const float* G,
                         const float* __restrict__ ga, const float* __restrict__ gh,
                         float* DH, float* DA, int n, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARPS) {
    const float g = G[r];
    float dg = 0.f;
    for (int j = lane; j < c; j += 32) dg += DH[r * c + j] * (A[r * c + j] - Hin[r * c + j]);
    const float ds = warp_sum(dg) * g * (1.f - g);
    for (int j = lane; j < c; j += 32) {
      const float dd = DH[r * c + j];
      DA[r * c + j] = dd * g + ds * __ldg(ga + j);
      DH[r * c + j] = dd * (1.f - g) + ds * __ldg(gh + j);
    }
  }
  __syncthreads();
}

// K += xc Kc, V += xc Kc.
__device__ void add_edge_terms(const float* X, const float* __restrict__ kc, float* K, float* V,
                               int n, int I) {
  for (int idx = threadIdx.x; idx < n * I; idx += NTHREADS) {
    const int r = idx / I, e = idx % I;
    const float a = X[r * 3] * __ldg(kc + e) + X[r * 3 + 1] * __ldg(kc + I + e)
                    + X[r * 3 + 2] * __ldg(kc + 2 * I + e);
    K[idx] += a;
    V[idx] += a;
  }
  __syncthreads();
}

// |x_i - x_j|^2 from the differences.
__device__ inline float sq_dist(const float* X, int i, int j) {
  const float a = X[i * 3] - X[j * 3], b = X[i * 3 + 1] - X[j * 3 + 1],
              c = X[i * 3 + 2] - X[j * 3 + 2];
  return a * a + b * b + c * c;
}

// DX[r, c] += sign * sum_e (A + B)[r, e] M[c, e] for c < 3 (M is (3, I)): a
// coordinate gradient through a 3-row map. One warp per (r, c).
__device__ void three_row_bwd(const float* A, const float* B, float sign,
                              const float* __restrict__ M, float* DX, int n, int I) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rc = warp; rc < 3 * n; rc += NWARPS) {
    const int r = rc / 3, c = rc % 3;
    float s = 0.f;
    for (int e = lane; e < I; e += 32) {
      const float a = A[r * I + e] + (B ? B[r * I + e] : 0.f);
      s += a * __ldg(M + c * I + e);
    }
    s = warp_sum(s);
    if (lane == 0) DX[rc] += sign * s;
  }
  __syncthreads();
}

// Out[h*n + i] = sum_d A[i, h*dh + d] kd[h*dh + d]. One warp per (h, i).
__device__ void head_vec(const float* A, const float* __restrict__ kd, float* Out, int n,
                         int heads, int dh, int I) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int hi = warp; hi < heads * n; hi += NWARPS) {
    const int h = hi / n, i = hi % n;
    float s = 0.f;
    for (int dd = lane; dd < dh; dd += 32)
      s += A[i * I + h * dh + dd] * __ldg(kd + h * dh + dd);
    s = warp_sum(s);
    if (lane == 0) Out[hi] = s;
  }
  __syncthreads();
}

// Out[(h*n + i)*n + j] = sum_d A[i, h*dh + d] B[j, h*dh + d]
//                        [+ coef[h*n + i] (|x_i - x_j|^2 [- shift[h*n + i]])].
__device__ void head_dots(const float* A, const float* B, float* Out, const float* coef,
                          const float* shift, const float* X, int n, int heads, int dh, int I) {
  for (int idx = threadIdx.x; idx < heads * n * n; idx += NTHREADS) {
    const int h = idx / (n * n), i = (idx / n) % n, j = idx % n;
    const float4* a = reinterpret_cast<const float4*>(A + i * I + h * dh);
    const float4* bb = reinterpret_cast<const float4*>(B + j * I + h * dh);
    float s = 0.f;
    for (int d4 = 0; d4 < dh / 4; ++d4) {
      const float4 av = a[d4], bv = bb[d4];
      s += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
    }
    if (coef) s += coef[h * n + i] * (sq_dist(X, i, j) - (shift ? shift[h * n + i] : 0.f));
    Out[idx] = s;
  }
  __syncthreads();
}

// Y[i, e] = sum_j M[(h*n + i)*n + j] Z[j, e] with h = e / dh
// (transpose_m: M[(h*n + j)*n + i]).
__device__ void head_mix(const float* M, const float* Z, float* Y, int n, int dh, int I,
                         bool transpose_m) {
  for (int idx = threadIdx.x; idx < n * I; idx += NTHREADS) {
    const int i = idx / I, e = idx % I, h = e / dh;
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      const float m = transpose_m ? M[(h * n + j) * n + i] : M[(h * n + i) * n + j];
      s += m * Z[j * I + e];
    }
    Y[idx] = s;
  }
  __syncthreads();
}

// Out[h*n + i] = sum_j M[(h*n + i)*n + j] |x_i - x_j|^2.
__device__ void rows_times_dist(const float* M, const float* X, float* Out, int n, int heads) {
  for (int hi = threadIdx.x; hi < heads * n; hi += NTHREADS) {
    const int i = hi % n;
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += M[hi * n + j] * sq_dist(X, i, j);
    Out[hi] = s;
  }
  __syncthreads();
}

// The coordinate gradient through the squared distances. With the gradient
// of d_ij summed over the heads, D_ij = sum_h (g[h, i] P[h, i, j]
// + qs[h, i] dS[h, i, j]):  DX[i, c] += 2 sum_j (D_ij + D_ji) (x_i - x_j)[c].
__device__ void dist_bwd(const float* P, const float* DS, const float* g, const float* qs,
                         const float* X, float* DX, int n, int heads) {
  for (int idx = threadIdx.x; idx < n * 3; idx += NTHREADS) {
    const int i = idx / 3, c = idx % 3;
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      float dd = 0.f;
      for (int h = 0; h < heads; ++h) {
        const int ij = (h * n + i) * n + j, ji = (h * n + j) * n + i;
        dd += g[h * n + i] * P[ij] + qs[h * n + i] * DS[ij] + g[h * n + j] * P[ji]
              + qs[h * n + j] * DS[ji];
      }
      s += dd * (X[i * 3 + c] - X[j * 3 + c]);
    }
    DX[idx] += 2.f * s;
  }
  __syncthreads();
}

template <int MAXR>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_force_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ w, float* scratch, float t, int batch, Dims d) {
  extern __shared__ float4 smem4[];
  const Smem S = carve(reinterpret_cast<float*>(smem4), d, MAXR);
  const int n = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  const float* h0 = w + d.layers * layer_floats(d);
  const float* wx = d.abs_coords ? h0 + n * C : nullptr;
  const float* wt = h0 + n * C + (d.abs_coords ? 3 * C : 0);
  const float* wdec = wt + C;
  float* mine = scratch + (size_t)blockIdx.x * block_scratch_floats(d);
  const Work Wk = work(mine + d.layers * resid_floats(d), d);

  for (long long b = blockIdx.x; b < batch; b += gridDim.x) {
    // Centre the chain's coordinates.
    for (int i = threadIdx.x; i < 3 * n; i += NTHREADS) {
      S.x[i] = x[b * 3 * n + i];
      S.dx[i] = 0.f;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float s = 0.f;
      for (int r = 0; r < n; ++r) s += S.x[r * 3 + threadIdx.x];
      S.row[threadIdx.x] = s / n;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * n; i += NTHREADS) S.x[i] -= S.row[i % 3];
    __syncthreads();
    {
      float* hin = resid(mine, d).hin;
      for (int i = threadIdx.x; i < n * C; i += NTHREADS) {
        const int r = i / C, k = i % C;
        float v = __ldg(h0 + i) + t * __ldg(wt + k);
        if (wx)
          v += S.x[r * 3] * __ldg(wx + k) + S.x[r * 3 + 1] * __ldg(wx + C + k)
               + S.x[r * 3 + 2] * __ldg(wx + 2 * C + k);
        hin[i] = v;
      }
    }
    __syncthreads();

    // -------------------------------------------------------------- forward
    for (int l = 0; l < d.layers; ++l) {
      const LayerW W = layer_weights(w, d, l);
      const Resid R = resid(mine + l * resid_floats(d), d);
      // The last layer's output feeds only the energy, which is not returned.
      float* hnext = l + 1 < d.layers ? resid(mine + (l + 1) * resid_floats(d), d).hin : Wk.t1;
      layer_norm(R.hin, Wk.hl, W.ln1_g, W.ln1_b, n, C);
      matmul<MAXR>(Wk.hl, nullptr, STAGE_COPY, C, W.wq, W.bq, R.q, I, n, false, S.xs, S.red);
      matmul<MAXR>(Wk.hl, nullptr, STAGE_COPY, C, W.wk, W.bk, R.k, I, n, false, S.xs, S.red);
      matmul<MAXR>(Wk.hl, nullptr, STAGE_COPY, C, W.wv, W.bv, R.v, I, n, false, S.xs, S.red);
      if (W.kc) add_edge_terms(S.x, W.kc, R.k, R.v, n, I);
      if (W.kd) head_vec(R.q, W.kd, R.qs, n, H, d.dh, I);
      head_dots(R.q, R.k, R.p, W.kd ? R.qs : nullptr, nullptr, S.x, n, H, d.dh, I);
      for (int row = threadIdx.x; row < H * n; row += NTHREADS) {
        float* p = R.p + row * n;
        float m = d.scale * p[0];
        for (int j = 1; j < n; ++j) m = fmaxf(m, d.scale * p[j]);
        float s = 0.f;
        for (int j = 0; j < n; ++j) {
          p[j] = expf(d.scale * p[j] - m);
          s += p[j];
        }
        const float inv = 1.f / s;
        for (int j = 0; j < n; ++j) p[j] *= inv;
      }
      __syncthreads();
      if (W.kd) rows_times_dist(R.p, S.x, R.fd, n, H);
      head_mix(R.p, R.v, Wk.u, n, d.dh, I, false);
      if (W.kc || W.kd) {
        // u_i += - xc_i Kc + kd sum_j P_ij d_ij
        for (int idx = threadIdx.x; idx < n * I; idx += NTHREADS) {
          const int r = idx / I, e = idx % I;
          float a = 0.f;
          if (W.kc)
            a = -(S.x[r * 3] * __ldg(W.kc + e) + S.x[r * 3 + 1] * __ldg(W.kc + I + e)
                  + S.x[r * 3 + 2] * __ldg(W.kc + 2 * I + e));
          if (W.kd) a += __ldg(W.kd + e) * R.fd[(e / d.dh) * n + r];
          Wk.u[idx] += a;
        }
        __syncthreads();
      }
      matmul<MAXR>(Wk.u, nullptr, STAGE_COPY, I, W.wo, W.bo, R.a, C, n, false, S.xs, S.red);
      gate_fwd(R.a, R.hin, W.ga1, W.gh1, R.g1, R.hmid, n, C);
      layer_norm(R.hmid, Wk.hl, W.ln2_g, W.ln2_b, n, C);
      matmul<MAXR>(Wk.hl, nullptr, STAGE_COPY, C, W.w1, W.b1, R.f1, F, n, false, S.xs, S.red);
      matmul<MAXR>(R.f1, nullptr, STAGE_GELU, F, W.w2, W.b2, R.f, C, n, false, S.xs, S.red);
      gate_fwd(R.f, R.hmid, W.ga2, W.gh2, R.g2, hnext, n, C);
    }

    // ------------------------------------------------------------- backward
    for (int i = threadIdx.x; i < n * C; i += NTHREADS) Wk.dh[i] = __ldg(wdec + i % C);
    __syncthreads();
    for (int l = d.layers - 1; l >= 0; --l) {
      const LayerW W = layer_weights(w, d, l);
      const Resid R = resid(mine + l * resid_floats(d), d);
      // Feed-forward gated residual.
      gate_bwd(R.f, R.hmid, R.g2, W.ga2, W.gh2, Wk.dh, Wk.t1, n, C);  // t1 = df
      matmul<MAXR>(Wk.t1, nullptr, STAGE_COPY, C, W.w2T, nullptr, Wk.df1, F, n, false, S.xs,
                   S.red);  // d gelu out
      matmul<MAXR>(Wk.df1, R.f1, STAGE_TIMES_GELU_GRAD, F, W.w1T, nullptr, Wk.hl, C, n, false,
                   S.xs, S.red);  // d LN2 out
      layer_norm_bwd(R.hmid, Wk.hl, W.ln2_g, Wk.dh, n, C);
      // Attention gated residual.
      gate_bwd(R.a, R.hin, R.g1, W.ga1, W.gh1, Wk.dh, Wk.t1, n, C);  // t1 = da
      matmul<MAXR>(Wk.t1, nullptr, STAGE_COPY, C, W.woT, nullptr, Wk.du, I, n, false, S.xs,
                   S.red);  // du
      if (W.kc) three_row_bwd(Wk.du, nullptr, -1.f, W.kc, S.dx, n, I);
      // Through kd sum_j P_ij d_ij: g_i = du_i . kd per head.
      if (W.kd) head_vec(Wk.du, W.kd, S.g, n, H, d.dh, I);
      // dP_ij = du_i . v'_j + g_i d_ij, then through the softmax. The softmax
      // backward ignores what is constant along a row, so g_i (d_ij - fd_i)
      // with fd_i = sum_j P_ij d_ij stands for g_i d_ij: it keeps two large
      // terms from cancelling when the scores are sharp.
      head_dots(Wk.du, R.v, Wk.ds, W.kd ? S.g : nullptr, R.fd, S.x, n, H, d.dh, I);
      for (int row = threadIdx.x; row < H * n; row += NTHREADS) {
        const float* p = R.p + row * n;
        float* ds = Wk.ds + row * n;
        float tot = 0.f;
        for (int j = 0; j < n; ++j) tot += p[j] * ds[j];
        for (int j = 0; j < n; ++j) ds[j] = d.scale * p[j] * (ds[j] - tot);
      }
      __syncthreads();
      head_mix(R.p, Wk.du, Wk.dv, n, d.dh, I, true);   // dv' = P^T du
      head_mix(Wk.ds, R.k, Wk.dq, n, d.dh, I, false);  // dq = dS k'
      head_mix(Wk.ds, R.q, Wk.dk, n, d.dh, I, true);   // dk' = dS^T q
      if (W.kd) {
        // Through S_ij += qs_i d_ij with qs_i = q_i . kd per head, and through
        // the d_ij themselves (here and in the values).
        rows_times_dist(Wk.ds, S.x, S.dqs, n, H);  // dqs_i = sum_j dS_ij d_ij
        for (int idx = threadIdx.x; idx < n * I; idx += NTHREADS) {
          const int i = idx / I, e = idx % I;
          Wk.dq[idx] += S.dqs[(e / d.dh) * n + i] * __ldg(W.kd + e);
        }
        dist_bwd(R.p, Wk.ds, S.g, R.qs, S.x, S.dx, n, H);
      }
      if (W.kc) three_row_bwd(Wk.dk, Wk.dv, 1.f, W.kc, S.dx, n, I);
      matmul<MAXR>(Wk.dq, nullptr, STAGE_COPY, I, W.wqT, nullptr, Wk.hl, C, n, false, S.xs,
                   S.red);
      matmul<MAXR>(Wk.dk, nullptr, STAGE_COPY, I, W.wkT, nullptr, Wk.hl, C, n, true, S.xs,
                   S.red);
      matmul<MAXR>(Wk.dv, nullptr, STAGE_COPY, I, W.wvT, nullptr, Wk.hl, C, n, true, S.xs,
                   S.red);
      layer_norm_bwd(R.hin, Wk.hl, W.ln1_g, Wk.dh, n, C);
    }
    if (wx) three_row_bwd(Wk.dh, nullptr, 1.f, wx, S.dx, n, C);  // h = ... + xc Wx
    for (int i = threadIdx.x; i < 3 * n; i += NTHREADS) out[b * 3 * n + i] = -S.dx[i];
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

bool dims_ok(const Dims& d) {
  return d.n >= 1 && d.n <= MAX_N && d.c >= 4 && d.heads >= 1 && d.dh >= 4 && d.ff >= 4
         && d.layers >= 1 && d.c % 4 == 0 && d.dh % 4 == 0 && d.ff % 4 == 0;
}

// Row tile of the matrix products: the accumulators of a thread.
int row_tile(const Dims& d) { return d.n <= 16 ? 16 : 32; }

template <int MAXR>
cudaError_t resident_blocks(const Dims& d, int* blocks) {
  const size_t smem = (size_t)smem_floats(d, MAXR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_force_kernel<MAXR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_force_kernel<MAXR>,
                                                      NTHREADS, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

long long fused_force_weight_floats(int n, int c, int heads, int dh, int ff, int layers,
                                    int intrinsic, int distances, int abs_coords) {
  return weight_floats(make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords));
}

// Scratch floats of ONE thread block; the caller allocates this times the
// block count that fused_force_blocks returns.
long long fused_force_scratch_floats(int n, int c, int heads, int dh, int ff, int layers,
                                     int intrinsic, int distances, int abs_coords) {
  return block_scratch_floats(
      make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords));
}

const char* fused_force_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Thread blocks of a launch over `batch` chains: as many as the card keeps
// resident, at most one per chain. Returns minus a cudaError_t code when the
// kernel cannot run with these dimensions.
int fused_force_blocks(int batch, int n, int c, int heads, int dh, int ff, int layers,
                       int intrinsic, int distances, int abs_coords) {
  const Dims d = make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords);
  if (!dims_ok(d) || batch < 1) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      row_tile(d) == 16 ? resident_blocks<16>(d, &blocks) : resident_blocks<32>(d, &blocks);
  if (err != cudaSuccess) return -(int)err;
  return blocks < batch ? blocks : batch;
}

// Launches `blocks` thread blocks (from fused_force_blocks, which also opts
// the kernel in to its shared memory) on `stream`; `scratch` holds
// blocks * fused_force_scratch_floats floats. Returns a cudaError_t code
// (0 on success): a refused launch never runs, so the caller must check it.
int fused_force_launch(const float* x, float* out, const float* w, float* scratch, float t,
                       int batch, int blocks, int n, int c, int heads, int dh, int ff, int layers,
                       int intrinsic, int distances, int abs_coords, void* stream) {
  const Dims d = make_dims(n, c, heads, dh, ff, layers, intrinsic, distances, abs_coords);
  if (!dims_ok(d) || batch < 1 || blocks < 1 || blocks > batch) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_tile(d) == 16) {
    const size_t smem = (size_t)smem_floats(d, 16) * sizeof(float);
    fused_force_kernel<16><<<blocks, NTHREADS, smem, s>>>(x, out, w, scratch, t, batch, d);
  } else {
    const size_t smem = (size_t)smem_floats(d, 32) * sizeof(float);
    fused_force_kernel<32><<<blocks, NTHREADS, smem, s>>>(x, out, w, scratch, t, batch, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
