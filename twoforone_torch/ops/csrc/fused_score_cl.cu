// Fused conservative force evaluation of the graph-transformer energy model.
//
// Replaces: twoforone_tpu/ops/fused_score_cl.py::make_fused_force_kernel_cl
// (the chain-lane Pallas kernel, body `kernel`, pallas_call in `call_cl`).
//
// What it computes, per chain b (x: (B, N, 3) row-major):
//   xc = x - mean_beads(x)
//   h  = h0 + t * wt                                          (N, C)
//   per layer:  hl = LN1(h)
//               q = hl Wq + bq,  k = hl Wk + bk + xc Kc,  v = hl Wv + bv + xc Kc
//               P_h = softmax_j(scale * q_h k_h^T),  o_h = P_h v_h   (per head)
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
// at the chignolin width (N=10, C=64, 3 layers, 8 x 64 heads) against
// ~0.24 MB of coordinates in and out per 1000 chains; the weights (~1.3 MB a layer with
// the transposed copies) are read from L2 by every block.
//
// What the design does about it (simple f32 design, no tensor cores yet):
// one thread block per chain keeps the chain's whole activation set in
// shared memory (~112 KB at chignolin width, so two blocks fit an SM). Every
// product is a loop of the block's own: each thread owns an output column
// and keeps one accumulator per bead in registers, so each weight element
// read from L2 feeds N FMAs and the bead rows come from shared memory as
// float4 broadcasts. Residuals the backward needs are written to a scratch
// buffer the caller allocates, rather than recomputed. Packing many chains
// into one tile (to reuse each weight read across chains) and wgmma are
// left for later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int MAX_N = 16;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

struct Dims {
  int n, c, heads, dh, inner, ff, layers;
  float scale;
};

__host__ __device__ inline long long layer_floats(const Dims& d) {
  const long long C = d.c, I = d.inner, F = d.ff;
  return 2 * C + 3 * (C * I + I) + 3 * I + I * C + C + 2 * C + 2 * C + C * F + F
         + F * C + C + 2 * C + 3 * I * C + C * I + F * C + C * F;
}

__host__ __device__ inline long long weight_floats(const Dims& d) {
  return d.layers * layer_floats(d) + (long long)d.n * d.c + 2LL * d.c + 1;
}

// Residuals kept for the backward, per chain per layer.
__host__ __device__ inline long long resid_floats(const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  return 4 * N * C + 3 * N * I + H * N * N + N * F + 2 * N;
}

__host__ __device__ inline long long round4(long long v) { return (v + 3) & ~3LL; }

__host__ __device__ inline long long smem_floats(const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  return 2 * round4(3 * N) + 5 * round4(N * C) + 4 * round4(N * I) + 2 * round4(H * N * N)
         + round4(N * F) + 4 * MAX_N;
}

struct LayerW {
  const float *ln1_g, *ln1_b, *wq, *bq, *wk, *bk, *wv, *bv, *kc, *wo, *bo, *ga1, *gh1;
  const float *ln2_g, *ln2_b, *w1, *b1, *w2, *b2, *ga2, *gh2;
  const float *wqT, *wkT, *wvT, *woT, *w1T, *w2T;
};

// Must match _LAYER_ORDER in fused_score_cl.py.
__device__ LayerW layer_weights(const float* w, const Dims& d, int l) {
  const long long C = d.c, I = d.inner, F = d.ff;
  const float* p = w + l * layer_floats(d);
  LayerW L;
  L.ln1_g = p; p += C;  L.ln1_b = p; p += C;
  L.wq = p; p += C * I; L.bq = p; p += I;
  L.wk = p; p += C * I; L.bk = p; p += I;
  L.wv = p; p += C * I; L.bv = p; p += I;
  L.kc = p; p += 3 * I;
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
  float *hin, *q, *k, *v, *p, *a, *g1, *hmid, *f1, *f, *g2;
};

__device__ Resid resid(float* base, const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  Resid R;
  float* p = base;
  R.hin = p; p += N * C;
  R.q = p; p += N * I;
  R.k = p; p += N * I;
  R.v = p; p += N * I;
  R.p = p; p += H * N * N;
  R.a = p; p += N * C;
  R.g1 = p; p += N;
  R.hmid = p; p += N * C;
  R.f1 = p; p += N * F;
  R.f = p; p += N * C;
  R.g2 = p;
  return R;
}

struct Smem {
  float *x, *dx, *hs, *hl, *t1, *t2, *dh, *q, *k, *v, *u, *p, *ds, *f1, *row;
};

__device__ Smem carve(float* s, const Dims& d) {
  const long long N = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  Smem S;
  S.x = s;  s += round4(3 * N);
  S.dx = s; s += round4(3 * N);
  S.hs = s; s += round4(N * C);
  S.hl = s; s += round4(N * C);
  S.t1 = s; s += round4(N * C);
  S.t2 = s; s += round4(N * C);
  S.dh = s; s += round4(N * C);
  S.q = s;  s += round4(N * I);
  S.k = s;  s += round4(N * I);
  S.v = s;  s += round4(N * I);
  S.u = s;  s += round4(N * I);
  S.p = s;  s += round4(H * N * N);
  S.ds = s; s += round4(H * N * N);
  S.f1 = s; s += round4(N * F);
  S.row = s;
  return S;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline void store(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += NTHREADS) dst[i] = src[i];
  __syncthreads();
}

// Y[r*out + o] (= or +=) sum_i X[r*in + i] * W[i*out + o] (+ b[o]) for r < n.
// X and Y in shared memory, W (in, out) row-major and b in global memory.
// Each thread owns an output column and keeps one accumulator per bead.
// When out < NTHREADS the reduction over i is split across thread groups
// whose partial sums pass through `red` (red_cap floats of shared memory).
// Requires in % 4 == 0 and 16-byte aligned rows of X.
__device__ void matmul(const float* X, int in, const float* __restrict__ W,
                       const float* __restrict__ b, float* Y, int out, int n,
                       bool accumulate, float* red, int red_cap) {
  int ks = 1;
  if (out < NTHREADS && red != nullptr) {
    ks = NTHREADS / out;
    const int cap = red_cap / (n * out);
    if (ks > cap) ks = cap;
    if (ks < 1) ks = 1;
  }
  const int chunk = (((in + ks - 1) / ks) + 3) & ~3;
  for (int idx = threadIdx.x; idx < out * ks; idx += NTHREADS) {
    const int o = idx % out, s = idx / out;
    const int i0 = s * chunk;
    const int i1 = min(in, i0 + chunk);
    float acc[MAX_N];
#pragma unroll
    for (int r = 0; r < MAX_N; ++r) acc[r] = 0.f;
    for (int i = i0; i < i1; i += 4) {
      const float w0 = __ldg(W + (size_t)i * out + o);
      const float w1 = __ldg(W + (size_t)(i + 1) * out + o);
      const float w2 = __ldg(W + (size_t)(i + 2) * out + o);
      const float w3 = __ldg(W + (size_t)(i + 3) * out + o);
#pragma unroll
      for (int r = 0; r < MAX_N; ++r) {
        if (r < n) {
          const float4 xv = *reinterpret_cast<const float4*>(X + r * in + i);
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
      for (int r = 0; r < MAX_N; ++r) {
        if (r < n) {
          const float val = acc[r] + bias;
          Y[r * out + o] = accumulate ? Y[r * out + o] + val : val;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < MAX_N; ++r)
        if (r < n) red[(s * n + r) * out + o] = acc[r];
    }
  }
  if (ks > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * out; idx += NTHREADS) {
      const int r = idx / out, o = idx % out;
      float val = b ? __ldg(b + o) : 0.f;
      for (int s = 0; s < ks; ++s) val += red[(s * n + r) * out + o];
      Y[idx] = accumulate ? Y[idx] + val : val;
    }
  }
  __syncthreads();
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

// Gated residual: g = sigmoid(a.ga + h.gh); h <- a g + h (1 - g); G[r] = g.
__device__ void gate_fwd(const float* A, float* Hs, const float* __restrict__ ga,
                         const float* __restrict__ gh, float* G, int n, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARPS) {
    float s = 0.f;
    for (int j = lane; j < c; j += 32)
      s += A[r * c + j] * __ldg(ga + j) + Hs[r * c + j] * __ldg(gh + j);
    const float g = 1.f / (1.f + expf(-warp_sum(s)));
    for (int j = lane; j < c; j += 32)
      Hs[r * c + j] = A[r * c + j] * g + Hs[r * c + j] * (1.f - g);
    if (lane == 0) G[r] = g;
  }
  __syncthreads();
}

// Backward of gate_fwd. On entry DH = dL/dh_out; on exit DH = dL/dh through
// the gate and A (held the gate's input a) = dL/da.
__device__ void gate_bwd(float* A, const float* Hin, const float* G,
                         const float* __restrict__ ga, const float* __restrict__ gh,
                         float* DH, int n, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARPS) {
    const float g = G[r];
    float dg = 0.f;
    for (int j = lane; j < c; j += 32) dg += DH[r * c + j] * (A[r * c + j] - Hin[r * c + j]);
    const float ds = warp_sum(dg) * g * (1.f - g);
    for (int j = lane; j < c; j += 32) {
      const float d = DH[r * c + j];
      A[r * c + j] = d * g + ds * __ldg(ga + j);
      DH[r * c + j] = d * (1.f - g) + ds * __ldg(gh + j);
    }
  }
  __syncthreads();
}

// K += xc Kc, V += xc Kc, U = -xc Kc.
__device__ void add_edge_terms(const float* X, const float* __restrict__ kc, float* K,
                               float* V, float* U, int n, int I) {
  for (int idx = threadIdx.x; idx < n * I; idx += NTHREADS) {
    const int r = idx / I, e = idx % I;
    const float xk = X[r * 3] * __ldg(kc + e) + X[r * 3 + 1] * __ldg(kc + I + e)
                     + X[r * 3 + 2] * __ldg(kc + 2 * I + e);
    K[idx] += xk;
    V[idx] += xk;
    U[idx] = -xk;
  }
  __syncthreads();
}

// DX[r, c] += sign * sum_e (A + B)[r, e] Kc[c, e]: the coordinate gradient
// through the edge terms. One warp per (r, c).
__device__ void edge_terms_bwd(const float* A, const float* B, float sign,
                               const float* __restrict__ kc, float* DX, int n, int I) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rc = warp; rc < 3 * n; rc += NWARPS) {
    const int r = rc / 3, c = rc % 3;
    float s = 0.f;
    for (int e = lane; e < I; e += 32) {
      const float a = A[r * I + e] + (B ? B[r * I + e] : 0.f);
      s += a * __ldg(kc + c * I + e);
    }
    s = warp_sum(s);
    if (lane == 0) DX[rc] += sign * s;
  }
  __syncthreads();
}

// Out[(h*n + i)*n + j] = sum_d A[i, h*dh + d] B[j, h*dh + d].
__device__ void head_dots(const float* A, const float* B, float* Out, int n, int heads,
                          int dh, int I) {
  for (int idx = threadIdx.x; idx < heads * n * n; idx += NTHREADS) {
    const int h = idx / (n * n), i = (idx / n) % n, j = idx % n;
    const float4* a = reinterpret_cast<const float4*>(A + i * I + h * dh);
    const float4* bb = reinterpret_cast<const float4*>(B + j * I + h * dh);
    float s = 0.f;
    for (int d4 = 0; d4 < dh / 4; ++d4) {
      const float4 av = a[d4], bv = bb[d4];
      s += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
    }
    Out[idx] = s;
  }
  __syncthreads();
}

// Y[i, e] (= or +=) sum_j M[(h*n + i)*n + j] Z[j, e] with h = e / dh
// (transpose_m: M[(h*n + j)*n + i]).
__device__ void head_mix(const float* M, const float* Z, float* Y, int n, int dh, int I,
                         bool transpose_m, bool accumulate) {
  for (int idx = threadIdx.x; idx < n * I; idx += NTHREADS) {
    const int i = idx / I, e = idx % I, h = e / dh;
    float s = accumulate ? Y[idx] : 0.f;
    for (int j = 0; j < n; ++j) {
      const float m = transpose_m ? M[(h * n + j) * n + i] : M[(h * n + i) * n + j];
      s += m * Z[j * I + e];
    }
    Y[idx] = s;
  }
  __syncthreads();
}

__device__ inline float gelu(float x) { return 0.5f * x * (1.f + erff(x * 0.70710678118654752f)); }

__device__ inline float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f))
         + x * 0.39894228040143268f * expf(-0.5f * x * x);
}

__global__ void __launch_bounds__(NTHREADS)
fused_force_cl_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ w, float* __restrict__ scratch, float t,
                      Dims d) {
  extern __shared__ float4 smem4[];
  Smem S = carve(reinterpret_cast<float*>(smem4), d);
  const int n = d.n, C = d.c, I = d.inner, F = d.ff, H = d.heads;
  const long long b = blockIdx.x;
  const float* h0 = w + d.layers * layer_floats(d);
  const float* wt = h0 + n * C;
  const float* wdec = wt + C;
  float* chain = scratch + b * d.layers * resid_floats(d);

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
  for (int i = threadIdx.x; i < n * C; i += NTHREADS) S.hs[i] = h0[i] + t * wt[i % C];
  __syncthreads();

  // ---------------------------------------------------------------- forward
  for (int l = 0; l < d.layers; ++l) {
    const LayerW W = layer_weights(w, d, l);
    const Resid R = resid(chain + l * resid_floats(d), d);
    store(R.hin, S.hs, n * C);
    layer_norm(S.hs, S.hl, W.ln1_g, W.ln1_b, n, C);
    matmul(S.hl, C, W.wq, W.bq, S.q, I, n, false, nullptr, 0);
    matmul(S.hl, C, W.wk, W.bk, S.k, I, n, false, nullptr, 0);
    matmul(S.hl, C, W.wv, W.bv, S.v, I, n, false, nullptr, 0);
    add_edge_terms(S.x, W.kc, S.k, S.v, S.u, n, I);
    store(R.q, S.q, n * I);
    store(R.k, S.k, n * I);
    store(R.v, S.v, n * I);
    head_dots(S.q, S.k, S.p, n, H, d.dh, I);
    for (int row = threadIdx.x; row < H * n; row += NTHREADS) {
      float* p = S.p + row * n;
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
    store(R.p, S.p, H * n * n);
    head_mix(S.p, S.v, S.u, n, d.dh, I, false, true);  // u = P v - xc Kc
    matmul(S.u, I, W.wo, W.bo, S.t1, C, n, false, S.f1, n * F);  // a
    store(R.a, S.t1, n * C);
    gate_fwd(S.t1, S.hs, W.ga1, W.gh1, S.row, n, C);
    store(R.g1, S.row, n);
    store(R.hmid, S.hs, n * C);
    layer_norm(S.hs, S.hl, W.ln2_g, W.ln2_b, n, C);
    matmul(S.hl, C, W.w1, W.b1, S.f1, F, n, false, S.u, n * I);
    store(R.f1, S.f1, n * F);
    for (int i = threadIdx.x; i < n * F; i += NTHREADS) S.f1[i] = gelu(S.f1[i]);
    __syncthreads();
    matmul(S.f1, F, W.w2, W.b2, S.t1, C, n, false, S.u, n * I);  // f
    store(R.f, S.t1, n * C);
    gate_fwd(S.t1, S.hs, W.ga2, W.gh2, S.row, n, C);
    store(R.g2, S.row, n);
  }

  // --------------------------------------------------------------- backward
  for (int i = threadIdx.x; i < n * C; i += NTHREADS) S.dh[i] = wdec[i % C];
  __syncthreads();
  for (int l = d.layers - 1; l >= 0; --l) {
    const LayerW W = layer_weights(w, d, l);
    const Resid R = resid(chain + l * resid_floats(d), d);
    // Feed-forward gated residual.
    store(S.t2, R.hmid, n * C);
    store(S.t1, R.f, n * C);
    store(S.row, R.g2, n);
    gate_bwd(S.t1, S.t2, S.row, W.ga2, W.gh2, S.dh, n, C);  // t1 = df
    store(S.f1, R.f1, n * F);
    matmul(S.t1, C, W.w2T, nullptr, S.u, F, n, false, S.q, n * I);  // u = d gelu
    for (int i = threadIdx.x; i < n * F; i += NTHREADS) S.u[i] *= gelu_grad(S.f1[i]);
    __syncthreads();
    matmul(S.u, F, W.w1T, nullptr, S.hl, C, n, false, S.q, n * I);  // d LN2 out
    layer_norm_bwd(S.t2, S.hl, W.ln2_g, S.dh, n, C);
    // Attention gated residual.
    store(S.t2, R.hin, n * C);
    store(S.t1, R.a, n * C);
    store(S.row, R.g1, n);
    gate_bwd(S.t1, S.t2, S.row, W.ga1, W.gh1, S.dh, n, C);  // t1 = da
    matmul(S.t1, C, W.woT, nullptr, S.u, I, n, false, nullptr, 0);  // u = du = d(P v)
    edge_terms_bwd(S.u, nullptr, -1.f, W.kc, S.dx, n, I);
    store(S.q, R.q, n * I);
    store(S.k, R.k, n * I);
    store(S.v, R.v, n * I);
    store(S.p, R.p, H * n * n);
    head_dots(S.u, S.v, S.ds, n, H, d.dh, I);  // dP
    for (int row = threadIdx.x; row < H * n; row += NTHREADS) {
      const float* p = S.p + row * n;
      float* ds = S.ds + row * n;
      float tot = 0.f;
      for (int j = 0; j < n; ++j) tot += p[j] * ds[j];
      for (int j = 0; j < n; ++j) ds[j] = d.scale * p[j] * (ds[j] - tot);
    }
    __syncthreads();
    head_mix(S.p, S.u, S.v, n, d.dh, I, true, false);    // v = dv = P^T du
    head_mix(S.ds, S.k, S.u, n, d.dh, I, false, false);  // u = dq = dS k
    head_mix(S.ds, S.q, S.k, n, d.dh, I, true, false);   // k = dk = dS^T q
    edge_terms_bwd(S.k, S.v, 1.f, W.kc, S.dx, n, I);
    matmul(S.u, I, W.wqT, nullptr, S.hl, C, n, false, S.f1, n * F);
    matmul(S.k, I, W.wkT, nullptr, S.hl, C, n, true, S.f1, n * F);
    matmul(S.v, I, W.wvT, nullptr, S.hl, C, n, true, S.f1, n * F);
    layer_norm_bwd(S.t2, S.hl, W.ln1_g, S.dh, n, C);
  }
  for (int i = threadIdx.x; i < 3 * n; i += NTHREADS) out[b * 3 * n + i] = -S.dx[i];
}

Dims make_dims(int n, int c, int heads, int dh, int ff, int layers) {
  Dims d;
  d.n = n; d.c = c; d.heads = heads; d.dh = dh; d.inner = heads * dh; d.ff = ff;
  d.layers = layers;
  d.scale = (float)(1.0 / std::sqrt((double)dh));
  return d;
}

}  // namespace

extern "C" {

long long fused_force_cl_weight_floats(int n, int c, int heads, int dh, int ff, int layers) {
  return weight_floats(make_dims(n, c, heads, dh, ff, layers));
}

long long fused_force_cl_scratch_floats(int n, int c, int heads, int dh, int ff, int layers) {
  const Dims d = make_dims(n, c, heads, dh, ff, layers);
  return d.layers * resid_floats(d);
}

const char* cudaGetErrorString_port(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one block per chain on `stream`. Returns a cudaError_t code
// (0 on success): a refused launch never runs, so the caller must check it.
int fused_force_cl_launch(const float* x, float* out, const float* w, float* scratch,
                          float t, int batch, int n, int c, int heads, int dh, int ff,
                          int layers, void* stream) {
  const Dims d = make_dims(n, c, heads, dh, ff, layers);
  if (n < 1 || n > MAX_N || c % 4 || dh % 4 || ff % 4 || ff > d.inner || batch < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_force_cl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  fused_force_cl_kernel<<<batch, NTHREADS, smem, (cudaStream_t)stream>>>(x, out, w, scratch,
                                                                           t, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
