// Hopper (sm_90a) backward of the Mamba2 SSD intra-chunk block, the
// function of ssd_chunk.cu (the port of repro/kernels/ssd_chunk.py::
// ssd_intra_chunk).  The TPU kernel has no backward: the reference
// autodiffs its jnp ssd_chunked (repro/models/ssm.py), so this kernel
// replaces that autodiff.  Per (batch*chunk bc, head h), with
// clog = cumsum(da), L_ij = exp(clog_i - clog_j) for i >= j (else 0),
// s = C Bᵀ, att = s ⊙ L ⊙ dt_j and w_j = exp(clog_last - clog_j) dt_j:
//
//   datt = dY Xᵀ                 ds = datt ⊙ L ⊙ dt_j     K = datt ⊙ s ⊙ L
//   dx   = attᵀ dY + w ⊙ (B dS)  dw_j = (B dS)_j . x_j    M = K ⊙ dt_j
//   ddt_j  = Σ_i K_ij + dw_j exp(clog_last - clog_j)
//   dclog_i = Σ_j M_ij - Σ_j M_ji - dw_i w_i  (+ Σ_j dw_j w_j at the last)
//   dda  = reverse cumsum of dclog
//
// and per B/C group g, over its heads:  D = Σ_h ds_h,  dC = D B,
// dB = Dᵀ C + Σ_h w_h ⊙ (X_h dS_hᵀ).
//
// fp32 throughout: x, dt, da, b, c, dy and dstate in, dx, ddt, dda, db, dc
// out.  Training casts every SSD operand to fp32 (as the reference
// does), so there is no bf16 form; the wrapper refuses one.
//
// The masked decay: a pair j > i never reaches the exponential.  Its
// difference clog_i - clog_j is positive and passes expf's range (88.7)
// at mamba2's decays over 128 tokens; autodiff of the reference's
// where(mask, exp(diff), 0) turns that inf into NaN (0 · inf).  Here it
// is not formed, so every gradient is finite.
//
// What bounds it: at mamba2-780m's training shape (BC 128, Q 128, H 48,
// P 64, N 128, one group) a call moves about 851 MB (x, dy, dstate, dx at
// 201 MB each) for about 2e10 multiply-adds on the causal half: about 47
// operations per byte, above the fp32 FMA balance point (67 TFLOP/s
// against 3.35 TB/s, 20), so operations.  This first kernel takes every
// product on fp32 FMAs from shared memory (a 16 x 16 thread grid, each
// thread an 8 x 8 or 8 x 4 register tile, rows and columns strided by
// 16, row strides padded odd so no read conflicts), computes the full
// square of each Q x Q product and masks it, and recomputes datt in a
// second grid rather than write a Q x Q matrix per head to device
// memory.  Four launches, stream-ordered, no atomics, every sum in a
// fixed order, so repeated calls give bit-identical outputs:
//
// 1. gram:   per (bc, group) G = C Bᵀ (Q x Q) into scratch, once per group
//            whatever the number of heads that read it.
// 2. heads:  per (bc, head): datt, K, att (in shared memory), the row and
//            column sums for ddt and dclog, dx = attᵀ dY + w ⊙ (B dS),
//            dw, ddt and dda (warp scans in fp64, rounded once).
// 3. slices: per (bc, group, slice of at most kSliceHeads heads): D and
//            Σ w ⊙ X dSᵀ over the slice's heads in head order (D in
//            registers, the other in shared memory), to scratch.
// 4. groups: per (bc, group): the slices' sums in slice order, then
//            dC = D B and dB = Dᵀ C + Σ.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/ssd_chunk.py) allocates the outputs and scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kMax = 128;      // Q, N, P at most; tiles cover 128 rows
constexpr int kSq = kMax + 1;  // row stride of a 128-column tile (odd)
constexpr int kSliceHeads = 8;

struct Args {
  const float *x, *dt, *da, *b, *c, *dy, *dstate;
  float *dx, *ddt, *dda, *db, *dc;
  float *gram, *dpart, *epart;  // (BC,G,Q,Q), (BC,G,S,Q,Q), (BC,G,S,Q,N)
  long long BC;
  int Q, H, P, N, G, rep, hs, slices, PS;  // PS: row stride of a P tile
};

// acc[m][n] += Σ_{k<K} A(ty + 16m, k) B(k, tx + 16n), A(r, k) at
// A[r ars + k aks] and B(k, c) at B[k bks + c bcs], all in shared memory
template <int RM, int RN>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], const float* A,
                                   int ars, int aks, const float* B, int bks,
                                   int bcs, int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int m = 0; m < RM; ++m) a[m] = A[(ty + 16 * m) * ars + k * aks];
#pragma unroll
    for (int n = 0; n < RN; ++n) b[n] = B[k * bks + (tx + 16 * n) * bcs];
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int n = 0; n < RN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
  }
}

// rows x cols floats of a (row stride rs) into dst (row stride ds), the
// tile's kMax rows and `pad` columns, zero outside [0, rows) x [0, cols)
__device__ __forceinline__ void load_tile(float* dst, int ds, const float* src,
                                          long long rs, int rows, int cols,
                                          int pad) {
  for (int e = threadIdx.x; e < kMax * pad; e += kThreads) {
    const int r = e / pad, q = e - r * pad;
    dst[r * ds + q] = (r < rows && q < cols) ? src[r * rs + q] : 0.f;
  }
}

// In-place inclusive cumsum of v[0..Q) (reverse: v_j = Σ_{i>=j} v_i) by
// one warp, four tokens a lane; sums in fp64, each result rounded once
__device__ __forceinline__ void warp_scan(float* v, int Q, int lane,
                                          bool reverse) {
  double s[4], run = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    run += j < Q ? (double)v[reverse ? Q - 1 - j : j] : 0.0;
    s[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.0;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    if (j < Q) v[reverse ? Q - 1 - j : j] = (float)(before + s[k]);
  }
}

// sum over the 16 lanes of a half warp (the tx of one ty), fixed order
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// clog = cumsum(da), dts = dt of head h (zero past Q), then
// e_j = exp(clog_last - clog_j) and w_j = e_j dt_j; ends synchronised
__device__ __forceinline__ void decay(const Args& a, long long bc, int h,
                                      float* clog, float* dts, float* es,
                                      float* ws) {
  const int t = threadIdx.x;
  if (t < kMax) {
    const long long at = (bc * a.Q + t) * a.H + h;
    clog[t] = t < a.Q ? a.da[at] : 0.f;
    dts[t] = t < a.Q ? a.dt[at] : 0.f;
  }
  __syncthreads();
  if (t < 32) warp_scan(clog, a.Q, t, false);
  __syncthreads();
  if (t < kMax) {
    const float e = t < a.Q ? expf(clog[a.Q - 1] - clog[t]) : 0.f;
    es[t] = e;
    ws[t] = e * dts[t];
  }
  __syncthreads();
}

// 1. G = C Bᵀ of group g, (Q, Q) into scratch
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_gram_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const long long bc = blockIdx.x / a.G;
  const int g = blockIdx.x % a.G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* cs = sm;
  float* bs = sm + kMax * kSq;
  const long long at = (bc * a.Q * a.G + g) * a.N;
  const long long rs = (long long)a.G * a.N;
  load_tile(cs, kSq, a.c + at, rs, a.Q, a.N, kMax);
  load_tile(bs, kSq, a.b + at, rs, a.Q, a.N, kMax);
  __syncthreads();
  float acc[8][8] = {};
  mm(acc, cs, kSq, 1, bs, 1, kSq, a.N, ty, tx);
  float* gm = a.gram + (bc * a.G + g) * a.Q * (long long)a.Q;
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = ty + 16 * m, j = tx + 16 * n;
      if (i < a.Q && j < a.Q) gm[(long long)i * a.Q + j] = acc[m][n];
    }
}

// 2. per (bc, head): dx, ddt, dda
template <int RN>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_heads_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const long long bc = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H, g = h / a.rep;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int PS = a.PS, pad = 16 * RN;
  float* xs = sm;                   // x_h (Q, P)
  float* ys = xs + kMax * PS;       // dY_h, then dS_h (N, P)
  float* W = ys + kMax * PS;        // att (i, j), then B_g (j, n)
  float* clog = W + kMax * kSq;
  float* dts = clog + kMax;
  float* es = dts + kMax;
  float* ws = es + kMax;
  float* rowm = ws + kMax;          // Σ_j M_ij
  float* colm = rowm + kMax;        // Σ_i M_ij, then dclog
  float* colk = colm + kMax;        // Σ_i K_ij
  float* dwv = colk + kMax;
  float* stage = dwv + kMax;        // (2, 16, kMax) column partials by ty
  const long long xrow = (long long)a.H * a.P;
  const long long xo = (bc * a.Q * a.H + h) * a.P;
  load_tile(xs, PS, a.x + xo, xrow, a.Q, a.P, pad);
  load_tile(ys, PS, a.dy + xo, xrow, a.Q, a.P, pad);
  decay(a, bc, h, clog, dts, es, ws);

  {  // datt = dY Xᵀ; K, M, att; row and column sums
    float t[8][8] = {};
    mm(t, ys, PS, 1, xs, 1, PS, a.P, ty, tx);
    const float* gm = a.gram + (bc * a.G + g) * a.Q * (long long)a.Q;
    float cm[8] = {}, ck[8] = {};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = ty + 16 * m;
      float rm = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = tx + 16 * n;
        float att = 0.f;
        if (j <= i && i < a.Q) {  // a masked pair never reaches the exp
          const float sl =
              gm[(long long)i * a.Q + j] * expf(clog[i] - clog[j]);
          const float k = t[m][n] * sl;
          const float mv = k * dts[j];
          att = sl * dts[j];
          rm += mv;
          cm[n] += mv;
          ck[n] += k;
        }
        W[i * kSq + j] = att;
      }
      rm = half_warp_sum(rm);
      if (tx == 0) rowm[i] = rm;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      stage[ty * kMax + tx + 16 * n] = cm[n];
      stage[(16 + ty) * kMax + tx + 16 * n] = ck[n];
    }
  }
  __syncthreads();
  if (threadIdx.x < kMax) {  // column sums over ty, in order
    const int j = threadIdx.x;
    float sm_ = 0.f, sk = 0.f;
    for (int r = 0; r < 16; ++r) {
      sm_ += stage[r * kMax + j];
      sk += stage[(16 + r) * kMax + j];
    }
    colm[j] = sm_;
    colk[j] = sk;
  }
  float dx1[8][RN] = {};
  mm(dx1, W, 1, kSq, ys, PS, 1, a.Q, ty, tx);  // attᵀ dY
  __syncthreads();
  // B of group g into W, dS_h into ys
  const long long bo = (bc * a.Q * a.G + g) * a.N;
  load_tile(W, kSq, a.b + bo, (long long)a.G * a.N, a.Q, a.N, kMax);
  load_tile(ys, PS, a.dstate + (bc * a.H + h) * a.N * (long long)a.P, a.P,
            a.N, a.P, pad);
  __syncthreads();
  {
    float u[8][RN] = {};
    mm(u, W, kSq, 1, ys, PS, 1, a.N, ty, tx);  // B dS
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = ty + 16 * m;
      float dw = 0.f;
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int p = tx + 16 * n;
        if (j < a.Q && p < a.P) {
          a.dx[xo + j * xrow + p] = fmaf(ws[j], u[m][n], dx1[m][n]);
          dw = fmaf(u[m][n], xs[j * PS + p], dw);
        }
      }
      dw = half_warp_sum(dw);
      if (tx == 0) dwv[j] = dw;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // ddt, dclog, then dda = its reverse cumsum
    const int lane = threadIdx.x;
    float last = 0.f;
    for (int j = lane; j < a.Q; j += 32) last = fmaf(dwv[j], ws[j], last);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      last += __shfl_xor_sync(0xffffffffu, last, off);
    for (int j = lane; j < a.Q; j += 32) {
      const long long at = (bc * a.Q + j) * a.H + h;
      a.ddt[at] = fmaf(dwv[j], es[j], colk[j]);
      float dcl = rowm[j] - colm[j] - dwv[j] * ws[j];
      if (j == a.Q - 1) dcl += last;
      colm[j] = dcl;
    }
    __syncwarp();
    warp_scan(colm, a.Q, lane, true);
    __syncwarp();
    for (int j = lane; j < a.Q; j += 32)
      a.dda[(bc * a.Q + j) * a.H + h] = colm[j];
  }
}

// 3. per (bc, group, slice): Σ_h ds_h and Σ_h w_h ⊙ X_h dS_hᵀ, head order
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_slices_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  long long t = blockIdx.x;
  const int sl = (int)(t % a.slices);
  t /= a.slices;
  const int g = (int)(t % a.G);
  const long long bc = t / a.G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int PS = a.PS;
  float* xs = sm;
  float* ys = xs + kMax * PS;   // dY_h, then dS_h
  float* es_ = ys + kMax * PS;  // Σ w ⊙ X dSᵀ (j, n)
  float* clog = es_ + kMax * kSq;
  float* dts = clog + kMax;
  float* ev = dts + kMax;
  float* ws = ev + kMax;
  for (int e = threadIdx.x; e < kMax * kSq; e += kThreads) es_[e] = 0.f;
  float D[8][8] = {};
  const long long xrow = (long long)a.H * a.P;
  const int h0 = g * a.rep + sl * a.hs;
  const int h1 = min(h0 + a.hs, (g + 1) * a.rep);
  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the previous head's reads are done
    const long long xo = (bc * a.Q * a.H + h) * a.P;
    load_tile(xs, PS, a.x + xo, xrow, a.Q, a.P, a.P);
    load_tile(ys, PS, a.dy + xo, xrow, a.Q, a.P, a.P);
    decay(a, bc, h, clog, dts, ev, ws);
    {
      float d[8][8] = {};
      mm(d, ys, PS, 1, xs, 1, PS, a.P, ty, tx);  // datt = dY Xᵀ
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = ty + 16 * m;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int j = tx + 16 * n;
          if (j <= i && i < a.Q)
            D[m][n] = fmaf(d[m][n] * expf(clog[i] - clog[j]), dts[j], D[m][n]);
        }
      }
    }
    __syncthreads();
    load_tile(ys, PS, a.dstate + (bc * a.H + h) * a.N * (long long)a.P, a.P,
              a.N, a.P, a.P);
    __syncthreads();
    {
      float e[8][8] = {};
      mm(e, xs, PS, 1, ys, 1, PS, a.P, ty, tx);  // X dSᵀ (j, n)
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int j = ty + 16 * m;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* dst = es_ + j * kSq + tx + 16 * n;
          *dst = fmaf(ws[j], e[m][n], *dst);
        }
      }
    }
  }
  const long long part = (bc * a.G + g) * a.slices + sl;
  float* dp = a.dpart + part * a.Q * (long long)a.Q;
  float* ep = a.epart + part * a.Q * (long long)a.N;
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int r = ty + 16 * m, q = tx + 16 * n;
      if (r < a.Q && q < a.Q) dp[(long long)r * a.Q + q] = D[m][n];
      if (r < a.Q && q < a.N)
        ep[(long long)r * a.N + q] = es_[r * kSq + q];
    }
}

// 4. per (bc, group): D and Σ over slices in order; dC = D B,
// dB = Dᵀ C + Σ
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_groups_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const long long bc = blockIdx.x / a.G;
  const int g = blockIdx.x % a.G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* ds = sm;
  float* bs = sm + kMax * kSq;
  const long long part0 = (bc * a.G + g) * a.slices;
  const long long QQ = a.Q * (long long)a.Q, QN = a.Q * (long long)a.N;
  for (int e = threadIdx.x; e < kMax * kMax; e += kThreads) {
    const int i = e / kMax, j = e - i * kMax;
    float v = 0.f;
    if (i < a.Q && j < a.Q)
      for (int s = 0; s < a.slices; ++s)
        v += a.dpart[(part0 + s) * QQ + (long long)i * a.Q + j];
    ds[i * kSq + j] = v;
  }
  const long long at = (bc * a.Q * a.G + g) * a.N;
  const long long rs = (long long)a.G * a.N;
  load_tile(bs, kSq, a.b + at, rs, a.Q, a.N, kMax);
  __syncthreads();
  {
    float acc[8][8] = {};
    mm(acc, ds, kSq, 1, bs, kSq, 1, a.Q, ty, tx);  // dC = D B
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = ty + 16 * m, q = tx + 16 * n;
        if (i < a.Q && q < a.N) a.dc[at + i * rs + q] = acc[m][n];
      }
  }
  __syncthreads();
  load_tile(bs, kSq, a.c + at, rs, a.Q, a.N, kMax);
  __syncthreads();
  float acc[8][8] = {};
  mm(acc, ds, 1, kSq, bs, kSq, 1, a.Q, ty, tx);  // Dᵀ C
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = ty + 16 * m, q = tx + 16 * n;
      if (j < a.Q && q < a.N) {
        float v = acc[m][n];
        for (int s = 0; s < a.slices; ++s)
          v += a.epart[(part0 + s) * QN + (long long)j * a.N + q];
        a.db[at + j * rs + q] = v;
      }
    }
}

constexpr int kMaxDevices = 64;

int gram_smem() { return 2 * kMax * kSq * (int)sizeof(float); }
int heads_smem(int PS) {
  return (2 * kMax * PS + kMax * kSq + 8 * kMax + 32 * kMax) *
         (int)sizeof(float);
}
int slices_smem(int PS) {
  return (2 * kMax * PS + kMax * kSq + 4 * kMax) * (int)sizeof(float);
}

// Above 48 KB of dynamic shared memory a launch needs an opt-in, set once
// per device to what the largest shape (P = 128) takes
cudaError_t allow_shared_memory() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(ssd_bwd_gram_kernel, attr, gram_smem());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_groups_kernel, attr, gram_smem());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_heads_kernel<4>, attr,
                               heads_smem(65));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_heads_kernel<8>, attr,
                               heads_smem(kSq));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_slices_kernel, attr,
                               slices_smem(kSq));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

// All pointers fp32 and contiguous: x, dy, dx (BC,Q,H,P); dt, da, ddt, dda
// (BC,Q,H); b, c, db, dc (BC,Q,G,N), head h reading group h / (H / G);
// dstate (BC,H,N,P).  Scratch: gram BC*G*Q*Q, dpart BC*G*S*Q*Q and epart
// BC*G*S*Q*N floats, S = ceil((H / G) / heads_per_slice).
// 1 <= Q, N, P <= 128; heads_per_slice must be min(H / G, 8), the
// wrapper's plan (ssd_bwd_plan), or the call is refused.  Four launches on
// `stream`.  Returns the first CUDA error (0 = queued).
extern "C" int ssd_intra_chunk_bwd_launch(
    const float* x, const float* dt, const float* da, const float* b,
    const float* c, const float* dy, const float* dstate, float* dx,
    float* ddt, float* dda, float* db, float* dc, float* gram, float* dpart,
    float* epart, long long BC, int Q, int H, int P, int N, int G,
    int heads_per_slice, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BC < 1 || Q < 1 || Q > kMax || N < 1 || N > kMax || P < 1 ||
      P > kMax || G < 1 || H < G || H % G)
    return (int)cudaErrorInvalidValue;
  const int rep = H / G;
  const int hs = rep < kSliceHeads ? rep : kSliceHeads;
  if (heads_per_slice != hs) return (int)cudaErrorInvalidValue;
  const int slices = (rep + hs - 1) / hs;
  if (BC * H > 0x7fffffffLL || BC * G * slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool wide = P > 64;
  const int PS = wide ? kSq : 65;
  const Args a{x,   dt,  da,    b,     c,     dy, dstate, dx, ddt,
               dda, db,  dc,    gram,  dpart, epart, BC,  Q,  H,
               P,   N,   G,     rep,   hs,    slices, PS};
  cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_gram_kernel<<<(unsigned)(BC * G), kThreads, gram_smem(), st>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (wide)
    ssd_bwd_heads_kernel<8>
        <<<(unsigned)(BC * H), kThreads, heads_smem(PS), st>>>(a);
  else
    ssd_bwd_heads_kernel<4>
        <<<(unsigned)(BC * H), kThreads, heads_smem(PS), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_slices_kernel<<<(unsigned)(BC * G * slices), kThreads,
                          slices_smem(PS), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_groups_kernel<<<(unsigned)(BC * G), kThreads, gram_smem(), st>>>(
      a);
  return (int)cudaGetLastError();
}
