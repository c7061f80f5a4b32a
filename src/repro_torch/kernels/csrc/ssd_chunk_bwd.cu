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
// dB = Dᵀ C + E,  E = Σ_h w_h ⊙ (X_h dS_hᵀ).
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
// 201 MB each) for about 2e10 multiply-adds on the causal half, which as
// 3xTF32 products (three tensor-core products each) take about as long at
// the TF32 peak as the bytes at the memory's: both about 0.25 ms.  The
// design runs every product on the tensor cores, forms each Q x Q product
// on its causal tiles only, forms datt once per head, and reads x, dy and
// dstate once:
//
// * Two grids, stream-ordered.  A heads CTA (bc, group, slice) walks the
//   slice's heads (at most kSliceHeads, the wrapper's ssd_bwd_plan; the
//   launcher refuses another split) in head order.  It loads B and C of
//   its group once and keeps its Gram s = C Bᵀ in registers; per head it
//   forms datt, K, M, att and ds on the causal tiles, writes dx, ddt and
//   dda, and adds ds into D (registers) and w ⊙ X dSᵀ into E (registers)
//   in head order.  At the end it stores D and E as the slice's partial
//   sums.  A group CTA (bc, group, 32 columns of n) sums the slices' D and
//   E in slice order and forms dC = D B and dB = Dᵀ C + E.
// * Per head, in 64-column passes of the head dim (one at P <= 64): the
//   datt pass (dY Xᵀ on the causal 16 x 8 tiles, two column parities of a
//   strip pair per warp, 9 tiles each at Q = 128; the decay masked only on
//   diagonal tiles and rows past Q; att into shared memory, packed by
//   16-row strip; the column sums of K and M reduced over the lanes three
//   tiles at a time), the E pass (X dSᵀ per 16-row strip, dw = Σ_n B_jn
//   (X dSᵀ)_jn beside it), then the dx pass (B dS, then attᵀ dY on the
//   causal k only, summed onto w ⊙ B dS; a strip pair and half the columns
//   per warp).  datt is linear in the passes' sums, so K, M and ds of a
//   pass add up.  The next head's x is copied (cp.async) during the dx
//   pass, its dY and dS after it, its dt and da fetched before it.
// * The tensor cores at fp32 accuracy: mma.sync m16n8k8 TF32 with the
//   3xTF32 split (tf32_mma.cuh, shared with the forward): hi.hi in one
//   sum, hi.lo + lo.hi in another.  mma.sync and not wgmma: TF32 wgmma
//   takes only K-major operands, and these products reduce over the row
//   axis of x, dY, dS, B and C.
// * Shared memory: B (and C before the first head) and one head's x, dY,
//   dS and att, 226 KB, one CTA an SM; the Gram, D and E (136 registers a
//   thread) stay in registers.  Row strides 8 mod 32 (x, dY, dS, att) and
//   4 mod 32 (B, C) keep every fragment read free of bank conflicts.  The
//   heads kernel has three instances: Q = 128 with P a multiple of 64
//   and N = 128 (mamba2) or N = 64 (zamba2), every loop bound a constant,
//   and the ragged shapes (Q, N, P any of 1..128, zero-filled and masked
//   on store), whose runtime bounds cost it half again its time at the
//   same shape (1.52x, measured on an H100 at 700 W).
// * No atomics, every sum in a fixed order, so repeated calls give
//   bit-identical outputs.  The fp64 warp scans of clog and dda are
//   rounded once.
//
// What holds it back (measured on an H100, 700 W; PERF.md §6): the
// 3xTF32 inner loops split every fragment they load, which caps them at
// about 0.4 tensor-core products a clock an SM against mma.sync's 0.66,
// and the resident Gram, D and E leave no registers for larger warp
// tiles (255 a thread); the datt pass's decay and sums add about a sixth.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/ssd_chunk.py) allocates the outputs and scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 128;        // Q, N, P at most
constexpr int kPC = 64;          // head-dim columns a pass
constexpr int kXS = kPC + 8;     // row stride of x, dY, dS (8 mod 32)
constexpr int kBS = kMax + 4;    // row stride of B, C, D (4 mod 32)
constexpr int kSlots = 9;        // datt tiles a warp, at most
constexpr int kSliceHeads = 16;  // heads a slice, at most
constexpr int kNB = 32;          // columns n a group CTA
constexpr int kGB = kNB + 8;     // row stride of a group CTA's B (8 mod 32)
constexpr int kGC = kNB + 4;     // and of its C (4 mod 32)

// The heads CTA's shared memory (floats): B, x, dY, dS, att, vectors; C
// over dS and att until the Gram is formed.  att is packed by 16-row
// strip s: its 16(s+1) columns at row stride 16(s+1) + 8 (8 mod 16).
constexpr int kOffX = kMax * kBS;
constexpr int kOffY = kOffX + kMax * kXS;
constexpr int kOffS = kOffY + kMax * kXS;
constexpr int kOffAt = kOffS + kMax * kXS;
constexpr int kOffVec = kOffAt + 16 * 8 * 80;  // Σ_s 16 (16 s + 24)
// vectors: clog, dt, e, w, dw; row sums by column parity (2); column sums
// of K and of M by strip (8 each)
constexpr int kVClog = 0, kVDt = kMax, kVE = 2 * kMax, kVW = 3 * kMax,
              kVDw = 4 * kMax, kVRow = 5 * kMax, kVColK = 7 * kMax,
              kVColM = 15 * kMax, kVecFloats = 23 * kMax;
constexpr int kHeadsFloats = kOffVec + kVecFloats;
static_assert(kOffS + kMax * kBS <= kOffVec, "C fits over dS and att");
// the group CTA's: D (Q x Q), B and C (Q x 32)
constexpr int kGroupFloats = kMax * (kBS + kGB + kGC);

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

struct Args {
  const float *x, *dt, *da, *b, *c, *dy, *dstate;
  float *dx, *ddt, *dda, *db, *dc;
  float *dpart, *epart;  // (BC, G, slices, Q, Q) and (.., Q, N) scratch
  int Q, H, P, N, G, rep, hs, slices;
  int S, pairs, Qp, N8, passes, nblk;  // strips, their pairs, Q to 16, ...
  bool vec_p, vec_n;  // 16-byte copies of x / dy / dstate rows, b / c rows
  // elements each array holds (x, dy, dx; dt, da, ddt, dda; b, c, db, dc;
  // dstate; the two scratch arrays): the limits of the checked build
  long long n_x, n_dt, n_bc, n_ds, n_dpart, n_epart;
};

// The source of a copy: `src` lies at element `at` of an array of `n`
// elements (the checked build asserts every element read inside it).
struct Src {
  const char* name;
  long long at, n;
};

__device__ __forceinline__ int at_base(int s) { return 128 * s * (s + 2); }
__device__ __forceinline__ int at_stride(int s) { return 16 * s + 24; }
__device__ __forceinline__ int at_index(int i, int j) {
  return at_base(i >> 4) + (i & 15) * at_stride(i >> 4) + j;
}

// rows x cols floats (cols a multiple of 4 when vec) into dst (row stride
// ds) from src (row r at src + r rs), zero where r >= vrows or the column
// >= vcols: cp.async, 16-byte pieces when `vec` (vcols and the rows'
// starts then multiples of 4 floats).  A piece not copied reads nothing.
__device__ __forceinline__ void copy_rows(float* dst, int ds, const float* src,
                                          long long rs, int rows, int cols,
                                          int vrows, int vcols, bool vec,
                                          const Src& from) {
  if (vec) {
    const int pieces = cols / 4;
    for (int e = threadIdx.x; e < rows * pieces; e += kThreads) {
      const int r = e / pieces, q = 4 * (e - r * pieces);
      const bool ok = r < vrows && q < vcols;
      if (ok) LRK_CHECK(from.name, from.at + r * rs + q + 3, from.n);
      cp16(dst + r * ds + q, ok ? src + r * rs + q : src, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, q = e - r * cols;
    const bool ok = r < vrows && q < vcols;
    if (ok) LRK_CHECK(from.name, from.at + r * rs + q, from.n);
    cp4(dst + r * ds + q, ok ? src + r * rs + q : src, ok);
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
    if (j < Q) LRK_SMEM(v + (reverse ? Q - 1 - j : j), 4);
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
    if (j < Q) LRK_SMEM(v + (reverse ? Q - 1 - j : j), 4);
    if (j < Q) v[reverse ? Q - 1 - j : j] = (float)(before + s[k]);
  }
}

// The causal datt tiles (16 rows i x 8 columns j) of a warp: strips a =
// pair and b = S-1-pair (rows 16a.., 16b..), the column blocks cb < 2s + 2
// that hold a token, of one parity (the warp's lowest bit).  Slot k < na
// is strip a's block par + 2k, then strip b's.  At Q = 128: 9 tiles each.
struct Slots {
  int a, b, na, nb, par;
  __device__ __forceinline__ Slots(const Args& g, int warp) {
    const int pair = warp >> 1;
    par = warp & 1;
    a = pair;
    b = g.S - 1 - pair;
    const int cbq = cdiv(g.Q, 8);
    auto tiles = [&](int s) {
      return (imin(2 * s + 2, cbq) - par + 1) / 2;
    };
    na = pair < g.pairs ? tiles(a) : 0;
    nb = pair < g.pairs && b > a ? tiles(b) : 0;
  }
  __device__ __forceinline__ bool has(int k) const { return k < na + nb; }
  __device__ __forceinline__ int strip(int k) const { return k < na ? a : b; }
  __device__ __forceinline__ int block(int k) const {
    return par + 2 * (k < na ? k : k - na);
  }
};

// The decay of head h: dt, da of token t (zero past Q), fetched into
// registers a head ahead (during the previous head's dx pass)
struct Decay {
  float dt, da;
};
__device__ __forceinline__ Decay fetch_decay(const Args& a, long long bc,
                                             int h) {
  const int t = threadIdx.x;
  const bool in = t < a.Q;
  const long long at = (bc * a.Q + t) * a.H + h;
  if (in) LRK_CHECK("dt, da", at, a.n_dt);
  return {in ? a.dt[at] : 0.f, in ? a.da[at] : 0.f};
}

// one pass's copies: x or dY of head h, columns [64 c, +64), Qp rows; dS
// rows n < N8
__device__ __forceinline__ void copy_xy(const Args& a, float* dst,
                                        const float* src, long long bc,
                                        int h, int c) {
  const int p0 = kPC * c, pw = imin(kPC, a.P - p0);
  const long long rs = (long long)a.H * a.P;
  const long long at = (bc * a.Q * a.H + h) * a.P + p0;
  LRK_CHECK("x, dY (shared)", (a.Qp - 1) * kXS + ((pw + 7) & ~7) - 1,
            kMax * kXS);
  copy_rows(dst, kXS, src + at, rs, a.Qp, (pw + 7) & ~7, a.Q, pw, a.vec_p,
            Src{"x, dy", at, a.n_x});
}
__device__ __forceinline__ void copy_ds(const Args& a, float* dst,
                                        long long bc, int h, int c) {
  const int p0 = kPC * c, pw = imin(kPC, a.P - p0);
  const long long at = (bc * a.H + h) * a.N * (long long)a.P + p0;
  LRK_CHECK("dS (shared)", (a.N8 - 1) * kXS + ((pw + 7) & ~7) - 1,
            kMax * kXS);
  copy_rows(dst, kXS, a.dstate + at, a.P, a.N8, (pw + 7) & ~7, a.N, pw,
            a.vec_p, Src{"dstate", at, a.n_ds});
}

// sum over the lanes of one g (xor over t)
__device__ __forceinline__ float sum_over_t(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// 1. per (bc, group, slice): the slice's heads in order.  kFull: Q = 128
// and P a multiple of 64, every loop bound and tile count over Q and P a
// constant; kN > 0: N (its multiple of 8) is kN, every bound over N a
// constant (mamba2's shapes take <true, 128>, zamba2's <true, 64>); else
// the ragged shapes, zero-filled and masked.
template <bool kFull, int kN>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_heads_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  long long blk = blockIdx.x;
  const int sl = (int)(blk % a.slices);
  blk /= a.slices;
  const int grp = (int)(blk % a.G);
  const long long bc = blk / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* bs = sm;
  float* xs = sm + kOffX;
  float* ys = sm + kOffY;
  float* dss = sm + kOffS;
  float* cs = sm + kOffS;  // C until the Gram is formed
  float* at = sm + kOffAt;
  float* vec = sm + kOffVec;
  float* clog = vec + kVClog;
  float* dts = vec + kVDt;
  float* es = vec + kVE;
  float* ws = vec + kVW;
  float* dwv = vec + kVDw;
  float* rowp = vec + kVRow;
  float* colk = vec + kVColK;
  float* colm = vec + kVColM;
  const int h0 = grp * a.rep + sl * a.hs;
  const int h1 = imin(h0 + a.hs, (grp + 1) * a.rep);
  const Slots slots(a, warp);
  const int Q = kFull ? kMax : a.Q, N8 = kN ? kN : a.N8;
  const int Qp = kFull ? kMax : a.Qp, S = kFull ? 8 : a.S;
  const int pairs = kFull ? 4 : a.pairs;

  // B and C of the group, then x and dY of the first head
  {
    const long long go = (bc * a.Q * a.G + grp) * a.N;
    const long long rs = (long long)a.G * a.N;
    LRK_CHECK("B, C (shared)", (a.Qp - 1) * kBS + a.N8 - 1, kMax * kBS);
    copy_rows(bs, kBS, a.b + go, rs, a.Qp, a.N8, a.Q, a.N, a.vec_n,
              Src{"b", go, a.n_bc});
    copy_rows(cs, kBS, a.c + go, rs, a.Qp, a.N8, a.Q, a.N, a.vec_n,
              Src{"c", go, a.n_bc});
    cp_commit();
    copy_xy(a, xs, a.x, bc, h0, 0);
    cp_commit();
    copy_xy(a, ys, a.dy, bc, h0, 0);
    cp_commit();
  }
  cp_wait<2>();
  __syncthreads();
  // the Gram s = C Bᵀ on the warp's tiles, three at a time
  float gs[kSlots][4], dsum[kSlots][4];
#pragma unroll
  for (int k0 = 0; k0 < kSlots; k0 += 3) {
    float acc[3][4] = {}, cor[3][4] = {};
    for (int n = 0; n < N8; n += 8) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (!kFull && !slots.has(k0 + q)) continue;
        Frag<true, true> f;
        load_a_nat(f, cs + 16 * slots.strip(k0 + q) * kBS + n, kBS, gq,
                   tq);
        load_b_nrow_nat(f, bs + 8 * slots.block(k0 + q) * kBS + n, kBS, gq,
                        tq);
        f.mma3(acc[q], cor[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gs[k0 + q][e] = acc[q][e] + cor[q][e];
        dsum[k0 + q][e] = 0.f;
      }
  }
  float esum[kMax / 8][4];
#pragma unroll
  for (int u = 0; u < kMax / 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) esum[u][e] = 0.f;
  __syncthreads();  // C is read: dS may land over it
  copy_ds(a, dss, bc, h0, 0);
  cp_commit();

  const long long xrow = (long long)a.H * a.P;
  Decay dec = fetch_decay(a, bc, h0);
  for (int h = h0; h < h1; ++h) {
    // the head's decay: clog = cumsum(da), e_j, w_j; partial sums zeroed
    __syncthreads();  // the previous head's last reads of the vectors
    for (int e = threadIdx.x; e < kVecFloats - kVDw; e += kThreads) {
      LRK_CHECK("vectors", kVDw + e, kVecFloats);
      vec[kVDw + e] = 0.f;
    }
    if (threadIdx.x < kMax) {
      LRK_SMEM(dts + threadIdx.x, 4);
      LRK_SMEM(clog + threadIdx.x, 4);
      dts[threadIdx.x] = dec.dt;
      clog[threadIdx.x] = dec.da;
    }
    __syncthreads();
    if (warp == 0) warp_scan(clog, Q, lane, false);
    __syncthreads();
    if (threadIdx.x < kMax) {
      const int t = threadIdx.x;
      LRK_CHECK("clog", Q - 1, kMax);
      const float e = t < Q ? expf(clog[Q - 1] - clog[t]) : 0.f;
      es[t] = e;
      ws[t] = e * dts[t];
    }
    for (int c = 0; c < a.passes; ++c) {
      const int p0 = kPC * c, pw = kFull ? kPC : imin(kPC, a.P - p0);
      const int pw8 = kFull ? kPC : (pw + 7) & ~7;
      const bool last = h + 1 == h1 && c + 1 == a.passes;
      const int hn = c + 1 < a.passes ? h : h + 1;
      const int cn = c + 1 < a.passes ? c + 1 : 0;
      cp_wait<1>();   // x and dY of this pass
      __syncthreads();

      // -- datt = dY Xᵀ on the warp's causal tiles; K, M, att, ds
      float rsum[2][2] = {};  // row sums of M: strip a, b x rows g, g + 8
#pragma unroll
      for (int k0 = 0; k0 < kSlots; k0 += 3) {
        float acc[3][4] = {}, cor[3][4] = {};
        for (int p = 0; p < pw8; p += 8) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            if (!kFull && !slots.has(k0 + q)) continue;
            Frag<true, true> f;
            load_a(f, ys + 16 * slots.strip(k0 + q) * kXS + p, kXS, gq,
                   tq);
            load_b_nrow(f, xs + 8 * slots.block(k0 + q) * kXS + p, kXS, gq,
                        tq);
            f.mma3(acc[q], cor[q]);
          }
        }
        // the three tiles' column sums of K and M (columns 2t, 2t + 1),
        // reduced over g together
        float col[3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int k = k0 + q;
#pragma unroll
          for (int e = 0; e < 4; ++e) col[q][e] = 0.f;
          if (!kFull && !slots.has(k)) continue;
          const int s = slots.strip(k), cb = slots.block(k);
          const int i0 = 16 * s + gq, j0 = 8 * cb + 2 * tq;
          // diagonal tiles and the rows past Q are masked, no others: a
          // masked pair's exponent is -inf (L = 0), so its difference
          // never reaches the exponential
          const bool full = cb < 2 * s && (kFull || 16 * s + 16 <= Q);
          LRK_CHECK("clog, dt", j0 + 1, kMax);
          const float2 cj = *reinterpret_cast<const float2*>(clog + j0);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = i0 + 8 * hr;
            LRK_CHECK("clog", i, kMax);
            const float ci = clog[i];
            float av[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + e;
              const float d = acc[q][2 * hr + e] + cor[q][2 * hr + e];
              const float dtj = e ? dj.y : dj.x;
              const bool in = full || (j <= i && i < Q);
              const float L = __expf(in ? ci - (e ? cj.y : cj.x) : -INFINITY);
              const float sl_ = gs[k][2 * hr + e] * L;
              const float kv = d * sl_, mv = kv * dtj;
              av[e] = sl_ * dtj;
              dsum[k][2 * hr + e] = fmaf(d * L, dtj, dsum[k][2 * hr + e]);
              col[q][e] += kv;
              col[q][2 + e] += mv;
              if (k < slots.na) rsum[0][hr] += mv;
              else rsum[1][hr] += mv;
            }
            LRK_CHECK("att", at_index(i, j0) + 1, kOffVec - kOffAt);
            *reinterpret_cast<float2*>(at + at_index(i, j0)) =
                make_float2(av[0], av[1]);
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              col[q][e] += __shfl_xor_sync(0xffffffffu, col[q][e], off);
        if (gq == 0) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int k = k0 + q;
            if (!kFull && !slots.has(k)) continue;
            const int s = slots.strip(k);
            const int j0 = 8 * slots.block(k) + 2 * tq;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              LRK_CHECK("column sums", s * kMax + j0 + e, 8 * kMax);
              colk[s * kMax + j0 + e] += col[q][e];
              colm[s * kMax + j0 + e] += col[q][2 + e];
            }
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            rsum[st][hr] += __shfl_xor_sync(0xffffffffu, rsum[st][hr], off);
      if (tq == 0) {
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          if (st == 0 ? slots.na == 0 : slots.nb == 0) continue;
          const int s = st == 0 ? slots.a : slots.b;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            LRK_CHECK("row sums", slots.par * kMax + 16 * s + gq + 8 * hr,
                      2 * kMax);
            rowp[slots.par * kMax + 16 * s + gq + 8 * hr] += rsum[st][hr];
          }
        }
      }
      cp_wait<0>();   // dS of this pass
      __syncthreads();  // and att

      // -- E += w ⊙ X dSᵀ on strip `warp`; dw_j = Σ_n B_jn (X dSᵀ)_jn
      if (kFull || warp < S) {
        const int j0 = 16 * warp + gq;
        LRK_CHECK("w", j0 + 8, kMax);
        const float w0 = ws[j0], w1 = ws[j0 + 8];
        float dw[2] = {};
#pragma unroll
        for (int q = 0; q < kMax / 32; ++q) {
          if (32 * q >= N8) continue;
          float acc[4][4] = {}, cor[4][4] = {};
          for (int p = 0; p < pw8; p += 8) {
            Frag<true, true> f;
            load_a(f, xs + 16 * warp * kXS + p, kXS, gq, tq);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (8 * (4 * q + u) >= N8) continue;
              load_b_nrow(f, dss + 8 * (4 * q + u) * kXS + p, kXS, gq, tq);
              f.mma3(acc[u], cor[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (8 * (4 * q + u) >= N8) continue;
            const int n = 8 * (4 * q + u) + 2 * tq;
            LRK_CHECK("B (shared)", (j0 + 8) * kBS + n + 1, kMax * kBS);
            const float2 b0 =
                *reinterpret_cast<const float2*>(bs + j0 * kBS + n);
            const float2 b1 =
                *reinterpret_cast<const float2*>(bs + (j0 + 8) * kBS + n);
            float f[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = acc[u][e] + cor[u][e];
            esum[4 * q + u][0] = fmaf(w0, f[0], esum[4 * q + u][0]);
            esum[4 * q + u][1] = fmaf(w0, f[1], esum[4 * q + u][1]);
            esum[4 * q + u][2] = fmaf(w1, f[2], esum[4 * q + u][2]);
            esum[4 * q + u][3] = fmaf(w1, f[3], esum[4 * q + u][3]);
            dw[0] = fmaf(b0.x, f[0], fmaf(b0.y, f[1], dw[0]));
            dw[1] = fmaf(b1.x, f[2], fmaf(b1.y, f[3], dw[1]));
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v = sum_over_t(dw[hr]);
          if (tq == 0) LRK_CHECK("dw", j0 + 8 * hr, kMax);
          if (tq == 0) dwv[j0 + 8 * hr] += v;
        }
      }
      __syncthreads();  // x is read
      if (!last) {
        copy_xy(a, xs, a.x, bc, hn, cn);
        cp_commit();
      }
      if (c + 1 == a.passes && h + 1 < h1) dec = fetch_decay(a, bc, h + 1);

      // -- dx = w ⊙ (B dS) + attᵀ dY, strips a and b, half the columns
      {
        const int pair = warp >> 1, hf = warp & 1;
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int sj = st == 0 ? pair : S - 1 - pair;
          if (!kFull && (pair >= pairs || (st == 1 && sj <= pair))) continue;
          float acc[4][4] = {}, cor[4][4] = {};
          for (int n = 0; n < N8; n += 8) {
            Frag<true, true> f;
            load_a_nat(f, bs + 16 * sj * kBS + n, kBS, gq, tq);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int pc = 8 * (4 * hf + u);
              if (!kFull && pc >= pw8) continue;
              load_b_krow_nat(f, dss + n * kXS + pc, kXS, gq, tq);
              f.mma3(acc[u], cor[u]);
            }
          }
          const int j0 = 16 * sj + gq;
          LRK_CHECK("w", j0 + 8, kMax);
          const float w0 = ws[j0], w1 = ws[j0 + 8];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[u][e] = (e < 2 ? w0 : w1) * (acc[u][e] + cor[u][e]);
              cor[u][e] = 0.f;
            }
          for (int i0 = 16 * sj; i0 < Qp; i0 += 8) {
            const int si = i0 >> 4;
            LRK_CHECK("att", at_base(si) + ((i0 & 15) + 7) * at_stride(si) +
                                 16 * sj + 15,
                      kOffVec - kOffAt);
            Frag<true, true> f;
            load_at_nat(f, at + at_base(si) + (i0 & 15) * at_stride(si) +
                               16 * sj,
                        at_stride(si), gq, tq);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int pc = 8 * (4 * hf + u);
              if (!kFull && pc >= pw8) continue;
              load_b_krow_nat(f, ys + i0 * kXS + pc, kXS, gq, tq);
              f.mma3(acc[u], cor[u]);
            }
          }
          const long long dx_at = (bc * a.Q * a.H + h) * a.P + p0;
          float* dxh = a.dx + dx_at;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = 8 * (4 * hf + u) + 2 * tq;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int j = j0 + 8 * hr;
              if (!kFull && j >= Q) continue;
              float* dst = dxh + j * xrow + p;
              if (kFull) {
                LRK_CHECK("dx", dx_at + j * xrow + p + 1, a.n_x);
                *reinterpret_cast<float2*>(dst) =
                    make_float2(acc[u][2 * hr] + cor[u][2 * hr],
                                acc[u][2 * hr + 1] + cor[u][2 * hr + 1]);
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (p + e < pw) {
                    LRK_CHECK("dx", dx_at + j * xrow + p + e, a.n_x);
                    dst[e] = acc[u][2 * hr + e] + cor[u][2 * hr + e];
                  }
              }
            }
          }
        }
      }
      __syncthreads();  // dY, dS and att are read
      if (!last) {
        copy_xy(a, ys, a.dy, bc, hn, cn);
        cp_commit();
        copy_ds(a, dss, bc, hn, cn);
        cp_commit();
      }
    }

    // ddt and dclog by token, then dda = the reverse cumsum of dclog
    if (threadIdx.x < kMax) {
      const int j = threadIdx.x;
      if (j < Q) {
        float ck = 0.f, cm = 0.f;
        for (int s = j >> 4; s < S; ++s) {
          LRK_CHECK("column sums", s * kMax + j, 8 * kMax);
          ck += colk[s * kMax + j];
          cm += colm[s * kMax + j];
        }
        LRK_CHECK("ddt", (bc * a.Q + j) * a.H + h, a.n_dt);
        a.ddt[(bc * a.Q + j) * a.H + h] = fmaf(dwv[j], es[j], ck);
        rowp[j] = (rowp[j] + rowp[kMax + j]) - cm - dwv[j] * ws[j];
      }
    }
    __syncthreads();
    if (warp == 0) {
      float lastv = 0.f;
      for (int j = lane; j < Q; j += 32) lastv = fmaf(dwv[j], ws[j], lastv);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lastv += __shfl_xor_sync(0xffffffffu, lastv, off);
      if (lane == 0) LRK_CHECK("row sums", Q - 1, 2 * kMax);
      if (lane == 0) rowp[Q - 1] += lastv;
      __syncwarp();
      warp_scan(rowp, Q, lane, true);
      __syncwarp();
      for (int j = lane; j < Q; j += 32) {
        LRK_CHECK("dda", (bc * a.Q + j) * a.H + h, a.n_dt);
        a.dda[(bc * a.Q + j) * a.H + h] = rowp[j];
      }
    }
  }

  // the slice's D and E
  const long long part = (bc * a.G + grp) * a.slices + sl;
  const long long dp_at = part * a.Q * (long long)a.Q;
  float* dp = a.dpart + dp_at;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!kFull && !slots.has(k)) continue;
    const int i0 = 16 * slots.strip(k) + gq, j0 = 8 * slots.block(k) + 2 * tq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = i0 + 8 * hr;
      if (kFull) {
        LRK_CHECK("D partials", dp_at + (long long)i * kMax + j0 + 1,
                  a.n_dpart);
        *reinterpret_cast<float2*>(dp + (long long)i * kMax + j0) =
            make_float2(dsum[k][2 * hr], dsum[k][2 * hr + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (i < Q && j0 + e < Q) {
            LRK_CHECK("D partials", dp_at + (long long)i * Q + j0 + e,
                      a.n_dpart);
            dp[(long long)i * Q + j0 + e] = dsum[k][2 * hr + e];
          }
      }
    }
  }
  if (kFull || warp < S) {
    const long long ep_at = part * a.Q * (long long)a.N;
    float* ep = a.epart + ep_at;
#pragma unroll
    for (int u = 0; u < kMax / 8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * warp + gq + 8 * (e >> 1), n = 8 * u + 2 * tq + (e & 1);
        if (j < Q && n < a.N) {
          LRK_CHECK("E partials", ep_at + (long long)j * a.N + n, a.n_epart);
          ep[(long long)j * a.N + n] = esum[u][e];
        }
      }
  }
}

// 2. per (bc, group, 32 columns of n): D and E summed over the slices in
// order; dC = D B, dB = Dᵀ C + E on the causal k only
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_groups_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  long long blk = blockIdx.x;
  const int nb = (int)(blk % a.nblk);
  blk /= a.nblk;
  const int grp = (int)(blk % a.G);
  const long long bc = blk / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* ds = sm;
  float* bq = sm + kMax * kBS;
  float* cq = bq + kMax * kGB;
  const int n0 = kNB * nb, nw = imin(kNB, a.N - n0);
  const int nw8 = (nw + 7) & ~7;
  const long long go = (bc * a.Q * a.G + grp) * a.N + n0;
  const long long rs = (long long)a.G * a.N;
  LRK_CHECK("B (shared)", (a.Qp - 1) * kGB + nw8 - 1, kMax * kGB);
  LRK_CHECK("C (shared)", (a.Qp - 1) * kGC + nw8 - 1, kMax * kGC);
  copy_rows(bq, kGB, a.b + go, rs, a.Qp, nw8, a.Q, nw, a.vec_n,
            Src{"b", go, a.n_bc});
  copy_rows(cq, kGC, a.c + go, rs, a.Qp, nw8, a.Q, nw, a.vec_n,
            Src{"c", go, a.n_bc});
  cp_commit();
  const long long part0 = (bc * a.G + grp) * a.slices;
  const long long QQ = a.Q * (long long)a.Q, QN = a.Q * (long long)a.N;
  // D on the causal strips' columns (zero past Q), slices in order: 16
  // elements a thread, each slice's 16 loads in flight together
  for (int e0 = 0; e0 < a.Qp * kMax; e0 += 16 * kThreads) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = 0.f;
    for (int s = 0; s < a.slices; ++s) {
      const float* dp = a.dpart + (part0 + s) * QQ;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * kThreads + threadIdx.x;
        const int i = e >> 7, j = e & (kMax - 1);
        if (i < a.Q && j < a.Q && j < 16 * ((i >> 4) + 1))
          LRK_CHECK("D partials", (part0 + s) * QQ + (long long)i * a.Q + j,
                    a.n_dpart);
        if (i < a.Q && j < a.Q && j < 16 * ((i >> 4) + 1))
          v[u] += dp[(long long)i * a.Q + j];
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      const int i = e >> 7, j = e & (kMax - 1);
      if (i < a.Qp && j < 16 * ((i >> 4) + 1))
        LRK_CHECK("D (shared)", i * kBS + j, kMax * kBS);
      if (i < a.Qp && j < 16 * ((i >> 4) + 1)) ds[i * kBS + j] = v[u];
    }
  }
  cp_wait<0>();
  __syncthreads();
  const int pair = warp >> 1, hf = warp & 1;
  if (pair >= a.pairs) return;
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int s = st == 0 ? pair : a.S - 1 - pair;
    if (st == 1 && s <= pair) continue;
    const int r0 = 16 * s + gq;
    {  // dC rows of strip s: Σ_{j < 16(s+1)} D_ij B_j
      float acc[2][4] = {}, cor[2][4] = {};
      for (int k = 0; k < 16 * (s + 1); k += 8) {
        Frag<true, true> f;
        load_a_nat(f, ds + 16 * s * kBS + k, kBS, gq, tq);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nc = 8 * (2 * hf + u);
          if (nc >= nw8) continue;
          load_b_krow_nat(f, bq + k * kGB + nc, kGB, gq, tq);
          f.mma3(acc[u], cor[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e >> 1);
          const int n = 8 * (2 * hf + u) + 2 * tq + (e & 1);
          if (i < a.Q && n < nw) {
            LRK_CHECK("dc", go + i * rs + n, a.n_bc);
            a.dc[go + i * rs + n] = acc[u][e] + cor[u][e];
          }
        }
    }
    {  // dB rows of strip s: Σ_{i >= 16 s} D_ij C_i, + E
      float acc[2][4] = {}, cor[2][4] = {};
      float ev[2][4] = {};  // E: the slices' partial sums, in order
      for (int sl = 0; sl < a.slices; ++sl)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = r0 + 8 * (e >> 1);
            const int n = 8 * (2 * hf + u) + 2 * tq + (e & 1);
            if (j < a.Q && n < nw) {
              LRK_CHECK("E partials",
                        (part0 + sl) * QN + (long long)j * a.N + n0 + n,
                        a.n_epart);
              ev[u][e] += a.epart[(part0 + sl) * QN + (long long)j * a.N +
                                  n0 + n];
            }
          }
      for (int k = 16 * s; k < a.Qp; k += 8) {
        Frag<true, true> f;
        load_at(f, ds + k * kBS + 16 * s, kBS, gq, tq);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nc = 8 * (2 * hf + u);
          if (nc >= nw8) continue;
          load_b_krow(f, cq + k * kGC + nc, kGC, gq, tq);
          f.mma3(acc[u], cor[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + 8 * (e >> 1);
          const int n = 8 * (2 * hf + u) + 2 * tq + (e & 1);
          if (j < a.Q && n < nw) {
            LRK_CHECK("db", go + j * rs + n, a.n_bc);
            a.db[go + j * rs + n] = (acc[u][e] + cor[u][e]) + ev[u][e];
          }
        }
    }
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a launch needs an opt-in, set once
// per device
cudaError_t allow_shared_memory() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(ssd_bwd_heads_kernel<true, kMax>, attr,
                             kHeadsFloats * (int)sizeof(float));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_heads_kernel<true, 64>, attr,
                               kHeadsFloats * (int)sizeof(float));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_heads_kernel<false, 0>, attr,
                               kHeadsFloats * (int)sizeof(float));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_groups_kernel, attr,
                               kGroupFloats * (int)sizeof(float));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// All pointers fp32 and contiguous: x, dy, dx (BC,Q,H,P); dt, da, ddt, dda
// (BC,Q,H); b, c, db, dc (BC,Q,G,N), head h reading group h / (H / G);
// dstate (BC,H,N,P).  Scratch: dpart BC*G*S*Q*Q and epart BC*G*S*Q*N
// floats, S = slices.  1 <= Q, N, P <= 128; heads_per_slice must be
// min(H / G, 16) and slices ceil((H / G) / heads_per_slice), the wrapper's
// plan (ssd_bwd_plan), or the call is refused.  Two launches on
// `stream`.  Returns the first CUDA error (0 = queued).
extern "C" int ssd_intra_chunk_bwd_launch(
    const float* x, const float* dt, const float* da, const float* b,
    const float* c, const float* dy, const float* dstate, float* dx,
    float* ddt, float* dda, float* db, float* dc, float* dpart, float* epart,
    long long BC, int Q, int H, int P, int N, int G, int heads_per_slice,
    int slices, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BC < 1 || Q < 1 || Q > kMax || N < 1 || N > kMax || P < 1 ||
      P > kMax || G < 1 || H < G || H % G)
    return (int)cudaErrorInvalidValue;
  const int rep = H / G;
  const int hs = imin(rep, kSliceHeads);
  if (heads_per_slice != hs || slices != cdiv(rep, hs))
    return (int)cudaErrorInvalidValue;
  const int nblk = cdiv(N, kNB);
  if (BC * G * slices > 0x7fffffffLL || BC * G * nblk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int S = cdiv(Q, 16);
  Args a{x,  dt, da, b,  c,   dy,     dstate, dx,    ddt, dda,
         db, dc, dpart, epart, Q, H, P, N, G, rep, hs, slices,
         S,  cdiv(S, 2), 16 * S, (N + 7) & ~7, cdiv(P, kPC), nblk,
         P % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dstate),
         N % 4 == 0 && aligned16(b) && aligned16(c),
         BC * Q * H * (long long)P, BC * Q * (long long)H,
         BC * Q * G * (long long)N, BC * H * N * (long long)P,
         BC * G * slices * Q * (long long)Q,
         BC * G * slices * Q * (long long)N};
  cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  const unsigned heads = (unsigned)(BC * G * slices);
  const size_t smem = kHeadsFloats * sizeof(float);
#ifdef LRK_RAGGED_ONLY
  // a measurement build: the ragged instance at every shape, so its
  // runtime bounds can be timed against the constant-bound instances
  const bool full = false;
#else
  const bool full = Q == kMax && P % kPC == 0;
#endif
  if (full && N == kMax)
    ssd_bwd_heads_kernel<true, kMax><<<heads, kThreads, smem, st>>>(a);
  else if (full && N == 64)
    ssd_bwd_heads_kernel<true, 64><<<heads, kThreads, smem, st>>>(a);
  else
    ssd_bwd_heads_kernel<false, 0><<<heads, kThreads, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_groups_kernel<<<(unsigned)(BC * G * nblk), kThreads,
                          kGroupFloats * sizeof(float), st>>>(a);
  return (int)cudaGetLastError();
}
