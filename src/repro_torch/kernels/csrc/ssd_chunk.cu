// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/ssd_chunk.py::ssd_intra_chunk (_ssd_kernel), the Mamba2
// SSD intra-chunk block, per (batch*chunk bc, head h):
//
//   clog    = cumsum(da)                         over the chunk's Q tokens
//   att_ij  = (C_i . B_j) exp(clog_i - clog_j) dt_j          for j <= i
//   y_i     = sum_{j<=i} att_ij x_j                          (Q, P)
//   state   = sum_j exp(clog_last - clog_j) dt_j B_j x_jᵀ    (N, P) fp32
//
// x (BC,Q,H,P), dt and da (BC,Q,H), b and c (BC,Q,H,N) share one dtype,
// fp32 or bf16; y is written in that dtype and the state in fp32.  b and c
// are read through strides (bc, q, head; n contiguous), so a head stride
// of 0 reads one B/C group for every head without a broadcast copy.
//
// What bounds it: at mamba2-780m's prefill shapes (Q = 128, H = 48, P =
// 64, N = 128, one B/C group) a chunk moves about 4.9 MB (x in, y and the
// state out, fp32) for about 150 M multiply-adds, 31 operations per byte:
// below the 3xTF32 tensor-core balance point (495 / 3 TFLOP/s against
// 3.35 TB/s, 49), so bytes by the roofline; fp32 FMAs (67 TFLOP/s, 20)
// would make it operations.  On the card what a CTA copies into shared
// memory (x of a head is read by four CTAs, B and G tiles by many), and
// how long its phases wait on those copies, cost more than its products.
// So the design keeps each CTA's copies small, fills the card from one
// chunk on, overlaps the waits, and runs every product on the tensor
// cores:
//
// * Two grids, launched back to back.  A Gram CTA computes a 32 x 32
//   tile of G = C Bᵀ for one B/C group (its strip pair's rows, causal
//   column blocks only) and stores it to a scratch G in global memory:
//   one Gram per group, whatever the number of heads that read it (48 at
//   mamba2-780m).  A chunk CTA (bc, head, part r) computes the rows n of
//   state tile r (32 rows of n) and the y rows of strip pair r (16-row
//   strips s and strips-1-s: each part holds about the same share of the
//   causal half).  At BC = 1 that is 16 Gram and 192 chunk CTAs, three a
//   SM (about 73 KB of shared memory each).  The split is the Python
//   wrapper's (ssd_plan); the launcher refuses a split other than its own.
// * The chunk grid is a programmatic dependent launch: every Gram CTA
//   lets it start as soon as it runs (griddepcontrol.launch_dependents),
//   and only the y half of a chunk CTA waits for the whole Gram grid
//   (griddepcontrol.wait) before it reads G.  Its copies of x and B and
//   its state tile overlap the Gram grid; stream order does the rest, so
//   the kernel keeps no counter between launches.
// * A chunk CTA runs two halves of four warps at once.  The y half copies
//   x of its head (all tokens) stage by stage and the state half the 32
//   columns of B of its tile; the state half computes the state as the
//   stages land (a named barrier per stage of x).  The y half then copies
//   its two strips of G, turns them into the masked scores in shared
//   memory, and computes y.
// * The tensor cores at fp32 accuracy: mma.sync m16n8k8 TF32 with the
//   3xTF32 split (hi = v rounded to tf32, lo = v - hi; hi.hi in one sum,
//   hi.lo + lo.hi in another; tf32_mma.cuh, shared with the backward
//   ssd_chunk_bwd.cu) for the Gram (over n), y (over j) and the
//   state (over j).  A bf16 input is exact in TF32 (lo = 0), so its Gram
//   takes one product and y and the state, whose A operand carries the
//   fp32 decay, two.  mma.sync and not wgmma: TF32 wgmma takes only
//   K-major operands, and y and the state read x (the state also B) with
//   the reduction on the row axis.
// * The decay in place: the y half turns its strips of G into the masked
//   scores G_ij exp(clog_i - clog_j) dt_j (0 for j > i) once, then its
//   products read them.  A pair j > i never reaches the exponential: at
//   mamba2's dt*A (A down to -16) clog_i - clog_j reaches hundreds over
//   128 tokens, exp gives inf, and inf * 0 is NaN.  The exponential is
//   __expf (ex2.approx of the exact difference times log2 e): within
//   about 1e-6 relative for the differences that weigh (|d| < 20).
// * 16-byte cp.async copies (4-byte ones where a row is not 16-byte
//   aligned; plain loads for bf16) into padded shared memory.  Row
//   strides keep every fragment read free of bank conflicts.  cumsum(da)
//   is a warp-shuffle scan in fp64 (four tokens a lane, then the lanes'
//   totals), rounded once.
// * Ragged Q, N and P (any of 1..128) are zero-filled in shared memory
//   and masked on store.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/ssd_chunk.py) allocates y, the state and the
// scratch G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // a chunk CTA's state and y halves
constexpr int kStrip = 16;         // y rows per strip: one m16 tile
constexpr int kTileN = 32;         // state rows n per chunk CTA
constexpr int kGramCols = 32;      // G columns per Gram CTA
constexpr int kStage = 32;         // tokens (columns of n) per copy stage
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 128;
// Row strides (floats): 8 mod 32 where a fragment is read as 8-byte
// column pairs of rows by lane group (C, B and G by rows), 4 mod 32 where
// rows 2t, 2t+1 go by lane in group and columns by lane group (x, the
// state's B).  Every fragment read is then free of bank conflicts.
constexpr int kBtStride = kTileN + 4;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int m) {
  return cdiv(a, m) * m;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// The launch geometry and the shared-memory carve-up (offsets in floats),
// computed on the host and passed to the kernel.
struct Geo {
  long long BC;
  int Q, N, P, H, groups;  // groups: 1 (b, c of head stride 0) or H
  int Qp, Q8, P8;          // tokens padded to strips, to 8; head dim to 8
  int GS, XS, NS;          // row strides of G, x, and C/B in a Gram CTA
  int strips, pairs, ntiles, parts, gcols;
  long long n_gram, n_chunk;
  int m_bt, m_gs, m_w, m_clog, m_dt, m_yclog, m_ydt, m_floats;  // chunk
                                                             // CTA: x at 0
  int g_b, g_floats;                            // Gram CTA (C at 0)

  __host__ __device__ Geo(long long BC, int Q_, int N_, int P_, int H_,
                          int groups_)
      : BC(BC), Q(Q_), N(N_), P(P_), H(H_), groups(groups_) {
    Qp = round_up(Q, kStrip);
    Q8 = round_up(Q, 8);
    P8 = round_up(P, 8);
    GS = round_up(Q, 32) + 8;
    XS = round_up(P, 32) + 4;
    NS = round_up(N, 32) + 8;
    strips = cdiv(Q, kStrip);
    pairs = cdiv(strips, 2);
    ntiles = cdiv(N, kTileN);
    parts = imax(pairs, ntiles);
    gcols = cdiv(Q8, kGramCols);
    n_gram = BC * groups * pairs * gcols;
    n_chunk = BC * H * parts;
    m_bt = Qp * XS;
    m_gs = m_bt + Qp * kBtStride;
    m_w = m_gs + 2 * kStrip * GS;
    m_clog = m_w + Qp;
    m_dt = m_clog + Qp;
    m_yclog = m_dt + Qp;
    m_ydt = m_yclog + Qp;
    m_floats = m_ydt + Qp;
    g_b = 2 * kStrip * NS;
    g_floats = g_b + kGramCols * NS;
  }
};

template <typename T>
struct Args {
  const T *x, *dt, *da, *b, *c;
  T* y;
  float* state;
  float* gram;       // (BC, groups, Q, Q) scratch
  long long b_sbc, b_sq, b_sh, c_sbc, c_sq, c_sh;
  bool vec_x, vec_bc, vec_g;  // 16-byte copies of x, b and c, G rows
  // elements each array spans (x and y; dt and da; b; c; the state; G):
  // the limits of the checked build
  long long n_x, n_dt, n_b, n_c, n_state, n_gram;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// The source of a copy: `src` lies at element `at` of an array of `n`
// elements (the checked build asserts every element read inside it).
struct Src {
  const char* name;
  long long at, n;
};

// rows x cols floats into dst (row stride ds) from src (row r at src + r *
// rs), zero where r >= vrows or the column >= vcols, by threads tid of
// nthr.  fp32 goes by cp.async (16-byte pieces when `vec`: cols, vcols
// and the rows' starts are then multiples of 4 floats); bf16 by loads
// converted to fp32.  A piece that is not copied reads nothing (src-size
// 0) from `src`.
template <typename T>
__device__ __forceinline__ void copy_rows(float* dst, int ds, const T* src,
                                          long long rs, int rows, int cols,
                                          int vrows, int vcols, bool vec,
                                          const Src& from,
                                          int tid = threadIdx.x,
                                          int nthr = kThreads) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int pieces = cols / 4;
      for (int e = tid; e < rows * pieces; e += nthr) {
        const int r = e / pieces, q = 4 * (e - r * pieces);
        const bool ok = r < vrows && q < vcols;
        if (ok) LRK_CHECK(from.name, from.at + r * rs + q + 3, from.n);
        cp16(dst + r * ds + q, ok ? src + r * rs + q : src, ok);
      }
      return;
    }
    for (int e = tid; e < rows * cols; e += nthr) {
      const int r = e / cols, q = e - r * cols;
      const bool ok = r < vrows && q < vcols;
      if (ok) LRK_CHECK(from.name, from.at + r * rs + q, from.n);
      cp4(dst + r * ds + q, ok ? src + r * rs + q : src, ok);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthr) {
      const int r = e / cols, q = e - r * cols;
      LRK_SMEM(dst + r * ds + q, 4);
      if (r < vrows && q < vcols)
        LRK_CHECK(from.name, from.at + r * rs + q, from.n);
      dst[r * ds + q] =
          (r < vrows && q < vcols) ? to_f(src[r * rs + q]) : 0.f;
    }
  }
}

// named barriers: `id` 1..15 over `n` threads (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// In-place inclusive cumsum of v[0..Q), Q <= 128, by one warp: each lane
// sums its four tokens in order, then the lanes' totals are scanned with
// shuffles and each lane adds the total before it.  The sums run in fp64
// and each prefix is rounded once: the correctly rounded cumsum, as
// torch.cumsum gives it on the CPU, whose accumulator is a double.
__device__ __forceinline__ void warp_cumsum(float* v, int Q, int lane) {
  double s[4], run = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    if (j < Q) LRK_SMEM(v + j, 4);
    run += j < Q ? (double)v[j] : 0.0;
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
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    if (j < Q) LRK_SMEM(v + j, 4);
    if (j < Q) v[j] = (float)(before + s[k]);
  }
}

// dt and da of head h at token j ((token j, head h) at (bc Q + j) H + h),
// zero past Q.  Fetched into registers before a thread queues its
// copies, so that these small strided loads do not wait behind them.
struct Decay {
  float dt, da;
};
template <typename T>
__device__ __forceinline__ Decay fetch_decay(const Args<T>& a, const Geo& g,
                                             long long bc, int h, int j) {
  const bool in = j < g.Q;
  const long long at = (bc * g.Q + j) * g.H + h;
  if (in) LRK_CHECK("dt, da", at, a.n_dt);
  return {in ? to_f(a.dt[at]) : 0.f, in ? to_f(a.da[at]) : 0.f};
}
// into dts and clog (Qp each; token j = this thread's index tid among the
// nthr >= Qp threads of named barrier bar), then clog = cumsum(da) by the
// group's first warp; ends with the barrier
__device__ __forceinline__ void scan_decay(const Decay& d, const Geo& g,
                                           float* clog, float* dts, int tid,
                                           int bar, int nthr) {
  if (tid < g.Qp) {
    LRK_SMEM(dts + tid, 4);
    LRK_SMEM(clog + tid, 4);
    dts[tid] = d.dt;
    clog[tid] = d.da;
  }
  bar_sync(bar, nthr);
  if (tid < 32) warp_cumsum(clog, g.Q, tid);
  bar_sync(bar, nthr);
}

// Programmatic dependent launch: the Gram grid lets the chunk grid start
// (launch_dependents); a chunk thread waits until the Gram grid has ended
// and its stores are visible (wait; at once when the chunk grid was not
// launched as a dependent).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_gram() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The strips of pair r: s0 = r and, when it exists, s1 = strips-1-r
// (slot 0 and slot 1), with each slot's causal columns (0 for no slot 1).
struct Pair {
  int s0, s1, kc0, kc1;
  bool two;
  __device__ __forceinline__ Pair(const Geo& g, int r) {
    s0 = r;
    s1 = g.strips - 1 - r;
    two = s1 > s0;
    if (!two) s1 = s0;
    kc0 = imin(kStrip * (s0 + 1), g.Q8);
    kc1 = two ? imin(kStrip * (s1 + 1), g.Q8) : 0;
  }
  __device__ __forceinline__ int kc_max() const { return two ? kc1 : kc0; }
};

// G rows of pair r's strips, columns [j0, j0 + 32) within each strip's
// causal columns, for group grp: C_i . B_j over n, to the scratch G.
template <typename T>
__device__ void gram_cta(const Args<T>& a, const Geo& g, float* sm,
                         long long bc, int grp, int r, int cb) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const Pair pr(g, r);
  const int j0 = kGramCols * cb;
  if (j0 >= pr.kc_max()) return;  // no causal column here
  float* cs = sm;
  float* bs = sm + g.g_b;
  // group grp is head grp's B and C (head stride 0 when groups == 1)
  const long long c_at = bc * a.c_sbc + (long long)grp * a.c_sh;
  const long long b_at = bc * a.b_sbc + (long long)grp * a.b_sh;
  const T* cb0 = a.c + c_at;
  const T* bb0 = a.b + b_at;
  const int nst = cdiv(g.N, kStage);
  for (int s = 0; s < nst; ++s) {
    const int n0 = kStage * s;
    LRK_CHECK("C (shared)", (2 * kStrip - 1) * g.NS + n0 + kStage - 1, g.g_b);
    LRK_CHECK("B (shared)", g.g_b + (kGramCols - 1) * g.NS + n0 + kStage - 1,
              g.g_floats);
    const long long c0 = kStrip * pr.s0 * a.c_sq + n0;
    copy_rows(cs + n0, g.NS, cb0 + c0, a.c_sq, kStrip, kStage,
              g.Q - kStrip * pr.s0, g.N - n0, a.vec_bc,
              Src{"c", c_at + c0, a.n_c});
    if (pr.two) {
      const long long c1 = kStrip * pr.s1 * a.c_sq + n0;
      copy_rows(cs + kStrip * g.NS + n0, g.NS, cb0 + c1, a.c_sq, kStrip,
                kStage, g.Q - kStrip * pr.s1, g.N - n0, a.vec_bc,
                Src{"c", c_at + c1, a.n_c});
    }
    const long long b0 = j0 * a.b_sq + n0;
    copy_rows(bs + n0, g.NS, bb0 + b0, a.b_sq, kGramCols, kStage, g.Q - j0,
              g.N - n0, a.vec_bc, Src{"b", b_at + b0, a.n_b});
    cp_commit();
  }
  // tiles: slot warp / 4, columns j0 + 8 (warp % 4)
  const int sl = warp >> 2, jt = j0 + 8 * (warp & 3);
  const bool live = jt < (sl ? pr.kc1 : pr.kc0);
  float acc[4] = {}, cor[4] = {};
  for (int s = 0; s < nst; ++s) {
    cp_wait_at_most(nst - 1 - s);
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int kk = 0; kk < kStage; kk += 8) {
      const int k = kStage * s + kk;
      Frag<!kExact, !kExact> f;
      load_a(f, cs + sl * kStrip * g.NS + k, g.NS, gq, tq);
      load_b_nrow(f, bs + (jt - j0) * g.NS + k, g.NS, gq, tq);
      f.mma3(acc, cor);
    }
  }
  if (live) {
    const long long gm_at = (bc * g.groups + grp) * g.Q * (long long)g.Q;
    float* gm = a.gram + gm_at;
    const int i0 = kStrip * (sl ? pr.s1 : pr.s0) + gq;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = i0 + 8 * hr;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jt + 2 * tq + e;
        if (i < g.Q && j < g.Q)
          LRK_CHECK("gram", gm_at + (long long)i * g.Q + j, a.n_gram);
        if (i < g.Q && j < g.Q)
          gm[(long long)i * g.Q + j] = acc[2 * hr + e] + cor[2 * hr + e];
      }
    }
  }
}

// 16 rows of the scratch G (strip s, columns [0, kc), zero past Q) into
// shared memory at row stride GS, by the kHalf threads of a y half.  G
// was written by the Gram grid, which may have ended after this grid
// started: 16-byte cp.async.cg reads L2, and the 4-byte path
// ld.global.cg.
__device__ __forceinline__ void copy_g(float* dst, const Geo& g,
                                       const float* gm, int s, int kc,
                                       bool vec, int tid, const Src& from) {
  const float* src = gm + (long long)kStrip * s * g.Q;
  const int vrows = g.Q - kStrip * s;
  const Src at{from.name, from.at + (long long)kStrip * s * g.Q, from.n};
  if (vec) {
    copy_rows(dst, g.GS, src, g.Q, kStrip, kc, vrows, g.Q, true, at, tid,
              kHalf);
    return;
  }
  for (int e = tid; e < kStrip * kc; e += kHalf) {
    const int r = e / kc, q = e - r * kc;
    LRK_SMEM(dst + r * g.GS + q, 4);
    if (r < vrows && q < g.Q)
      LRK_CHECK(at.name, at.at + (long long)r * g.Q + q, at.n);
    dst[r * g.GS + q] =
        (r < vrows && q < g.Q) ? __ldcg(src + (long long)r * g.Q + q) : 0.f;
  }
}

// Part r of head h, in two halves of 128 threads that run at once: the
// state half (warps 0-3) copies the B columns of state tile r and
// computes those rows of the end state; the y half (warps 4-7) copies x
// of the head, stage by stage (the state half takes each stage at the
// named barrier kBarX0 + stage), then the pair's strips of G once the
// Gram grid has ended, turns them into the masked scores and
// computes the y rows of pair r.  A part with no y rows copies x in its
// state half; one with no state rows, in its y half alone.
constexpr int kBarState = 1, kBarY = 2, kBarX0 = 3;  // kBarX0 .. + 3

template <typename T>
__device__ void state_half(const Args<T>& a, const Geo& g, float* sm,
                           long long bc, int h, int r, bool has_y) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  float* xs = sm;
  float* bt = sm + g.m_bt;
  float* w = sm + g.m_w;
  float* clog = sm + g.m_clog;
  float* dts = sm + g.m_dt;
  const long long xrow = (long long)g.H * g.P;  // x's token stride
  const long long x_at = (bc * g.Q * g.H + h) * g.P;
  const T* x0 = a.x + x_at;
  const int n0 = kTileN * r;
  const long long b_at = bc * a.b_sbc + (long long)h * a.b_sh + n0;
  const T* bb = a.b + b_at;
  const Decay dec = fetch_decay(a, g, bc, h, tid);
  const int nst = cdiv(g.Qp, kStage);
  for (int s = 0; s < nst; ++s) {
    const int j0 = kStage * s, n = imin(kStage, g.Qp - j0);
    LRK_CHECK("B^T (shared)", (j0 + n) * kBtStride - 1, g.Qp * kBtStride);
    copy_rows(bt + j0 * kBtStride, kBtStride, bb + j0 * a.b_sq, a.b_sq, n,
              kTileN, g.Q - j0, g.N - n0, a.vec_bc,
              Src{"b", b_at + j0 * a.b_sq, a.n_b}, tid, kHalf);
    if (!has_y) {
      LRK_CHECK("x (shared)", (j0 + n) * g.XS - 1, g.m_bt);
      copy_rows(xs + j0 * g.XS, g.XS, x0 + j0 * xrow, xrow, n, g.P8,
                g.Q - j0, g.P, a.vec_x, Src{"x", x_at + j0 * xrow, a.n_x},
                tid, kHalf);
    }
    cp_commit();
  }
  scan_decay(dec, g, clog, dts, tid, kBarState, kHalf);
  LRK_CHECK("clog", g.Q - 1, g.Qp);
  const float clast = clog[g.Q - 1];
  if (tid < g.Qp) LRK_CHECK("w", tid, g.Qp);
  if (tid < g.Qp)
    w[tid] = tid < g.Q ? __expf(clast - clog[tid]) * dts[tid] : 0.f;
  // tiles (16 rows of n, 8 columns of p): rows 16 (warp % 2), p tiles
  // warp / 2 + 2u (+ 8 on a second pass where P > 64)
  const int m0 = kStrip * (warp & 1);
  const bool live = n0 + m0 < g.N;
  for (int pass = 0; pass < cdiv(g.P8, 64); ++pass) {
    float acc[4][4] = {}, cor[4][4] = {};
    for (int s = 0; s < nst; ++s) {
      if (pass == 0) {  // stage s landed (and w, on s = 0)
        cp_wait_at_most(nst - 1 - s);
        if (has_y)
          bar_sync(kBarX0 + s, kThreads);  // with the y half's x
        else
          bar_sync(kBarState, kHalf);
      }
      if (!live) continue;
      const int kend = imin(kStage * (s + 1), g.Qp);
#pragma unroll 2
      for (int kk = kStage * s; kk < kend; kk += 8) {
        Frag<true, !kExact> f;  // k paired as load_b_krow reads x
        LRK_CHECK("w", kk + 2 * tq + 1, g.Qp);
        const float2 wk = *reinterpret_cast<const float2*>(w + kk + 2 * tq);
        const float* r0 = bt + (kk + 2 * tq) * kBtStride + m0 + gq;
        const float* r1 = r0 + kBtStride;
        LRK_CHECK("B^T (shared)", (kk + 2 * tq + 1) * kBtStride + m0 + gq + 8,
                  g.Qp * kBtStride);
        f.set_a(0, r0[0] * wk.x);
        f.set_a(1, r0[8] * wk.x);
        f.set_a(2, r1[0] * wk.y);
        f.set_a(3, r1[8] * wk.y);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p0 = 8 * ((warp >> 1) + 2 * u + 8 * pass);
          if (p0 < g.P8) {
            load_b_krow(f, xs + kk * g.XS + p0, g.XS, gq, tq);
            f.mma3(acc[u], cor[u]);
          }
        }
      }
    }
    if (!live) continue;
    const long long st_at = ((bc * g.H + h) * g.N + n0 + m0) * g.P;
    float* sh = a.state + st_at;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = 8 * ((warp >> 1) + 2 * u + 8 * pass) + 2 * tq;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = gq + 8 * hr;
        if (n0 + m0 + n < g.N) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (p + e < g.P) {
              LRK_CHECK("state", st_at + n * g.P + p + e, a.n_state);
              sh[n * g.P + p + e] = acc[u][2 * hr + e] + cor[u][2 * hr + e];
            }
        }
      }
    }
  }
}

template <typename T>
__device__ void y_half(const Args<T>& a, const Geo& g, float* sm,
                       long long bc, int h, int r, bool has_s) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  const int tid = threadIdx.x - kHalf, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const Pair pr(g, r);
  float* xs = sm;
  float* gs = sm + g.m_gs;
  float* clog = sm + g.m_yclog;
  float* dts = sm + g.m_ydt;
  const int grp = g.groups == 1 ? 0 : h;
  const long long xrow = (long long)g.H * g.P;  // x's token stride
  const long long x_at = (bc * g.Q * g.H + h) * g.P;
  const T* x0 = a.x + x_at;
  const Decay dec = fetch_decay(a, g, bc, h, tid);
  // x: every token for the state half, else up to the pair's last strip
  const int rows = has_s ? g.Qp : kStrip * (pr.s1 + 1);
  const int nst = cdiv(rows, kStage);
  for (int s = 0; s < nst; ++s) {
    const int j0 = kStage * s;
    LRK_CHECK("x (shared)", (j0 + imin(kStage, rows - j0)) * g.XS - 1,
              g.m_bt);
    copy_rows(xs + j0 * g.XS, g.XS, x0 + j0 * xrow, xrow,
              imin(kStage, rows - j0), g.P8, g.Q - j0, g.P, a.vec_x,
              Src{"x", x_at + j0 * xrow, a.n_x}, tid, kHalf);
    cp_commit();
  }
  scan_decay(dec, g, clog, dts, tid, kBarY, kHalf);
  for (int s = 0; s < nst; ++s) {
    cp_wait_at_most(nst - 1 - s);
    if (has_s) bar_arrive(kBarX0 + s, kThreads);
  }
  wait_for_gram();
  const long long gm_at = (bc * g.groups + grp) * g.Q * (long long)g.Q;
  const float* gm = a.gram + gm_at;
  const Src from{"gram", gm_at, a.n_gram};
  LRK_CHECK("G (shared)", (kStrip - 1) * g.GS + pr.kc0 - 1, kStrip * g.GS);
  copy_g(gs, g, gm, pr.s0, pr.kc0, a.vec_g, tid, from);
  if (pr.two) {
    LRK_CHECK("G (shared)", (2 * kStrip - 1) * g.GS + pr.kc1 - 1,
              2 * kStrip * g.GS);
    copy_g(gs + kStrip * g.GS, g, gm, pr.s1, pr.kc1, a.vec_g, tid, from);
  }
  cp_commit();
  cp_wait<0>();
  bar_sync(kBarY, kHalf);  // G, and every y thread's x
  // masked, decayed scores in place: rows warp + 4m (m < 4 slot 0);
  // column j = lane + 32q
  float cj[kMaxQ / 32], dj[kMaxQ / 32];
#pragma unroll
  for (int q = 0; q < kMaxQ / 32; ++q) {
    const int j = lane + 32 * q;
    if (j < g.Qp) LRK_CHECK("clog, dt", j, g.Qp);
    cj[q] = j < g.Qp ? clog[j] : 0.f;
    dj[q] = j < g.Qp ? dts[j] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int row = warp + 4 * m;
    const int i = kStrip * (m < 4 ? pr.s0 : pr.s1) + row % kStrip;
    const int kc = m < 4 ? pr.kc0 : pr.kc1;
    LRK_CHECK("clog", i, g.Qp);
    const float ci = clog[i];
#pragma unroll
    for (int q = 0; q < kMaxQ / 32; ++q) {
      const int j = lane + 32 * q;
      if (j < kc) {
        LRK_CHECK("G (shared)", row * g.GS + j, 2 * kStrip * g.GS);
        float v = 0.f;
        if (j <= i && i < g.Q)  // a masked pair never reaches the exp
          v = gs[row * g.GS + j] * __expf(ci - cj[q]) * dj[q];
        gs[row * g.GS + j] = v;
      }
    }
  }
  bar_sync(kBarY, kHalf);
  // y tiles (slot, 8 columns of p): p tiles warp + 4u (+ 8 on a second
  // pass where P > 64); the two slots' k steps interleaved, the hi.hi and
  // cross products in separate sums
  const int kmax = imax(pr.kc0, pr.kc1);
  for (int pass = 0; pass < cdiv(g.P8, 64); ++pass) {
    float yacc[2][2][4] = {}, ycor[2][2][4] = {};
#pragma unroll 2
    for (int k8 = 0; k8 < kmax; k8 += 8) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        if (k8 < (sl ? pr.kc1 : pr.kc0)) {
          Frag<true, !kExact> f;
          load_a(f, gs + sl * kStrip * g.GS + k8, g.GS, gq, tq);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int p0 = 8 * (warp + 4 * u + 8 * pass);
            if (p0 < g.P8) {
              load_b_krow(f, xs + k8 * g.XS + p0, g.XS, gq, tq);
              f.mma3(yacc[sl][u], ycor[sl][u]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (sl == 1 && !pr.two) break;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = 8 * (warp + 4 * u + 8 * pass) + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = kStrip * (sl ? pr.s1 : pr.s0) + gq + 8 * hr;
          if (i < g.Q) {
            const long long y_at = ((bc * g.Q + i) * g.H + h) * g.P + p;
            T* dst = a.y + y_at;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (p + e < g.P) {
                LRK_CHECK("y", y_at + e, a.n_x);
                store(dst + e, yacc[sl][u][2 * hr + e] +
                                   ycor[sl][u][2 * hr + e]);
              }
          }
        }
      }
    }
  }
}

template <typename T>
__device__ void chunk_cta(const Args<T>& a, const Geo& g, float* sm,
                          long long bc, int h, int r) {
  const bool has_y = r < g.pairs, has_s = r < g.ntiles;
  if (threadIdx.x < kHalf) {
    if (has_s) state_half<T>(a, g, sm, bc, h, r, has_y);
  } else if (has_y) {
    y_half<T>(a, g, sm, bc, h, r, has_s);
  }
}

// Gram tile (bc, group, pair, column block) of a 1-D grid, the column
// block fastest; it lets the chunk grid start at once
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_gram_kernel(const Args<T> a, const Geo g) {
  launch_dependents();
  extern __shared__ __align__(16) float smem[];
  long long t = blockIdx.x;
  const int cb = (int)(t % g.gcols);
  t /= g.gcols;
  const int r = (int)(t % g.pairs);
  t /= g.pairs;
  gram_cta<T>(a, g, smem, t / g.groups, (int)(t % g.groups), r, cb);
}

// chunk part (bc, head, part) of a 1-D grid, the part fastest
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_chunk_kernel(const Args<T> a, const Geo g) {
  extern __shared__ __align__(16) float smem[];
  long long t = blockIdx.x;
  const int r = (int)(t % g.parts);
  t /= g.parts;
  chunk_cta<T>(a, g, smem, t / g.H, (int)(t % g.H), r);
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a launch needs an opt-in.  It is
// set once per instantiation and device, to what the largest shape takes.
template <typename T>
cudaError_t allow_shared_memory() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const Geo most(1, kMaxQ, kMaxN, kMaxP, 1, 1);
  err = cudaFuncSetAttribute(ssd_gram_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most.g_floats * (int)sizeof(float));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most.m_floats * (int)sizeof(float));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const Geo& g, const void* x, const void* dt, const void* da,
           const void* b, const void* c, void* y, float* state, float* gram,
           long long b_sbc, long long b_sq, long long b_sh, long long c_sbc,
           long long c_sq, long long c_sh, cudaStream_t st) {
  if (g.n_gram > 0x7fffffffLL || g.n_chunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const bool strides4 = b_sbc % 4 == 0 && b_sq % 4 == 0 && b_sh % 4 == 0 &&
                        c_sbc % 4 == 0 && c_sq % 4 == 0 && c_sh % 4 == 0;
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(dt),
                  static_cast<const T*>(da), static_cast<const T*>(b),
                  static_cast<const T*>(c), static_cast<T*>(y), state, gram,
                  b_sbc, b_sq, b_sh, c_sbc, c_sq, c_sh,
                  kF32 && g.P % 4 == 0 && aligned16(x),
                  kF32 && g.N % 4 == 0 && strides4 && aligned16(b) &&
                      aligned16(c),
                  g.Q % 4 == 0 && aligned16(gram),
                  g.BC * g.Q * g.H * (long long)g.P,
                  g.BC * g.Q * (long long)g.H,
                  (g.BC - 1) * b_sbc + (g.Q - 1) * b_sq + (g.H - 1) * b_sh +
                      g.N,
                  (g.BC - 1) * c_sbc + (g.Q - 1) * c_sq + (g.H - 1) * c_sh +
                      g.N,
                  g.BC * g.H * g.N * (long long)g.P,
                  g.BC * g.groups * g.Q * (long long)g.Q};
  cudaError_t err = allow_shared_memory<T>();
  if (err != cudaSuccess) return (int)err;
  ssd_gram_kernel<T><<<(unsigned)g.n_gram, kThreads,
                       g.g_floats * sizeof(float), st>>>(a, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.n_chunk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.m_floats * sizeof(float);
  cfg.stream = st;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ssd_chunk_kernel<T>, a, g);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, dt, da, b, c and y).  x, dt,
// da are contiguous; b and c are read at bc * s_bc + q * s_q + h * s_h + n
// (element strides).  y (BC,Q,H,P) in the dtype, state (BC,H,N,P) fp32.
// 1 <= Q, N, P <= 128.  groups, pairs, parts, gram_cols: the caller's
// split (ssd_plan), refused unless it is this launcher's: one Gram group
// when b and c both have head stride 0, else H.  gram: BC * groups * Q * Q
// floats of scratch.  Two launches on `stream`, the second a programmatic
// dependent of the first.  Returns the first CUDA error (0 = queued).
extern "C" int ssd_intra_chunk_launch(
    int dtype, const void* x, const void* dt, const void* da, const void* b,
    const void* c, void* y, float* state, float* gram, long long BC, int Q,
    int H, int P, int N, int groups, int pairs, int parts, int gram_cols,
    long long b_sbc, long long b_sq, long long b_sh, long long c_sbc,
    long long c_sq, long long c_sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BC < 1 || BC > 0x7fffffffLL || H < 1 || H > 65535 || Q < 1 ||
      Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP)
    return (int)cudaErrorInvalidValue;
  const Geo g(BC, Q, N, P, H, b_sh == 0 && c_sh == 0 ? 1 : H);
  if (groups != g.groups || pairs != g.pairs || parts != g.parts ||
      gram_cols != g.gcols)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(g, x, dt, da, b, c, y, state, gram, b_sbc, b_sq,
                         b_sh, c_sbc, c_sq, c_sh, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, x, dt, da, b, c, y, state, gram, b_sbc,
                                 b_sq, b_sh, c_sbc, c_sq, c_sh, st);
  return (int)cudaErrorInvalidValue;
}
