// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_forward.py::lowrank_forward:
//
//     y = x W + (x V) B^T        x (M,K), W (K,N), V (K,r), B (N,r)
//
// in two call forms: a shared B (prefill through LRPack, and the training
// forward) and one B per batch row (decode through BatchLRPack, the
// reference's dispatch.py::_pallas_batch_forward: flattened row m uses
// B[rows[m / seq]], B the adapter store's (T, N, r) stack read by index,
// or B[m / seq] of a (batch, N, r) stack).  x, W, V, B and y share one
// dtype, fp32 or bf16; every product accumulates in fp32 and p = x V is
// kept to fp32 precision for the B^T product, as the TPU kernel keeps it
// in VMEM.  The training form (the TPU kernel's return_p) also writes p
// in x's dtype, the only activation the backward keeps.
//
// The TPU kernel builds p only while its sequential grid sweeps the
// j == 0 column slab and reuses the VMEM scratch for later slabs.  GPU
// blocks run in no order, and recomputing p in every output tile would
// cost M*K*N*r/bn extra MACs (double the work at r = bn = 128), so p is
// a pass of its own.  Three routes, chosen by the Python wrapper:
//
// * tensor cores, shared B (lowrank_forward_tc_launch; bf16, every row
//   length a multiple of 8 so TMA can address it), two launches of the
//   persistent wgmma mainloop of wgmma_gemm.cuh:
//
//     1. p pass: p = x V, stored as p_hi = bf16(p) (exactly the return_p
//        output) and p_lo = bf16(p - p_hi): 16 significant bits, so the
//        rank-r term keeps the fp32 p of the reference to about 2^-17;
//     2. y pass: y = x W + p_hi B^T + p_lo B^T, three reduction segments
//        into one fp32 accumulator, cast to bf16 once.  A programmatic
//        dependent launch: its x W mainloop runs while the p pass
//        finishes, and its producer waits for p only before the rank
//        segments.
//
//   What bounds it: at the training shapes (M = 16384) the operations at
//   the bf16 tensor-core peak; at prefill (M <= 512) the weights' bytes.
//   The route keeps bf16 operands, streams them with TMA into a swizzled
//   ring that wgmma reads directly, and adds the rank-r term inside the
//   same tile, so y is written once and nothing of size M x N is re-read.
//   Each pass's plan (lowrank_forward.py::gemm_plan, from the shapes
//   alone) sets the tile width (64, 128 or 256 columns), pairs blocks
//   that share W's stages by multicast where the operations bound the
//   pass (the training shapes), and splits K where the output tiles alone
//   cannot fill the card (a prefill's one row of tiles): each split
//   writes an fp32 partial, and the last to arrive at the tile's counter
//   sums them in split order and stores the tile, so results do not
//   depend on scheduling.  A shared-B launch of
//   at most 16 rows (the unembedding at prefill) takes the per-row-B
//   kernel below with one B instead: W read once by the swap-AB tile.
//
// * tensor cores, per-row B (lowrank_batch_forward_tc_launch; bf16,
//   aligned as above): decode, M = batch x seq of usually 1-16 rows.
//   Each W element is used at most 16 times, against the ~295 flop per
//   byte where the tensor cores would bind: the weights' bytes bound it,
//   so W is read exactly once, with many bytes in flight on every SM, and
//   nothing of size M x N is written and read back by a second pass.
//   The tile is swapped (y^T = W^T x^T): 128 of W's columns fill wgmma's
//   64-row side (two warpgroups), read M-major straight from W's (K, N)
//   storage, and the decode rows are wgmma's n8 or n16 side, x read
//   K-major; a stage is 16 KB of W and 1-2 KB of x, and a 6-stage TMA
//   ring keeps about 200 KB in flight per SM at two blocks per SM.  Two
//   launches of skinny_kernel, queued by one call:
//
//     1. p pass: p = x V in fp32 (M, r), V in the place of W, split over
//        K so that V is not streamed by one block;
//     2. y pass, a programmatic dependent of the p pass (its mainloop
//        runs while p finishes; only the rank term waits for p): the
//        x W tile, and the rank-r term in fp32, sum_c p[m, c] B[t(m)][n,
//        c], each distinct tenant's 128 x r rows of B staged by cp.async
//        through two shared buffers (rows that share a tenant share one
//        staged piece).  Where the column tiles fill the card, one block
//        per tile does both and stores y.  Else K is split, each tile
//        also gets a rank slot per distinct tenant its rows can hold,
//        every block writes an fp32 partial, and the block that arrives
//        last at the tile's counter (an integer atomic) sums the splits
//        in split order and adds each row's rank partial, so results do
//        not depend on scheduling.  y is cast to bf16 once.  A tenant
//        index outside [0, T) traps.
//
// * SIMT (lowrank_forward_launch; fp32, and a row length that TMA cannot
//   address), shared-memory tiled fp32 FMAs:
//
//     1. gemm_partial: p_part[s] = x[:, Ks] V[Ks, :]  (split K, fp32)
//     2. sum_splits:   p = sum_s p_part[s]            (fixed order; with
//                      return_p also p_out = p cast to x's dtype)
//     shared B:
//     3. lrk::gemm_kernel: y = x W + p B^T, the rank-r term a second
//                      reduction segment of z == 0; split over K into
//                      fp32 partials when the output alone cannot fill
//                      the card, then a fixed-order sum_splits cast
//     per-row B:
//     3. gemm_partial: y_part[s] = x[:, Ks] W[Ks, :]  (split K, fp32)
//     4. finish:       y = sum_s y_part[s] + p B[t(m)]^T, cast to x's
//                      dtype
//
//   Splitting K keeps enough blocks in flight when M is a decode batch
//   of a few rows; partial sums are reduced in a fixed order, so results
//   do not depend on scheduling (no float atomics).
//
// Plain C interface, loaded with ctypes; scratch and outputs are
// allocated by the Python wrapper (repro_torch/kernels/lowrank_forward.py).

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// part[z, m, n] = sum over k in [z*k_chunk, (z+1)*k_chunk) of a[m,k] b[k,n]
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gemm_partial(const T* __restrict__ a, const T* __restrict__ bmat,
                 float* __restrict__ part, int M, int N, int K, int k_chunk) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, kk = i % BK;
      const int gm = row0 + m, gk = k0 + kk;
      As[kk][m] =
          (gm < M && gk < k_end) ? to_f(a[(int64_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN;
      const int gk = k0 + kk, gn = col0 + n;
      Bs[kk][n] =
          (gk < k_end && gn < N) ? to_f(bmat[(int64_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gm < M && gn < N) out[(int64_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = sum_s part[s * count + i], s in order, when out is given;
// cast[i] = the same sum in T when cast is given
template <typename T>
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, T* __restrict__ cast,
                           int64_t count, int S) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += part[(int64_t)j * count + i];
  if (out != nullptr) out[i] = s;
  if (cast != nullptr) store(cast + i, s);
}

// y[m, n] = sum_s y_part[s, m, n] + sum_c p[m, c] b[t][n, c], with
// t = rows[m / seq] (or m / seq where rows is null); a t outside [0, T)
// traps.  One warp per output; lanes stride over c so B rows are read
// coalesced.  Consecutive warps take consecutive m of one n, so a B row
// is reused from L1 across the rows that share it.
template <typename T>
__global__ void finish(const float* __restrict__ y_part, int Sy,
                       const float* __restrict__ p, const T* __restrict__ b,
                       const long long* __restrict__ rows, int n_b,
                       T* __restrict__ y, int M, int N, int r, int seq,
                       int64_t b_stride) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int64_t n_warps = (int64_t)gridDim.x * blockDim.x / 32;
  const int64_t total = (int64_t)M * N;
  for (int64_t o = warp; o < total; o += n_warps) {
    const int n = (int)(o / M);
    const int m = (int)(o % M);
    const long long t = rows != nullptr ? rows[m / seq] : m / seq;
    if (t < 0 || t >= n_b) __trap();
    const T* brow = b + t * b_stride + (int64_t)n * r;
    const float* prow = p + (int64_t)m * r;
    float acc = 0.f;
    for (int c = lane; c < r; c += 32) acc = fmaf(prow[c], to_f(brow[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int64_t at = (int64_t)m * N + n;
      float s = 0.f;
      for (int j = 0; j < Sy; ++j) s += y_part[(int64_t)j * total + at];
      store(y + at, s + acc);
    }
  }
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
int launch_all(const void* x, const void* w, const void* v, const void* b,
               void* y, void* p_out, float* p_part, int s_p, float* p,
               float* y_part,
               int s_y, int M, int K, int N, int r, int seq,
               int64_t b_stride, const long long* rows, int n_b,
               cudaStream_t st) {
  cudaError_t err;
  const int kc_p = (int)(ceil_div(ceil_div(K, s_p), BK) * BK);
  const dim3 grid_p((unsigned)ceil_div(r, BN), (unsigned)ceil_div(M, BM),
                    (unsigned)s_p);
  gemm_partial<T><<<grid_p, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), p_part, M, r, K,
      kc_p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t p_count = (int64_t)M * r;
  sum_splits<T><<<(unsigned)ceil_div(p_count, 256), 256, 0, st>>>(
      p_part, p, static_cast<T*>(p_out), p_count, s_p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (b_stride == 0 && seq == M) {
    // shared B: the rank-r term is a second reduction segment of the x W
    // tile (the first split's), so y needs no finish pass
    lrk::Gemm<T, T, float, T, float, T> g{};
    g.a = lrk::View<T>{static_cast<const T*>(x), K, 1, 0};
    g.b = lrk::View<T>{static_cast<const T*>(w), N, 1, 0};
    g.a2 = lrk::View<float>{p, r, 1, 0};
    g.b2 = lrk::View<T>{static_cast<const T*>(b), 1, r, 0};  // B^T(c, n)
    g.k2 = r;
    g.rows = M;
    g.cols = N;
    g.k = K;
    g.splits = s_y;
    if (s_y == 1)
      g.out = static_cast<T*>(y);
    else
      g.part = y_part;
    const int e = lrk::launch_gemm(g, 1, st);
    if (e != 0 || s_y == 1) return e;
    const int64_t total = (int64_t)M * N;
    sum_splits<T><<<(unsigned)ceil_div(total, 256), 256, 0, st>>>(
        y_part, nullptr, static_cast<T*>(y), total, s_y);
    return (int)cudaGetLastError();
  }

  const int kc_y = (int)(ceil_div(ceil_div(K, s_y), BK) * BK);
  const dim3 grid_y((unsigned)ceil_div(N, BN), (unsigned)ceil_div(M, BM),
                    (unsigned)s_y);
  gemm_partial<T><<<grid_y, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), y_part, M, N, K,
      kc_y);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t total = (int64_t)M * N;
  const int64_t blocks = ceil_div(total, 256 / 32);
  finish<T><<<(unsigned)(blocks < 132 * 64 ? blocks : 132 * 64), 256, 0,
              st>>>(y_part, s_y, p, static_cast<const T*>(b), rows, n_b,
                    static_cast<T*>(y), M, N, r, seq, b_stride);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The per-row-B (decode) form on the tensor cores
// ---------------------------------------------------------------------------
namespace dec {

constexpr int TN = 128;                // output columns per block
constexpr int BK = tc::BK;             // depth of a stage
constexpr int STAGES = 6;
constexpr int THREADS = tc::THREADS;   // two consumer warpgroups + producer
constexpr int CONSUMERS = tc::CONSUMERS;
constexpr int RC = 128;                // rank columns of B per staged piece
constexpr int BS_LD = RC + 8;          // a staged B row, padded by 16 bytes
constexpr int ACC_LD = TN + 4;         // an fp32 tile row in shared memory
constexpr int BARS = 1024;             // bytes kept for the mbarriers
constexpr int SMEM_CAP = 200 * 1024;   // dynamic shared memory opted into
constexpr int LOADS = 8;               // partial loads in flight per thread

struct Args {
  CUtensorMap w;           // A: W (K, N), or V (K, r) in the p pass
  CUtensorMap x;           // B: x (M, K), boxes of 64 x BN rows
  int M, N, K, k_chunk, splits;
  float* part;             // (splits, M, N) fp32 partials when splits > 1
  int* counters;           // one per tile; zero before and after a launch
  void* out;               // y (M, N) bf16, or p (M, N) fp32 (p pass)
  int stage_floats;        // room to stage partials in the epilogue
  const float* p;          // y pass: p (M, r) fp32, from the p pass
  const __nv_bfloat16* b;  // y pass: the T adapters (T, N, r)
  const long long* rows;   // y pass: tenant per batch row, or null
  int r, seq, T;
};

template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (TN + BN) * BK * 2;
}

// The epilogue's layout over the ring (free by then): the fp32 tile;
// in the y pass each row's tenant and the distinct tenants, p's rows and
// two staged B pieces; then room to stage split partials.
template <int BN>
size_t epi_fixed(int r, bool rank) {
  const size_t acc = (size_t)BN * ACC_LD * 4;
  return rank ? acc + 2 * BN * 4 + (size_t)BN * r * 4 +
                    2 * (size_t)TN * BS_LD * 2
              : acc;
}

template <int BN>
size_t region_bytes(int r, bool rank) {
  const size_t ring = (size_t)STAGES * stage_bytes<BN>();
  const size_t epi = epi_fixed<BN>(r, rank) + (size_t)BN * TN * 4;
  return ring > epi ? ring : epi;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One block of a tile (output columns [n0, n0 + 128) of rows [m0, m0 +
// BN)): blockIdx.x = z < splits is depth range z of W; z >= splits is a
// rank slot, the rank-r term of the tile's (z - splits)-th distinct
// tenant.  With one block per tile (splits == 1, no rank slots) that
// block adds the rank term itself and stores y; else every block writes
// an fp32 partial and the last to arrive sums the splits in split order,
// adds each row's rank partial and stores y.  The blocks of a tile are
// adjacent in launch order, so its rank slots run beside its splits.
// RANK: the y pass (bf16 y), launched as a programmatic dependent of the
// p pass: only the rank term waits for p (griddepcontrol.wait).  Else the
// p pass (fp32 out, no rank term, no rank slots).
template <int BN, bool RANK>
__global__ void __launch_bounds__(THREADS, 2)
    skinny_kernel(const __grid_constant__ Args g) {
  constexpr uint32_t A_BYTES = TN * BK * 2;
  constexpr uint32_t STAGE = stage_bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last, s_nd;
  if constexpr (!RANK)
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t full = (raw + 1023u) & ~1023u;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t ring = full + BARS;
  uint8_t* epi = smem_raw + (ring - raw);
  const int z = blockIdx.x, n0 = blockIdx.y * TN, m0 = blockIdx.z * BN;
  const int tile = blockIdx.z * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32;
  const int mv = min(BN, g.M - m0);        // the tile's rows in x
  const bool alone = gridDim.x == 1;

  // the epilogue's shared memory, over the ring (free by then)
  float* acc_s = reinterpret_cast<float*>(epi);          // [BN][ACC_LD]
  int* ten_s = reinterpret_cast<int*>(acc_s + BN * ACC_LD);
  int* dist_s = ten_s + BN;
  float* ps = reinterpret_cast<float*>(dist_s + BN);      // [BN][r]
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(ps + BN * g.r);
  float* stage_s = RANK ? reinterpret_cast<float*>(bs + 2 * TN * BS_LD)
                        : acc_s + BN * ACC_LD;
  const int nrc = (g.r + RC - 1) / RC;
  // compute threads of the rank term: column nl, rows mh, mh + 2, ...
  const int nl = tid % TN, mh = tid / TN;

  // each row's tenant and the distinct tenants, in order (a tenant index
  // outside [0, T) traps)
  auto tenants = [&]() {
    if (tid == 0) {
      int nd = 0;
      for (int ml = 0; ml < BN; ++ml) {
        int t = -1;
        if (ml < mv) {
          const long long i = (m0 + ml) / g.seq;
          const long long tl = g.rows != nullptr ? g.rows[i] : i;
          if (tl < 0 || tl >= g.T) __trap();
          t = (int)tl;
          bool seen = false;
          for (int q = 0; q < nd; ++q) seen |= dist_s[q] == t;
          if (!seen) dist_s[nd++] = t;
        }
        ten_s[ml] = t;
      }
      s_nd = nd;
    }
    __syncthreads();
  };
  // B piece q of the distinct tenants from d0 (tenant dist_s[d0 + q /
  // nrc], rank columns (q % nrc) RC) into buffer q % 2 by cp.async, one
  // commit group per piece
  auto stage_b = [&](int q, int d0) {
    const int t = dist_s[d0 + q / nrc], c0 = (q % nrc) * RC;
    const int vecs = min(RC, g.r - c0) / 8;
    __nv_bfloat16* dst = bs + (q & 1) * TN * BS_LD;
    const __nv_bfloat16* src = g.b + ((size_t)t * g.N + n0) * g.r + c0;
    for (int i = tid; i < TN * vecs; i += THREADS) {
      const int row = i / vecs, c = (i % vecs) * 8;
      if (n0 + row < g.N)
        cp_async16(dst + row * BS_LD + c, src + (size_t)row * g.r + c);
    }
    cp_async_commit();
  };
  // the rank-r term of the distinct tenants [d0, d1) into racc: sum_c
  // p[m, c] B[t][n, c] in fp32, c in order; pieces 0 and 1 are staged
  // already, each later one once its buffer is free.  p is read after
  // the p pass ends.
  float racc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) racc[j] = 0.f;
  auto rank_term = [&](int d0, int d1) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int i = tid; i < BN * g.r; i += THREADS)
      ps[i] = i / g.r < mv ? g.p[(size_t)m0 * g.r + i] : 0.f;
    const int pieces = (d1 - d0) * nrc;
    for (int q = 0; q < pieces; ++q) {
      if (q + 1 < pieces)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      const int t = dist_s[d0 + q / nrc], c0 = (q % nrc) * RC;
      const int rc = min(RC, g.r - c0);
      if (tid < 2 * TN && n0 + nl < g.N) {
        unsigned mine = 0;
#pragma unroll
        for (int j = 0; j < BN / 2; ++j)
          if (ten_s[mh + 2 * j] == t) mine |= 1u << j;
        const __nv_bfloat16* brow = bs + (q & 1) * TN * BS_LD + nl * BS_LD;
        for (int c = 0; c < rc; c += 8) {
          const uint4 raw8 = *reinterpret_cast<const uint4*>(brow + c);
          const __nv_bfloat162* b2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw8);
          float bv[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(b2[e]);
            bv[2 * e] = f.x;
            bv[2 * e + 1] = f.y;
          }
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            if (!((mine >> j) & 1u)) continue;
            const float* prow = ps + (mh + 2 * j) * g.r + c0 + c;
            const float4 p0 = *reinterpret_cast<const float4*>(prow);
            const float4 p1 = *reinterpret_cast<const float4*>(prow + 4);
            float a = racc[j];
            a = fmaf(p0.x, bv[0], a);
            a = fmaf(p0.y, bv[1], a);
            a = fmaf(p0.z, bv[2], a);
            a = fmaf(p0.w, bv[3], a);
            a = fmaf(p1.x, bv[4], a);
            a = fmaf(p1.y, bv[5], a);
            a = fmaf(p1.z, bv[6], a);
            a = fmaf(p1.w, bv[7], a);
            racc[j] = a;
          }
        }
      }
      __syncthreads();   // buffer q % 2 is free for piece q + 2
      if (q + 2 < pieces) stage_b(q + 2, d0);
    }
  };

  if (z >= g.splits) {
    // a rank slot (y pass only): B's pieces load while p is awaited
    if constexpr (RANK) {
      tenants();
      const int d = z - g.splits;
      if (d < s_nd) {
        for (int q = 0; q < 2 && q < nrc; ++q) stage_b(q, d);
        rank_term(d, d + 1);
        if (tid < 2 * TN && n0 + nl < g.N) {
          float* part = g.part + (size_t)z * g.M * g.N;
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            const int ml = mh + 2 * j;
            if (ml < mv && ten_s[ml] == dist_s[d])
              part[(size_t)(m0 + ml) * g.N + n0 + nl] = racc[j];
          }
        }
      }
    }
  } else {
    // depth range z of the x W tile
    const int kb = z * g.k_chunk, ke = min(g.K, kb + g.k_chunk);
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) {
        tc::mbar_init(full + 8 * s, 1);
        tc::mbar_init(empty + 8 * s, CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // the role as a warp-uniform value: wgmma must not sit in a path the
    // compiler takes for divergent
    const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    if (role == CONSUMERS / 128) {
      // producer: one thread issues every load of the block
      if (tid == CONSUMERS) {
        int t = 0;
        for (int k0 = kb; k0 < ke; k0 += BK, ++t) {
          const int st = t % STAGES;
          if (t >= STAGES)
            tc::mbar_wait(empty + 8 * st, ((t / STAGES) - 1) & 1);
          const uint32_t bar = full + 8 * st, sa = ring + st * STAGE;
          tc::mbar_expect_tx(bar, STAGE);
          tc::tma_load(sa, &g.w, bar, n0, k0);
          tc::tma_load(sa + tc::BOX, &g.w, bar, n0 + 64, k0);
          tc::tma_load(sa + A_BYTES, &g.x, bar, k0, m0);
        }
      }
      __syncwarp();
    } else {
      // consumers: warpgroup `role` owns columns [64 role, 64 role + 64)
      tc::fence_regs(d);
      int t = 0;
      for (int k0 = kb; k0 < ke; k0 += BK, ++t) {
        const int st = t % STAGES;
        tc::mbar_wait(full + 8 * st, (t / STAGES) & 1);
        const uint32_t sa = ring + st * STAGE;
        tc::wg_fence();
        tc::mma_stage<BN, 1, 0>(d, sa + role * tc::BOX, sa + A_BYTES);
        tc::wg_commit();
        tc::wg_wait<1>();
        if (t > 0) tc::mbar_arrive(empty + 8 * ((t - 1) % STAGES));
      }
      tc::wg_wait<0>();
      tc::fence_regs(d);
    }

    // d[4 j + 2 h + e] holds column 64 role + 16 warp + lane / 4 + 8 h
    // and row 8 j + 2 (lane % 4) + e of the tile
    if (alone) {
      __syncthreads();   // both warpgroups are done with the ring
      if constexpr (RANK) {
        tenants();
        for (int q = 0; q < 2 && q < s_nd * nrc; ++q) stage_b(q, 0);
      }
      if (role < 2) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc_s[(8 * j + 2 * (lane % 4) + e) * ACC_LD + 64 * role +
                    16 * warp + lane / 4 + 8 * h] = d[4 * j + 2 * h + e];
      }
      __syncthreads();
      if constexpr (!RANK) {
        float* out = static_cast<float*>(g.out);
        for (int i = tid; i < mv * TN; i += THREADS) {
          const int ml = i / TN, n = n0 + i % TN;
          if (n < g.N)
            out[(size_t)(m0 + ml) * g.N + n] = acc_s[ml * ACC_LD + i % TN];
        }
      } else {
        rank_term(0, s_nd);
        // y = (x W) + (rank-r term), cast to bf16 once
        if (tid < 2 * TN && n0 + nl < g.N) {
          __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.out);
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            const int ml = mh + 2 * j;
            if (ml < mv)
              y[(size_t)(m0 + ml) * g.N + n0 + nl] =
                  __float2bfloat16(acc_s[ml * ACC_LD + nl] + racc[j]);
          }
        }
      }
      return;
    }
    if (role < 2) {
      float* part = g.part + (size_t)z * g.M * g.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 64 * role + 16 * warp + lane / 4 + 8 * h;
            const int m = m0 + 8 * j + 2 * (lane % 4) + e;
            if (n < g.N && m < g.M)
              part[(size_t)m * g.N + n] = d[4 * j + 2 * h + e];
          }
    }
  }

  // every block of the tile arrives; the last one finishes it
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&g.counters[tile], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) g.counters[tile] = 0;
  if constexpr (RANK) {
    tenants();
    // a rank slot per distinct tenant, or the launch was wrong
    if (tid == 0 && s_nd > (int)gridDim.x - g.splits) __trap();
  }

  // the splits' partials in split order, staged through shared memory a
  // chunk of splits at a time so that their loads are in flight together
  for (int i = tid; i < BN * TN; i += THREADS)
    acc_s[(i / TN) * ACC_LD + i % TN] = 0.f;
  const int per_z = mv * (TN / 4);                  // float4 per split
  const int zc = max(1, g.stage_floats / (mv * TN));
  for (int z0 = 0; z0 < g.splits; z0 += zc) {
    const int zn = min(zc, g.splits - z0), total = zn * per_z;
    for (int i0 = tid; i0 < total; i0 += THREADS * LOADS) {
      float4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * THREADS;
        const int zz = i / per_z, ml = (i % per_z) / (TN / 4);
        const int n = n0 + 4 * (i % (TN / 4));
        v[u] = i < total && n < g.N
                   ? __ldcg(reinterpret_cast<const float4*>(
                         g.part + ((size_t)(z0 + zz) * g.M + m0 + ml) * g.N +
                         n))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * THREADS;
        if (i < total) reinterpret_cast<float4*>(stage_s)[i] = v[u];
      }
    }
    __syncthreads();
    for (int i = tid; i < mv * TN; i += THREADS) {
      const int ml = i / TN, il = i % TN;
      float s = acc_s[ml * ACC_LD + il];
      for (int zz = 0; zz < zn; ++zz) s += stage_s[(zz * mv + ml) * TN + il];
      acc_s[ml * ACC_LD + il] = s;
    }
    __syncthreads();
  }

  for (int i = tid; i < mv * TN; i += THREADS) {
    const int ml = i / TN, il = i % TN, n = n0 + il;
    if (n >= g.N) continue;
    const size_t at = (size_t)(m0 + ml) * g.N + n;
    if constexpr (RANK) {
      // y = (sum of the splits) + (the row's rank partial), cast once
      int dd = 0;
      while (dist_s[dd] != ten_s[ml]) ++dd;
      const float rk = __ldcg(g.part + (size_t)(g.splits + dd) * g.M * g.N +
                              at);
      static_cast<__nv_bfloat16*>(g.out)[at] =
          __float2bfloat16(acc_s[ml * ACC_LD + il] + rk);
    } else {
      static_cast<float*>(g.out)[at] = acc_s[ml * ACC_LD + il];
    }
  }
}

// the dynamic shared memory limit, set once per device and kernel
template <int BN, bool RANK>
int prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(skinny_kernel<BN, RANK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_CAP);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

// The y pass is a programmatic dependent launch: it may start while the
// p pass runs, and waits for it (griddepcontrol.wait) only to read p.
template <int BN, bool RANK>
int launch(Args& g, int tiles_m, int slots, cudaStream_t st) {
  const size_t region = region_bytes<BN>(g.r, RANK);
  const size_t smem = 1024 + BARS + region;
  if (smem > (size_t)SMEM_CAP) return (int)cudaErrorInvalidValue;
  g.stage_floats = (int)((region - epi_fixed<BN>(g.r, RANK)) / 4);
  int err = prepare<BN, RANK>();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3((unsigned)(g.splits + slots),
                     (unsigned)ceil_div(g.N, TN), (unsigned)tiles_m);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = RANK ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, skinny_kernel<BN, RANK>, g);
  return err != 0 ? err : (int)cudaGetLastError();
}

// depth per split: ceil(K / splits) rounded up to BK; every split must be
// non-empty (the wrapper chooses splits so)
inline int chunk_of(int K, int splits, int& k_chunk) {
  k_chunk = (int)(ceil_div(ceil_div(K, splits), BK) * BK);
  return ceil_div(K, k_chunk) == splits ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN>
int launch_both(Args& gp, Args& gy, int tiles_m, int slots,
                cudaStream_t st) {
  int err = launch<BN, false>(gp, tiles_m, 0, st);
  return err != 0 ? err : launch<BN, true>(gy, tiles_m, slots, st);
}

}  // namespace dec

}  // namespace

// The SIMT route.  dtype: 0 = float32, 1 = bfloat16.  seq: rows per
// adapter (M for a shared B); b_stride: elements between adapters (0 for
// a shared B); rows: the (batch,) tenant index of each batch row into the
// n_b adapters of b, or null (row i uses adapter i).  p_out (M, r) in x's
// dtype receives p, or is null (serving).  p_part (s_p, M, r), p (M, r)
// and y_part (s_y, M, N) are fp32 scratch; y_part is unused (may be null)
// for a shared B with s_y = 1.  Returns cudaGetLastError() of the
// launches (0 = all queued).
extern "C" int lowrank_forward_launch(int dtype, const void* x,
                                      const void* w, const void* v,
                                      const void* b, void* y, void* p_out,
                                      float* p_part,
                                      int s_p, float* p, float* y_part,
                                      int s_y, int M, int K, int N, int r,
                                      int seq, long long b_stride,
                                      const long long* rows, int n_b,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(x, w, v, b, y, p_out, p_part, s_p, p, y_part,
                             s_y, M, K, N, r, seq, (int64_t)b_stride, rows,
                             n_b, st);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(x, w, v, b, y, p_out, p_part, s_p, p,
                                     y_part, s_y, M, K, N, r, seq,
                                     (int64_t)b_stride, rows, n_b, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: shared B, bf16, K, N and r multiples of 8 and
// 16-byte-aligned pointers (the wrapper checks).  p_hi (M, r) receives
// bf16(p) -- the return_p output -- and p_lo (M, r) bf16(p - p_hi).
// plan: each pass's tile width, splits of K and cluster size (bn_p, s_p,
// cl_p, bn_y, s_y, cl_y; lowrank_forward.py::tc_plan, every split
// non-empty); part_p, part_y: their fp32 partials (tiles x splits, 128 x
// bn), unused (may be null) where the pass does not split; counters: one
// zeroed int per tile of both passes (the p pass's first), left zero.
// The y pass may start before the p pass ends (programmatic dependent
// launch).  Returns 0 when both launches were queued, a CUDA error, or a
// negated CUresult of the tensor-map encoding.
extern "C" int lowrank_forward_tc_launch(const void* x, const void* w,
                                         const void* v, const void* b,
                                         void* y, void* p_hi, void* p_lo,
                                         float* part_p, float* part_y,
                                         int* counters, const int* plan,
                                         int M, int K, int N, int r,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan[0] != 64 && plan[0] != 128 && plan[0] != 256)
    return (int)cudaErrorInvalidValue;
  // p = x V: A = x (M, K), B = V (K, r) N-major
  const tc::Segment sp{{x, M, K, false}, {v, K, r, true}, K};
  const tc::Pass pp{plan[0], plan[1], part_p, counters, tc::MAX_SEGS,
                    plan[2]};
  int err = tc::gemm(&sp, 1, M, r, pp, tc::EPI_HILO, p_hi, p_lo, st);
  if (err != 0) return err;
  // y = x W + p_hi B^T + p_lo B^T: W (K, N) N-major, B^T from B (N, r)
  // K-major; only the rank segments wait for p
  const tc::Segment sy[3] = {{{x, M, K, false}, {w, K, N, true}, K},
                             {{p_hi, M, r, false}, {b, N, r, false}, r},
                             {{p_lo, M, r, false}, {b, N, r, false}, r}};
  int* cy = counters + tc::ceil_div(M, tc::BM) * tc::ceil_div(r, plan[0]);
  const tc::Pass py{plan[3], plan[4], part_y, cy, 1, plan[5]};
  return tc::gemm(sy, 3, M, N, py, tc::EPI_BF16, y, nullptr, st);
}

// The per-row-B tensor-core route: bf16, K, N and r multiples of 8 and
// 16-byte-aligned x, w, v, b (the wrapper checks).  Flattened row m of x
// (M, K) uses adapter rows[m / seq] of b (T, N, r), or adapter m / seq
// where rows is null.  bn: 8 or 16 decode rows per tile; s_p, s_y: the
// p and y passes' splits over K (every split non-empty); slots: the y
// pass's rank slots per tile (0 where s_y = 1, else at least the distinct
// tenants a tile's rows can hold).  Scratch: p (M, r) fp32, p_part (s_p,
// M, r) where the p pass splits and y_part (s_y + slots, M, N) where the
// y pass does, fp32 (else unused); counters, one int per tile of both
// passes (the p pass's ceil(r / 128) ceil(M / bn) first), all zero, and
// the launches leave them zero.  The y pass may start before the p pass
// ends (programmatic dependent launch).  Returns 0 when both launches
// were queued, a CUDA error, or a negated CUresult of the tensor-map
// encoding.
extern "C" int lowrank_batch_forward_tc_launch(
    const void* x, const void* w, const void* v, const void* b,
    const long long* rows, void* y, float* p, float* p_part, float* y_part,
    int* counters, int M, int K, int N, int r, int seq, int T, int bn,
    int s_p, int s_y, int slots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bn != 8 && bn != 16) || s_p < 1 || s_y < 1 || seq < 1 ||
      slots < 0 || slots > bn || (s_y == 1 && slots != 0))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  dec::Args gp, gy;
  memset(&gp, 0, sizeof(gp));
  memset(&gy, 0, sizeof(gy));
  // B of both passes: x (M, K) K-major, boxes of bn rows
  int err = tc::make_map(&gp.x, tc::Operand{x, M, K, false}, bn);
  if (err == 0)
    err = tc::make_map(&gp.w, tc::Operand{v, K, r, true}, 64);
  if (err == 0)
    err = tc::make_map(&gy.w, tc::Operand{w, K, N, true}, 64);
  if (err == 0) err = dec::chunk_of(K, s_p, gp.k_chunk);
  if (err == 0) err = dec::chunk_of(K, s_y, gy.k_chunk);
  if (err != 0) return err;
  gy.x = gp.x;
  // p pass: p (M, r) = x V
  gp.M = M;
  gp.N = r;
  gp.K = K;
  gp.splits = s_p;
  gp.part = p_part;
  gp.counters = counters;
  gp.out = p;
  gp.r = r;
  // y pass: y (M, N) = x W + p B[t]^T
  gy.M = M;
  gy.N = N;
  gy.K = K;
  gy.splits = s_y;
  gy.part = y_part;
  gy.counters = counters + ceil_div(r, dec::TN) * ceil_div(M, bn);
  gy.out = y;
  gy.p = p;
  gy.b = static_cast<const __nv_bfloat16*>(b);
  gy.rows = rows;
  gy.r = r;
  gy.seq = seq;
  gy.T = T;
  const int tiles_m = (int)ceil_div(M, bn);
  return bn == 8 ? dec::launch_both<8>(gp, gy, tiles_m, slots, st)
                 : dec::launch_both<16>(gp, gy, tiles_m, slots, st);
}
