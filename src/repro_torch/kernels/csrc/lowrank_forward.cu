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
// blocks run in no order, and recomputing p in every output tile costs
// M*K*N*r/bn extra MACs: double the work at r = bn = 128, so there p is
// a pass of its own; at r <= 16, one or two more n8 column blocks of a
// 128-wide tile (at most 12.5% more), so the fp32 small-rank route forms
// p in the tile.  Four routes, chosen by the Python wrapper (tc_route):
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
// * fp32 small rank (lowrank_forward_f3_launch; fp32 shared-B and
//   return_p launches with r <= 16: encoder-small's fine-tuning at r = 4),
//   one launch of small_rank_kernel, 3xTF32 mma.sync (tf32_mma.cuh):
//
//     y[m0 : m0 + 64, n0 : n0 + 128] = x W + p Bᵀ,  p = x V in the tile
//
//   What bounds it: at encoder-small's shapes (M = 8192, K and N 256 or
//   683) the bytes of x and y and the products as three TF32 products a
//   multiply-add weigh about alike at the card's peaks; but mma.sync
//   reaches well under the TF32 rate that wgmma gives, the split adds
//   integer and fp32 instructions to every fragment, and a single wave
//   of tiles leaves each SM few warps, so the products and the
//   instructions around them bound it.  So: one launch, no scratch, no split sums, p at r/128 more work
//   instead of a pass.  x, W and V tiles stream through a 3-stage
//   cp.async ring (16-byte copies where a row's length and base allow
//   them, 4-byte ones otherwise, zero fill at the ragged edges); four
//   warps of 32 x 64, two CTAs an SM; a warp reads its next step's
//   fragments while its three product passes run; p stays fp32, the
//   epilogue adds p Bᵀ by fp32 FMAs from B's tile rows staged in shared
//   memory, and column tile 0 also stores p.  mma.sync and not wgmma:
//   TF32 wgmma takes only a K-major B and W is (K, N) row-major; TMA
//   cannot address a row of 683 floats (2732 bytes).
//
// * SIMT (lowrank_forward_launch; fp32 at larger rank and the per-row-B
//   form, and bf16 with a row length that TMA cannot address),
//   shared-memory tiled fp32 FMAs:
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
#include "tf32_mma.cuh"
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

// ---------------------------------------------------------------------------
// The fp32 small-rank forward on the tensor cores (3xTF32 mma.sync)
// ---------------------------------------------------------------------------
namespace {
namespace f3 {

// The CTA's tile: BM x BN of y, four warps of 32 x 64 (two m16 x eight
// n8 tiles; warp (wm, wn) = (warp / 2, warp % 2)); a 3-stage cp.async
// ring BK deep; two CTAs an SM.  (Measured on an H100 against 128 x 128
// tiles of eight warps and against 64-wide tiles: equal or faster at
// encoder-small's three shapes.)
constexpr int BM = 64, BN = 128, BK = 32, STAGES = 3, THREADS = 128;
constexpr int MT = 2, NT = 8, WN = 64;
constexpr int MAX_R = 16;        // V's columns: one or two n8 blocks
constexpr int XS = BK + 4;       // x tile row stride (4 mod 32)
constexpr int WS = BN + 8;       // W tile row stride (8 mod 32)
constexpr int VS = MAX_R + 8;    // V tile row stride (24 mod 32)
constexpr int PS = MAX_R + 1;    // p and B rows in the epilogue
constexpr int kMaxDevices = 64;

constexpr int STAGE = BM * XS + BK * WS + BK * VS;
constexpr int SMEM = (STAGES * STAGE + (BM + BN) * PS) * (int)sizeof(float);

struct Args {
  const float *x, *w, *v, *b;
  float* y;
  float* p;                // (M, r), written by column tile 0, or null
  int M, K, N, r;
  int x_mode, w_mode;      // Copy modes of x's and W's rows
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// How a stage copies the rows of x or W: kVec, 16-byte pieces (a row
// length that is a multiple of 4 and a 16-byte-aligned base); kShift,
// 16-byte pieces from the 16-byte boundary at or before each row's first
// element (a row length that is not a multiple of 4: that row's piece
// starts s = (row index x row length) mod 4 floats early, and the reads
// add s, which is constant for a lane: (g K) mod 4 for x, (t N) mod 4
// for W), pieces clipped at the row's end; kScalar, 4-byte copies (a
// base off the 16-byte boundary).
enum Copy { kVec, kShift, kScalar };

// rows x (cols + shift room) floats of the row-major matrix `src` (row
// length `len`, `nrows` rows) from row r0, column c0, into dst (row
// stride ds): zero past nrows and len, by the CTA's threads
template <int MODE, int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(float* dst, int ds, const float* src,
                                          int len, int nrows, int r0,
                                          int c0) {
  const int tid = threadIdx.x;
  if constexpr (MODE == kScalar) {
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int row = e / COLS, q = e % COLS;
      const bool ok = r0 + row < nrows && c0 + q < len;
      cp4(dst + row * ds + q,
          ok ? src + (long long)(r0 + row) * len + c0 + q : src, ok);
    }
  } else {
    // kShift: one more piece, for the row's early start
    constexpr int P = COLS / 4 + (MODE == kShift ? 1 : 0);
    for (int e = tid; e < ROWS * P; e += THREADS) {
      const int row = e / P, j = e % P;
      const long long at = (long long)(r0 + row) * len + c0;
      const int col = c0 - (MODE == kShift ? (int)(at & 3) : 0) + 4 * j;
      int n = r0 + row < nrows ? len - col : 0;
      n = n < 0 ? 0 : (n > 4 ? 4 : n);
      cp16n(dst + row * ds + 4 * j, n ? src + (at - c0) + col : src, 4 * n);
    }
  }
}

// copy_tile in the mode the launch chose (a uniform branch: every mode
// is compiled into one kernel)
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_mode(int mode, float* dst, int ds,
                                          const float* src, int len,
                                          int nrows, int r0, int c0) {
  if (mode == kVec)
    copy_tile<kVec, ROWS, COLS>(dst, ds, src, len, nrows, r0, c0);
  else if (mode == kShift)
    copy_tile<kShift, ROWS, COLS>(dst, ds, src, len, nrows, r0, c0);
  else
    copy_tile<kScalar, ROWS, COLS>(dst, ds, src, len, nrows, r0, c0);
}

// Stage k0 / BK of the ring: x[m0.., k0..] (BM x BK), W[k0.., n0..] (BK x
// BN) and V[k0.., 0..16), zero past M, K, N and r; V's rows of r floats
// by 4-byte copies.
__device__ __forceinline__ void load_stage(const Args& a, float* st, int m0,
                                           int n0, int k0) {
  float* vt = st + BM * XS + BK * WS;
  copy_mode<BM, BK>(a.x_mode, st, XS, a.x, a.K, a.M, m0, k0);
  copy_mode<BK, BN>(a.w_mode, st + BM * XS, WS, a.w, a.N, a.K, k0, n0);
  for (int e = threadIdx.x; e < BK * MAX_R; e += THREADS) {
    const int row = e / MAX_R, c = e % MAX_R;
    const bool ok = k0 + row < a.K && c < a.r;
    cp4(vt + row * VS + c, ok ? a.v + (long long)(k0 + row) * a.r + c : a.v,
        ok);
  }
}

// One CTA: y[m0 : m0 + BM, n0 : n0 + BN] = x W + p Bᵀ with p = x V, for a
// rank r <= R (R = 4, 8 or 16).  Warp (wm, wn) holds y rows wm 32 + 16 mt
// + (g, g + 8) and columns wn BN/2 + 8 nt + (2t, 2t + 1), and p's rows of
// its m16 tile mt = wn in RP = R / 8 n8 blocks of V's columns (one for R
// <= 8): its share of p reuses the x fragments it already holds, and the
// CTA's warps cover its BM rows of p once.  Every product is 3xTF32:
// lo.hi, hi.lo, then hi.hi into one fp32 sum, each pass over all of the
// warp's tiles before the next, and a step's fragments are read from
// shared memory while the step before it runs.  p stays fp32, and the
// epilogue adds p Bᵀ by fp32 FMAs in c order, from B's and p's values in
// registers.
template <int R>
__global__ void __launch_bounds__(THREADS, 2)
    small_rank_kernel(const Args a) {
  constexpr int RP = (R + 7) / 8;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem + STAGES * STAGE;  // p (BM x PS)
  float* bs = ps + BM * PS;           // B's tile rows (BN x PS)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (a.K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n)
      load_stage(a, smem + s * STAGE, m0, n0, BK * s);
    cp_commit();
  }
  // B's rows n0 .. n0 + BN, read once for the epilogue (zero past r)
  for (int e = tid; e < BN * R; e += THREADS) {
    const int n = e / R, c = e % R;
    bs[n * PS + c] =
        n0 + n < a.N && c < a.r ? a.b[(long long)(n0 + n) * a.r + c] : 0.f;
  }

  float acc[MT][NT][4], pacc[RP][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int rp = 0; rp < RP; ++rp)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[rp][e] = 0.f;

  // a step's operands as read from shared memory (natural k order: a
  // lane's k are t and t + 4)
  float xa[MT][4], wb[NT][2], vb[RP][2];
  // the lane's shift of a row's first element (kShift copies)
  const int sx = a.x_mode == kShift ? (int)(((long long)g * a.K) & 3) : 0;
  const int sw = a.w_mode == kShift ? (int)(((long long)t * a.N) & 3) : 0;
  auto read = [&](const float* st, int kk) {
    const float* xs = st + (wm * 32 + g) * XS + sx + kk + t;
    const float* wt = st + BM * XS + (kk + t) * WS + sw + wn * WN + g;
    const float* vt = st + BM * XS + BK * WS + (kk + t) * VS + g;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      xa[mt][0] = xs[16 * mt * XS];
      xa[mt][1] = xs[(16 * mt + 8) * XS];
      xa[mt][2] = xs[16 * mt * XS + 4];
      xa[mt][3] = xs[(16 * mt + 8) * XS + 4];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      wb[nt][0] = wt[8 * nt];
      wb[nt][1] = wt[4 * WS + 8 * nt];
    }
#pragma unroll
    for (int rp = 0; rp < RP; ++rp) {
      vb[rp][0] = vt[8 * rp];
      vb[rp][1] = vt[4 * VS + 8 * rp];
    }
  };

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed, and every warp is past kt - 1
    {
      const int nk = kt + STAGES - 1;
      if (nk < kt_n)
        load_stage(a, smem + (nk % STAGES) * STAGE, m0, n0,
                                   BK * nk);
      cp_commit();
    }
    const float* st = smem + (kt % STAGES) * STAGE;
    read(st, 0);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
      uint32_t vh[RP][2], vl[RP][2], ph[4], pl[4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) split(xa[mt][i], ah[mt][i], al[mt][i]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) split(wb[nt][i], bh[nt][i], bl[nt][i]);
#pragma unroll
      for (int rp = 0; rp < RP; ++rp)
#pragma unroll
        for (int i = 0; i < 2; ++i) split(vb[rp][i], vh[rp][i], vl[rp][i]);
      if (kk + 8 < BK) read(st, kk + 8);  // the next step's operands
      // the warp's p tile is its m16 tile wn: its fragments by selects,
      // so that the step stays one basic block for the scheduler
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ph[i] = wn ? ah[1][i] : ah[0][i];
        pl[i] = wn ? al[1][i] : al[0][i];
      }
      // the three products of a tile into its one sum, each pass over
      // every tile before the next: a sum's products are a pass apart
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int rp = 0; rp < RP; ++rp) mma(pacc[rp], pl, vh[rp]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int rp = 0; rp < RP; ++rp) mma(pacc[rp], ph, vl[rp]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], ah[mt], bh[nt]);
#pragma unroll
      for (int rp = 0; rp < RP; ++rp) mma(pacc[rp], ph, vh[rp]);
    }
  }

  // p of the CTA's rows into shared memory, fp32 (zero past r: V is)
#pragma unroll
  for (int rp = 0; rp < RP; ++rp)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * rp + 2 * t + (e & 1);
      if (c < R)
        ps[(wm * 32 + 16 * wn + g + 8 * (e >> 1)) * PS + c] = pacc[rp][e];
    }
  __syncthreads();
  if (a.p != nullptr && blockIdx.x == 0) {
    // p (M, r) row-major: the CTA's rows are one contiguous run
    const int rows = min(BM, a.M - m0);
    for (int e = tid; e < rows * a.r; e += THREADS)
      a.p[(long long)m0 * a.r + e] = ps[(e / a.r) * PS + e % a.r];
  }
  // y = x W + p Bᵀ: the rank term by fp32 FMAs in c order, B's values of
  // a column pair and p's of a row in registers
  const bool pairs =
      a.N % 2 == 0 && (reinterpret_cast<uintptr_t>(a.y) & 7) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * WN + 8 * nt + 2 * t;
    const int n = n0 + col;
    float b0[R], b1[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      b0[c] = bs[col * PS + c];
      b1[c] = bs[(col + 1) * PS + c];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = wm * 32 + 16 * mt + g + 8 * hr;
        float pr[R];
#pragma unroll
        for (int c = 0; c < R; ++c) pr[c] = ps[row * PS + c];
        float v0 = acc[mt][nt][2 * hr], v1 = acc[mt][nt][2 * hr + 1];
#pragma unroll
        for (int c = 0; c < R; ++c)
          if (c < a.r) {
            v0 = fmaf(pr[c], b0[c], v0);
            v1 = fmaf(pr[c], b1[c], v1);
          }
        if (m0 + row >= a.M) continue;
        float* yr = a.y + (long long)(m0 + row) * a.N;
        if (pairs && n < a.N) {
          *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
        } else {
          if (n < a.N) yr[n] = v0;
          if (n + 1 < a.N) yr[n + 1] = v1;
        }
      }
  }
}

template <int R>
int launch(const Args& a, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a launch needs an opt-in, set
  // once per instantiation and device
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !done[dev]) {
    err = cudaFuncSetAttribute(small_rank_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) done[dev] = true;
  }
  const dim3 grid((unsigned)((a.N + BN - 1) / BN),
                  (unsigned)((a.M + BM - 1) / BM));
  small_rank_kernel<R><<<grid, THREADS, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// a matrix's copy mode: 16-byte pieces from a 16-byte-aligned base
// (kVec, or kShift for rows that are not a multiple of 4 long), else
// 4-byte copies
int copy_mode_of(const float* base, int len) {
  if (!aligned16(base)) return kScalar;
  return len % 4 == 0 ? kVec : kShift;
}

}  // namespace f3
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

// The fp32 small-rank route (3xTF32 mma.sync, one launch): x (M, K), w (K,
// N), v (K, r), b (N, r) and y (M, N) fp32 and contiguous, 1 <= r <= 16;
// p (M, r) fp32 receives p = x V (the return_p output), or is null.
// Returns cudaGetLastError() of the launch (0 = queued).
extern "C" int lowrank_forward_f3_launch(const float* x, const float* w,
                                         const float* v, const float* b,
                                         float* y, float* p, int M, int K,
                                         int N, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 0 || N < 1 || r < 1 || r > f3::MAX_R)
    return (int)cudaErrorInvalidValue;
  const f3::Args a{x, w, v, b, y, p, M, K, N, r,
                   f3::copy_mode_of(x, K), f3::copy_mode_of(w, N)};
  // the rank bucket R (4, 8 or 16): r <= R
  if (r <= 4) return f3::launch<4>(a, st);
  if (r <= 8) return f3::launch<8>(a, st);
  return f3::launch<f3::MAX_R>(a, st);
}
