// Hopper (sm_90a) ports of the TPU kernels
// repro/kernels/lowrank_update.py::lowrank_merge and ::lowrank_merge_sr,
// the outer step's weight merge (Algorithm 1, line 8):
//
//     W' = W + V Bᵀ        W (K, N), V (K, r), B (N, r); fp32 accumulate,
//                          W' in W's dtype
//     W' = sr_bf16(W + V Bᵀ, bits)
//                          the same sum stochastically rounded into a
//                          bf16 W with caller-supplied (K, N) noise in
//                          [0, 2^16): bf16 masters stay unbiased across
//                          outer cycles
//
// over `batch` leading items (a group's (G, L) dims folded) in one launch.
// The dtypes are mixed on the training path: W is the stored parameter
// (bf16 for the paper's models), V is stored in the compute dtype and B is
// the fp32 master.  The rank-r product accumulates in fp32 and the sum is
// rounded once, into W's dtype.
//
// The TPU kernel tiles (bk, bn) output blocks with the whole rank
// resident in VMEM and vmaps over the leading dims.  What bounds the work
// on this card is bytes: W is read and written (77% of them at the
// llama-100m shapes), and r = 128 gives 2r FLOP per W element, far below
// the ~295 FLOP per byte where the tensor cores would bind.  Four
// kernels, chosen by the Python wrapper (lowrank_update.py::merge_route):
//
// * tensor cores (lowrank_merge_tc_launch; bf16 W and V, fp32 or bf16 B,
//   K, N and r multiples of 8 so TMA can address every row, no bits):
//   a tile is one item's 128 x 64 block of W' (two warpgroups of 64 rows,
//   wgmma m64n64k16).  V's 128 x r rows are A (K-major, read as stored,
//   by TMA); B's 64 x r rows are B (K-major), read from global memory by
//   the threads and written into the 128-byte-swizzled stage that wgmma
//   reads: an fp32 B as hi = bf16(B) and lo = bf16(B - hi), two reduction
//   segments V B_hiᵀ + V B_loᵀ into one fp32 accumulator (V is exact in
//   bf16, so the product keeps 16 bits of B), a bf16 B as one.  The split
//   happens here, not in a pre-pass that would write and read B twice
//   more.  The epilogue adds the W tile (TMA-loaded into shared memory)
//   in fp32, rounds once to bf16 (round to nearest even), writes the tile
//   back over W's copy and stores it with one TMA store.  The maps are 3-D
//   (column, row, item), so the ragged edges of an item (K = 1712 = 13 x
//   128 + 48) zero-fill and clip at that item.
//   Each tile is a chain of latencies (B from L2, V's TMA, the product, W,
//   the store) around little work, so the kernel keeps several tiles in
//   flight on every SM: 96 KB of shared memory lets two persistent blocks
//   share an SM, and each block requests the next tile's V and B as soon
//   as this tile's products are done and its W into a second buffer, so
//   that they arrive during this tile's epilogue and store.  Where K has
//   few 128-row tiles, the grid strides over tiles in groups of 8 column
//   tiles with the k tiles of a group in turn: the tiles in flight
//   together are neighbours, so W moves in runs of 1 KB per row and the
//   V and B a tile reads sit in L2, however wide N is (16.5 MB of fp32 B
//   at the unembedding).  Where K has 8 tiles or more (llama-100m's
//   w_down, K = 1712), each block walks contiguous column strips, k tiles
//   fastest, and splits a B tile once for its whole strip.  These choices
//   were taken against one block per tile and against each other on an
//   H100, at llama-100m's group shapes.  In place (out = w) is safe: each
//   tile reads its own W region before it writes it, and no other tile
//   touches it.
// * the stochastically rounded merge (lowrank_merge_sr_launch; bf16 W,
//   fp32 or bf16 V and B, any K, N, r): fp32 FMAs, exact against the
//   plain version.  See the msr namespace below.
// * the small-rank merge (lowrank_merge_ew_launch; the plain merge of an
//   fp32 W or V at r <= 16, encoder-small's r = 4): an elementwise pass
//   over W with B's strip and V's rows staged once a block and the rank-r
//   product in registers.  See the mew namespace below.
// * SIMT (lowrank_merge_launch; the plain merge of an fp32 W or V at r >
//   16, where 2r FLOP per element make the fp32 FMAs bind, and bf16 rows
//   TMA cannot address): one block owns a 64 x 64 tile of one batch item
//   (gemm_tile.cuh, blockIdx.z = item) on fp32 FMAs; W is the addend of
//   the tile's epilogue and may be the output itself (each element is
//   read and written by the same thread).
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/lowrank_update.py) allocates the output.

#include <algorithm>

#include "device_fit.cuh"
#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

namespace {

using lrk::Gemm;
using lrk::View;

template <typename TW, typename TV, typename TB>
int merge(const void* w, const void* v, const void* b, void* out,
          int64_t batch, int K, int N, int r, cudaStream_t st) {
  Gemm<TV, TB, float, float, TW, TW> g{};
  g.a = View<TV>{static_cast<const TV*>(v), r, 1, (int64_t)K * r};
  // Bᵀ(c, n) = b[n * r + c]
  g.b = View<TB>{static_cast<const TB*>(b), 1, r, (int64_t)N * r};
  g.c = static_cast<const TW*>(w);
  g.c_batch = (int64_t)K * N;
  g.out = static_cast<TW*>(out);
  g.out_batch = (int64_t)K * N;
  g.rows = K;
  g.cols = N;
  g.k = r;
  g.splits = 1;
  return lrk::launch_gemm(g, batch, st);
}

template <typename TW, typename TV>
int pick_b(int tb, const void* w, const void* v, const void* b, void* out,
           int64_t batch, int K, int N, int r, cudaStream_t st) {
  if (tb == 0) return merge<TW, TV, float>(w, v, b, out, batch, K, N, r, st);
  if (tb == 1)
    return merge<TW, TV, __nv_bfloat16>(w, v, b, out, batch, K, N, r, st);
  return (int)cudaErrorInvalidValue;
}

template <typename TW>
int pick_v(int tv, int tb, const void* w, const void* v, const void* b,
           void* out, int64_t batch, int K, int N, int r, cudaStream_t st) {
  if (tv == 0) return pick_b<TW, float>(tb, w, v, b, out, batch, K, N, r, st);
  if (tv == 1)
    return pick_b<TW, __nv_bfloat16>(tb, w, v, b, out, batch, K, N, r, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------

// (an unnamed namespace: prepare()'s static must not be one object across
// the libraries that are loaded together)
namespace {
namespace mtc {

constexpr int BM = 128;                  // rows of W per block (K)
constexpr int BN = 64;                   // columns of W per block (N)
constexpr int RK = 128;                  // rank depth per round: two stages
constexpr int THREADS = 256;             // two warpgroups
constexpr uint32_t V_STAGE = BM * 128;   // 128 rows x 64 ranks of V: 16 KB
constexpr uint32_t B_STAGE = BN * 128;   // 64 rows x 64 ranks of B: 8 KB
constexpr uint32_t W_BYTES = BM * BN * 2;  // a W tile: 16 KB
constexpr int B_UNITS = BN * 2 * 8 / THREADS;  // 8-value units per thread
constexpr int BLOCKS_PER_SM = 2;
constexpr int GROUP = 8;                 // column tiles per group (coords)
constexpr int STRIP_K_TILES = 8;         // k tiles from which strips pay
// align slack, V, B hi and lo, two W buffers, three mbarriers
constexpr size_t SMEM = 1024 + 2 * V_STAGE + 4 * B_STAGE + 2 * W_BYTES + 32;

struct Args {
  CUtensorMap w, v, out;   // 3-D (column, row, item); boxes of 64 x 128
  const void* b;           // `items` (N, r) matrices, fp32 or bf16
  int N, r, tiles_n, tiles_k;
};

// B's rows [n0, n0 + BN) and rank columns [c0, c0 + 64 stages) of one
// item, loaded into registers (an fp32 B as 8 values per unit, a bf16 B
// as one 16-byte vector); rows past N and ranks past r as zeros
struct BRegs {
  float4 x[B_UNITS][2];
  uint4 raw[B_UNITS];
};

template <bool F32B>
__device__ __forceinline__ void load_b(const Args& g, int item, int n0,
                                       int c0, int stages, BRegs& br) {
  const int per_row = 8 * stages;
#pragma unroll
  for (int i = 0; i < B_UNITS; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int n = u / per_row, k = c0 + 8 * (u % per_row);
    const bool in = n < BN && n0 + n < g.N && k < g.r;
    const size_t at = ((size_t)item * g.N + n0 + n) * g.r + k;
    if constexpr (F32B) {
      const float4* src =
          reinterpret_cast<const float4*>(static_cast<const float*>(g.b) + at);
      br.x[i][0] = in ? __ldg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      br.x[i][1] = in ? __ldg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      br.raw[i] = in ? __ldg(reinterpret_cast<const uint4*>(
                           static_cast<const __nv_bfloat16*>(g.b) + at))
                     : make_uint4(0, 0, 0, 0);
    }
  }
}

// the loaded B into the swizzled K-major stages at hi (and, for an fp32
// B, lo: split_hi_lo8)
template <bool F32B>
__device__ __forceinline__ void store_b(int stages, const BRegs& br,
                                        uint8_t* hi, uint8_t* lo) {
  const int per_row = 8 * stages;
#pragma unroll
  for (int i = 0; i < B_UNITS; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int n = u / per_row, q = u % per_row;
    if (n >= BN) continue;
    const uint32_t off = (q / 8) * B_STAGE + tc::swz128(n, q % 8);
    if constexpr (F32B) {
      uint4 h, l;
      tc::split_hi_lo8(br.x[i][0], br.x[i][1], h, l);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    } else {
      *reinterpret_cast<uint4*>(hi + off) = br.raw[i];
    }
  }
}

// Persistent and software-pipelined: the blocks (two per SM) walk their
// tiles one rank round (up to 128 deep) at a time.  As soon as a round's
// products are done, the next round's V (TMA) and B (into registers) are
// requested, and, after a tile's last round, the next tile's W into the
// other of two W buffers; all of them are in flight during this tile's
// epilogue and store.  Two tile orders (STRIP, chosen by the launch from
// the number of k tiles): with few k tiles, the grid strides over tiles
// in groups of GROUP column tiles, so the tiles in flight together are
// neighbours (W's rows read and written in runs of GROUP x 128 bytes, V
// and B from L2); with many, each block walks contiguous column strips
// and splits each B tile once for the whole strip.
template <bool F32B, bool STRIP>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    merge_tc_kernel(const __grid_constant__ Args g, int total) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sv = (raw + 1023u) & ~1023u;
  const uint32_t shi = sv + 2 * V_STAGE, slo = shi + 2 * B_STAGE;
  const uint32_t sw0 = slo + 2 * B_STAGE;          // W buffers 0 and 1
  const uint32_t bar_v = sw0 + 2 * W_BYTES, bar_w0 = bar_v + 8;
  uint8_t* gen = smem_raw + (sv - raw);
  uint8_t* hi = gen + (shi - sv);
  uint8_t* lo = gen + (slo - sv);
  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int rounds = (g.r + RK - 1) / RK;
  // tile t's place: STRIP, k tiles fastest; else in groups of GROUP
  // column tiles, the k tiles of a group in turn, its column tiles
  // fastest, so a tile's V and B tiles are read again within the group's
  // sweep, from L2, however wide N is
  auto coords = [&](int t, int& n0, int& k0, int& item) {
    const int per_item = g.tiles_k * g.tiles_n;
    if constexpr (STRIP) {
      k0 = (t % g.tiles_k) * BM;
      n0 = (t / g.tiles_k % g.tiles_n) * BN;
      item = t / per_item;
      return;
    }
    item = t / per_item;
    t %= per_item;
    const int first = t / (GROUP * g.tiles_k) * GROUP;
    const int width = min(GROUP, g.tiles_n - first);
    t -= first * g.tiles_k;
    k0 = (t / width) * BM;
    n0 = (first + t % width) * BN;
  };
  // STRIP: each block takes a contiguous run of tiles, k tiles fastest,
  // so consecutive tiles share their B tile (a column strip), which stays
  // split in shared memory down the strip
  const int t_begin = STRIP ? (int)((int64_t)blockIdx.x * total / gridDim.x)
                            : (int)blockIdx.x;
  const int t_end = STRIP ? (int)((int64_t)(blockIdx.x + 1) * total /
                                  gridDim.x)
                          : total;
  const int t_step = STRIP ? 1 : (int)gridDim.x;
  auto stages_of = [&](int q) { return min(2, (g.r - q * RK + 63) / 64); };
  // round q of tile t: its V by TMA (thread 0), its B into registers
  BRegs br;
  auto request = [&](int t, int q, bool with_b) {
    int n0, k0, item;
    coords(t, n0, k0, item);
    const int c0 = q * RK, stages = stages_of(q);
    if (tid == 0) {
      tc::mbar_expect_tx(bar_v, stages * V_STAGE);
      for (int s = 0; s < stages; ++s)
        tc::tma_load3(sv + s * V_STAGE, &g.v, bar_v, c0 + 64 * s, k0, item);
    }
    if (with_b) load_b<F32B>(g, item, n0, c0, stages, br);
  };

  if (tid == 0) {
    tc::mbar_init(bar_v, 1);
    tc::mbar_init(bar_w0, 1);
    tc::mbar_init(bar_w0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (t_begin < t_end) {
      int n0, k0, item;
      coords(t_begin, n0, k0, item);
      tc::mbar_expect_tx(bar_w0, W_BYTES);
      tc::tma_load3(sw0, &g.w, bar_w0, n0, k0, item);
    }
  }
  __syncthreads();
  if (t_begin < t_end) request(t_begin, 0, true);

  uint32_t vphase = 0;
  bool b_loaded = true;     // the registers hold B for the next round
  int i = 0;
  for (int t = t_begin; t < t_end; t += t_step, ++i) {
    int n0, k0, item;
    coords(t, n0, k0, item);
    const int buf = i & 1;
    const int next = t + t_step;
    float d[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) d[j] = 0.f;
    tc::fence_regs(d);
    for (int q = 0; q < rounds; ++q) {
      const int stages = stages_of(q);
      if (b_loaded) store_b<F32B>(stages, br, hi, lo);
      tc::fence_proxy_async();
      __syncthreads();
      tc::mbar_wait(bar_v, vphase);
      vphase ^= 1;
      tc::wg_fence();
      for (int s = 0; s < stages; ++s) {
        const uint32_t a = sv + s * V_STAGE + wg * tc::BOX;
        tc::mma_stage<BN, 0, 0>(d, a, shi + s * B_STAGE);
        if constexpr (F32B) tc::mma_stage<BN, 0, 0>(d, a, slo + s * B_STAGE);
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(d);
      __syncthreads();   // V and the B stages are free
      if (q + 1 < rounds) {
        request(t, q + 1, true);
        b_loaded = true;
      } else if (next < t_end) {
        // a strip's next tile keeps the split B of this one
        b_loaded = !(STRIP && rounds == 1 &&
                     next / g.tiles_k == t / g.tiles_k);
        request(next, 0, b_loaded);
      }
    }
    // the next tile's W into the other buffer, once the store that read it
    // (the tile before this one) is done reading
    if (tid == 0 && next < t_end) {
      tc::tma_store_wait_read();
      int n1, k1, item1;
      coords(next, n1, k1, item1);
      tc::mbar_expect_tx(bar_w0 + 8 * (buf ^ 1), W_BYTES);
      tc::tma_load3(sw0 + (buf ^ 1) * W_BYTES, &g.w, bar_w0 + 8 * (buf ^ 1),
                    n1, k1, item1);
    }
    // W' = W + acc, rounded once, over W's tile; then one TMA store
    const uint32_t sw = sw0 + buf * W_BYTES;
    tc::mbar_wait(bar_w0 + 8 * buf, (i >> 1) & 1);
    uint8_t* wt = gen + (sw - sv);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * warp + lane / 4 + 8 * h;
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
            wt + tc::swz128(row, j) + 4 * (lane % 4));
        const float2 wf = __bfloat1622float2(*at);
        *at = __floats2bfloat162_rn(wf.x + d[4 * j + 2 * h],
                                    wf.y + d[4 * j + 2 * h + 1]);
      }
    tc::fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tc::tma_store3(&g.out, sw, n0, k0, item);
      tc::tma_store_commit();
    }
  }
  if (tid == 0) tc::tma_store_wait_read();
}

template <bool F32B>
int prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(merge_tc_kernel<F32B, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(merge_tc_kernel<F32B, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

template <bool F32B>
int launch(const void* w, const void* v, const void* b, void* out,
           int64_t items, int K, int N, int r, cudaStream_t st) {
  int err = prepare<F32B>();
  if (err != 0) return err;
  Args g;
  memset(&g, 0, sizeof(g));
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  err = tc::make_map3(&g.w, w, bf, 2, items, K, N, 64, BM, sw);
  if (err == 0) err = tc::make_map3(&g.out, out, bf, 2, items, K, N, 64, BM, sw);
  if (err == 0) err = tc::make_map3(&g.v, v, bf, 2, items, K, r, 64, BM, sw);
  if (err != 0) return err;
  g.b = b;
  g.N = N;
  g.r = r;
  g.tiles_n = (int)tc::ceil_div(N, BN);
  g.tiles_k = (int)tc::ceil_div(K, BM);
  const int64_t blocks = items * g.tiles_n * g.tiles_k;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  const int64_t grid = std::min(blocks, (int64_t)BLOCKS_PER_SM * sms);
  if (g.tiles_k >= STRIP_K_TILES)
    merge_tc_kernel<F32B, true><<<(unsigned)grid, THREADS, SMEM, st>>>(
        g, (int)blocks);
  else
    merge_tc_kernel<F32B, false><<<(unsigned)grid, THREADS, SMEM, st>>>(
        g, (int)blocks);
  return (int)cudaGetLastError();
}

}  // namespace mtc
}  // namespace

// ---------------------------------------------------------------------------
// The small-rank merge: an elementwise pass
// ---------------------------------------------------------------------------
//
// W' = W + V Bᵀ for an fp32 W or V (the dtypes the tensor-core merge does
// not take) of rank r <= 16: encoder-small's fine-tuning merges at r = 4.
// What bounds it is bytes: W is read and written, and the product adds at
// most 2 r = 32 FLOP per W element, so the merge is an elementwise pass
// over W and the rank-r product rides along in registers:
//
// * one launch over every item of a group; a block owns ROWS rows of K
//   and a strip of STRIP columns of one item, and the grid holds several
//   blocks an SM (encoder-small's groups: 344-768 blocks of 256 threads);
// * a block stages its strip of B's rows (STRIP x r) and its ROWS rows of
//   V in shared memory once, widened to fp32; a thread keeps B's values
//   of its COLS consecutive columns in registers (r rounded up to 4, 8 or
//   16: few registers, so many blocks an SM) and walks ROWS / LANES rows,
//   reading each V row from shared memory (a broadcast);
// * a thread's COLS columns move by one 16-byte access (8 bytes for a
//   bf16 W) where N % 4 == 0 and the pointers allow it, by scalar ones
//   otherwise (N = 683); it loads all its rows of W before it stores any;
// * each element: acc = 0; for c < r: acc = fmaf(V[k][c], B[n][c], acc);
//   W' = W + acc, rounded once into W's dtype; a fixed order, so
//   repeated launches give bit-identical outputs.
//
// In place (out = w) is safe: a thread reads each W element it writes,
// before writing it, and no other thread touches it.
namespace {
namespace mew {

constexpr int THREADS = 256;
constexpr int COLS = 4;                       // consecutive n a thread
constexpr int STRIP = 256;                    // columns a block
constexpr int LANES = THREADS / (STRIP / COLS);  // rows in flight: 4
constexpr int ROWS = 8;                       // rows of K a block
constexpr int MAX_R = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void load4(const float* p, float (&o)[COLS]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[COLS]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[COLS]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&o)[COLS]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(o[0], o[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = q;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void *w, *v, *b;
  void* out;
  int K, N, r, kblocks, strips;
  bool vec;  // 16-byte (bf16 W: 8-byte) accesses of W and out
};

// block (item, k block, strip) of a 1-D grid, the strip fastest; RB:
// the rank rounded up to 4, 8 or 16 (B's values a thread keeps)
template <typename TW, typename TV, typename TB, int RB>
__global__ void __launch_bounds__(THREADS) small_rank_merge(const Args a) {
  __shared__ __align__(16) float bs[RB * STRIP];  // [c][n]
  __shared__ float vs[ROWS * RB];                 // [k][c]
  long long bid = blockIdx.x;
  const int strip = (int)(bid % a.strips);
  bid /= a.strips;
  const int kb = (int)(bid % a.kblocks);
  const long long item = bid / a.kblocks;
  const int K = a.K, N = a.N, r = a.r;
  const int n0 = STRIP * strip, k0 = ROWS * kb;
  const int tid = threadIdx.x, tc = tid % (STRIP / COLS),
            lr = tid / (STRIP / COLS);
  const TW* w = static_cast<const TW*>(a.w) + item * K * (long long)N;
  TW* out = static_cast<TW*>(a.out) + item * K * (long long)N;
  const TV* v = static_cast<const TV*>(a.v) + item * K * (long long)r;
  const TB* b = static_cast<const TB*>(a.b) + item * N * (long long)r;
  // B's rows n0 .. n0 + STRIP and V's rows k0 .. k0 + ROWS: contiguous
  // runs of (N, r) and (K, r)
  const int ncols = min(STRIP, N - n0), nrows = min(ROWS, K - k0);
  for (int e = tid; e < ncols * r; e += THREADS) {
    const int n = e / r, c = e - n * r;
    bs[c * STRIP + n] = to_f(b[(long long)n0 * r + e]);
  }
  for (int e = tid; e < nrows * r; e += THREADS) {
    const int k = e / r, c = e - k * r;
    vs[k * RB + c] = to_f(v[(long long)k0 * r + e]);
  }
  __syncthreads();
  const int n = n0 + COLS * tc;
  if (n >= N) return;
  float bv[RB][COLS];
#pragma unroll
  for (int c = 0; c < RB; ++c)
    if (c < r) {
      const float4 q = *reinterpret_cast<const float4*>(bs + c * STRIP +
                                                        COLS * tc);
      bv[c][0] = q.x;
      bv[c][1] = q.y;
      bv[c][2] = q.z;
      bv[c][3] = q.w;
    }
  constexpr int RT = ROWS / LANES;  // rows a thread
  float wv[RT][COLS];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kl = lr + LANES * i;
    if (kl >= nrows) continue;
    const TW* src = w + (long long)(k0 + kl) * N + n;
    if (a.vec) {
      load4(src, wv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        wv[i][j] = n + j < N ? to_f(src[j]) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kl = lr + LANES * i;
    if (kl >= nrows) continue;
    float o[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < RB; ++c)
        if (c < r) acc = fmaf(vs[kl * RB + c], bv[c][j], acc);
      o[j] = __fadd_rn(wv[i][j], acc);
    }
    TW* dst = out + (long long)(k0 + kl) * N + n;
    if (a.vec) {
      store4(dst, o);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (n + j < N) store1(dst + j, o[j]);
    }
  }
}

template <typename TW, typename TV, typename TB, int RB>
int launch(const void* w, const void* v, const void* b, void* out,
           long long items, int K, int N, int r, cudaStream_t st) {
  const uintptr_t align = COLS * sizeof(TW) - 1;
  const bool vec = N % COLS == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & align) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & align) == 0;
  Args a{w, v, b, out, K, N, r, (K + ROWS - 1) / ROWS,
         (N + STRIP - 1) / STRIP, vec};
  const long long blocks = items * a.kblocks * a.strips;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  small_rank_merge<TW, TV, TB, RB><<<(unsigned)blocks, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW, typename TV, typename TB>
int pick_rank(const void* w, const void* v, const void* b, void* out,
              long long items, int K, int N, int r, cudaStream_t st) {
  if (r <= 4) return launch<TW, TV, TB, 4>(w, v, b, out, items, K, N, r, st);
  if (r <= 8) return launch<TW, TV, TB, 8>(w, v, b, out, items, K, N, r, st);
  return launch<TW, TV, TB, MAX_R>(w, v, b, out, items, K, N, r, st);
}

template <typename TW, typename TV>
int pick_b(int tb, const void* w, const void* v, const void* b, void* out,
           long long items, int K, int N, int r, cudaStream_t st) {
  if (tb == 0)
    return pick_rank<TW, TV, float>(w, v, b, out, items, K, N, r, st);
  if (tb == 1)
    return pick_rank<TW, TV, __nv_bfloat16>(w, v, b, out, items, K, N, r,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// the dtypes the route takes: an fp32 W or V
int pick_wv(int tw, int tv, int tb, const void* w, const void* v,
            const void* b, void* out, long long items, int K, int N, int r,
            cudaStream_t st) {
  if (tw == 0 && tv == 0)
    return pick_b<float, float>(tb, w, v, b, out, items, K, N, r, st);
  if (tw == 0 && tv == 1)
    return pick_b<float, __nv_bfloat16>(tb, w, v, b, out, items, K, N, r,
                                        st);
  if (tw == 1 && tv == 0)
    return pick_b<__nv_bfloat16, float>(tb, w, v, b, out, items, K, N, r,
                                        st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mew
}  // namespace

// ---------------------------------------------------------------------------
// The stochastically rounded merge
// ---------------------------------------------------------------------------
//
// out = sr_bf16(fp32(W) + V Bᵀ, bits), exact against the plain version
// (ref.lowrank_merge_sr: an fp32 product, then an fp32 add of W, then
// the round).  Exactness is the contract, not a choice: every round of
// the sum (stochastic, nearest, truncating) lands on one of the two bf16
// neighbours of it, so only equality with the plain version shows that
// the stochastic one ran (chip_smoke.py and the cuda tests check it).
// So each element is the chain the plain version computes:
//
//     acc = 0;  for c = 0 .. r-1:  acc = fmaf(V[m][c], B[n][c], acc)
//     x = acc + fp32(W[m][n])      (__fadd_rn: never contracted into the
//                                   last FMA)
//     out = top 16 bits of (bits(x) + bits[m][n])
//
// with no split of r, no tree or paired sum, no tensor cores (wgmma's
// fp32 accumulation is not a chain of IEEE FMAs).  The same order holds
// for fp32 V or B, and for the ragged rank of the last round: the loop
// stops at r, it adds no zero products.
//
// What bounds it: at r = 128, 2 r FLOP per W element on the fp32 FMA
// pipes (67 TFLOP/s) take 1.45-1.5x the time of its bytes (W read and
// written, 2 B each, and 4 B of bits, 75% of them).  So the design feeds
// the FMA pipes first:
//
// * a block owns one item's 128 x 128 tile of W at a time; 256 threads,
//   each 8 rows x 8 columns (64 accumulators), two blocks an SM
//   (__launch_bounds__(256, 2), 72 KB of shared memory each);
// * V's 128 rows and B's 128 rows are staged 64 ranks a round into
//   shared memory rank-major and widened to fp32 (s[c][row], a 4-float
//   gap after every 32 rows), so that one rank step is, per thread, two
//   16-byte reads of its 8 V values and two of its 8 B values, then 64
//   FMAs: no conversion in the loop, the V reads broadcast within a
//   quarter-warp (its 8 lanes share their rows) and the B reads of a
//   quarter-warp's 8 lanes fall in 32 distinct banks (the gap).  TMA
//   would land the operands as stored (row-major, bf16), so the threads
//   stage them: every 16-byte load of a round first, then the stores;
// * the epilogue gives each thread 8 contiguous columns of each of its
//   rows: one 16-byte W read, two 16-byte bits reads and one 16-byte
//   store per 8 elements (scalar at a ragged right edge or an unaligned
//   pointer);
// * the blocks are persistent (as many as the card holds at once) and
//   walk the tiles k-fastest, so the tiles in flight together share
//   their B tile (the unembedding's 8.3 MB B is read once from HBM) and
//   an item's V stays in L2.  One block's staging and epilogue run under
//   the other block's products on its SM where the two fall out of step.
//
// Measured on an H100 (chip_smoke.py's [kernel] rows; the design notes in
// PERF.md): the products alone run at about 0.65 of the FMA peak (cuBLAS's
// sgemm of V Bᵀ alone is slower), staging and epilogue add what the other
// block does not hide.  A warp-specialized form (one block an SM,
// producer warps staging V and B and copying W and bits by cp.async)
// was slower: its 8 consumer warps ran the products further from the
// peak.
//
// In place (out = w) is safe: a thread reads each W element it writes,
// before writing it, and no other thread touches it.
namespace {
namespace msr {

constexpr int TILE = 128;        // rows (K) and columns (N) of W per block
constexpr int RC = 64;           // ranks staged per round
constexpr int THREADS = 256;     // 16 x 16 threads of 8 x 8 outputs
constexpr int LD = TILE + 16;    // a staged rank: 128 values, 4 gaps of 4
constexpr size_t SMEM = 2 * RC * LD * sizeof(float);  // V and B: 73,728 B

__device__ __forceinline__ int skew(int i) { return i + 4 * (i >> 5); }

__device__ __forceinline__ void widen16(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen16(const uint4& u, float (&x)[8]) {
  const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(wd[k] << 16);
    x[2 * k + 1] = __uint_as_float(wd[k] & 0xFFFF0000u);
  }
}

// rows [row0, row0 + TILE) and ranks [c0, c0 + RC) of a row-major
// (rows, r) operand into s[c][skew(row)] as fp32; zeros outside it.  A
// warp's 32 lanes take 32 consecutive rows of one 16-byte unit column, so
// the stores of one rank fall in distinct banks.  Every load first.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ p, int rows,
                                      int r, int row0, int c0, bool vec,
                                      float* __restrict__ s) {
  constexpr int E = 16 / sizeof(T);
  constexpr int UNITS = TILE * RC / E / THREADS;
  uint4 u[UNITS];
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int q = threadIdx.x + k * THREADS;
    const int gr = row0 + q % TILE, gc = c0 + (q / TILE) * E;
    const T* src = p + (size_t)gr * r + gc;
    if (vec && gr < rows && gc < r) {
      u[k] = *reinterpret_cast<const uint4*>(src);
    } else {
      alignas(16) T x[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[e] = (gr < rows && gc + e < r) ? src[e] : T(0.f);
      u[k] = *reinterpret_cast<const uint4*>(x);
    }
  }
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int q = threadIdx.x + k * THREADS;
    const int row = q % TILE, c = (q / TILE) * E;
    float x[E];
    widen16(u[k], x);
#pragma unroll
    for (int e = 0; e < E; ++e) s[(c + e) * LD + skew(row)] = x[e];
  }
}

// the bf16 bits of sr_bf16(acc + W) (w16: W's bf16 bits)
__device__ __forceinline__ uint32_t sr16(float acc, uint32_t w16,
                                         uint32_t bits) {
  const float x = __fadd_rn(acc, __uint_as_float(w16 << 16));
  return (__float_as_uint(x) + bits) >> 16;
}

template <typename TV, typename TB>
__global__ void __launch_bounds__(THREADS, 2)
    merge_sr_kernel(const __nv_bfloat16* w, const TV* v, const TB* b,
                    const uint32_t* bits, __nv_bfloat16* out, int K, int N,
                    int r, int tiles_k, int tiles_n, int64_t total,
                    bool vec_v, bool vec_b, bool vec_n) {
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);
  float* sb = sv + RC * LD;
  const int64_t per_item = (int64_t)tiles_k * tiles_n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a warp is 4 x 8 threads: a quarter-warp shares its 8 rows
  const int tm = (warp / 2) * 4 + lane / 8, tn = (warp % 2) * 8 + lane % 8;
  const float* pa = sv + skew(8 * tm);
  const float* pb = sb + skew(8 * tn);

  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    const int64_t item = t / per_item;
    const int in = (int)(t % per_item);
    const int m0 = (in % tiles_k) * TILE, n0 = (in / tiles_k) * TILE;
    const TV* vi = v + item * K * r;
    const TB* bi = b + item * N * r;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < r; c0 += RC) {
      __syncthreads();             // the last round's reads are done
      stage(vi, K, r, m0, c0, vec_v, sv);
      stage(bi, N, r, n0, c0, vec_b, sb);
      __syncthreads();
      const int cnt = min(RC, r - c0);
#pragma unroll 4
      for (int c = 0; c < cnt; ++c) {
        const float4 a0 = *reinterpret_cast<const float4*>(pa + c * LD);
        const float4 a1 = *reinterpret_cast<const float4*>(pa + c * LD + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(pb + c * LD);
        const float4 b1 = *reinterpret_cast<const float4*>(pb + c * LD + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    const int gn = n0 + 8 * tn;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + 8 * tm + i;
      if (gm >= K) break;
      const size_t at = ((size_t)item * K + gm) * N + gn;
      if (vec_n && gn + 8 <= N) {
        const uint4 wq = *reinterpret_cast<const uint4*>(w + at);
        const uint4 q0 = *reinterpret_cast<const uint4*>(bits + at);
        const uint4 q1 = *reinterpret_cast<const uint4*>(bits + at + 4);
        const uint32_t wd[4] = {wq.x, wq.y, wq.z, wq.w};
        const uint32_t bt[8] = {q0.x, q0.y, q0.z, q0.w,
                                q1.x, q1.y, q1.z, q1.w};
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[k] = sr16(acc[i][2 * k], wd[k] & 0xFFFFu, bt[2 * k]) |
                 (sr16(acc[i][2 * k + 1], wd[k] >> 16, bt[2 * k + 1]) << 16);
        *reinterpret_cast<uint4*>(out + at) =
            make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        const uint16_t* w16 = reinterpret_cast<const uint16_t*>(w);
        uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gn + j < N)
            o16[at + j] =
                (uint16_t)sr16(acc[i][j], w16[at + j], bits[at + j]);
      }
    }
  }
}

template <typename TV, typename TB>
int launch(const void* w, const void* v, const void* b, const uint32_t* bits,
           void* out, int64_t items, int K, int N, int r, cudaStream_t st) {
  static devfit::ResidentBlocks resident;
  int fit = 0;
  const cudaError_t err =
      resident.get(merge_sr_kernel<TV, TB>, THREADS, SMEM, &fit);
  if (err != cudaSuccess) return (int)err;
  const int tiles_k = (int)lrk::ceil_div(K, TILE);
  const int tiles_n = (int)lrk::ceil_div(N, TILE);
  const int64_t total = items * tiles_k * tiles_n;
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  const bool vec_v = aligned(v) && r % (16 / (int)sizeof(TV)) == 0;
  const bool vec_b = aligned(b) && r % (16 / (int)sizeof(TB)) == 0;
  const bool vec_n = aligned(w) && aligned(bits) && aligned(out) &&
                     N % 8 == 0;
  const int64_t grid = std::min<int64_t>(total, fit);
  merge_sr_kernel<TV, TB><<<(unsigned)grid, THREADS, SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const TV*>(v),
      static_cast<const TB*>(b), bits, static_cast<__nv_bfloat16*>(out), K,
      N, r, tiles_k, tiles_n, total, vec_v, vec_b, vec_n);
  return (int)cudaGetLastError();
}

}  // namespace msr
}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, one per operand (W and the
// output share tw).  w, v, b hold `batch` contiguous (K, N), (K, r),
// (N, r) items; out may equal w.  The plain merge of an fp32 W, or of a
// bf16 W with operands the tensor-core route does not take.  Returns
// cudaGetLastError() (0 = queued).
extern "C" int lowrank_merge_launch(int tw, int tv, int tb, const void* w,
                                    const void* v, const void* b, void* out,
                                    long long batch, int K, int N, int r,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tw == 0)
    return pick_v<float>(tv, tb, w, v, b, out, batch, K, N, r, st);
  if (tw == 1)
    return pick_v<__nv_bfloat16>(tv, tb, w, v, b, out, batch, K, N, r, st);
  return (int)cudaErrorInvalidValue;
}

// The stochastically rounded merge: bf16 w and out, tv and tb 0 (fp32)
// or 1 (bf16).  w, v, b, bits and out hold `batch` contiguous (K, N),
// (K, r), (N, r), (K, N) and (K, N) items; bits in [0, 2^16); out may
// equal w.  Returns cudaGetLastError() (0 = queued).
extern "C" int lowrank_merge_sr_launch(int tv, int tb, const void* w,
                                       const void* v, const void* b,
                                       const uint32_t* bits, void* out,
                                       long long batch, int K, int N, int r,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tv == 0 && tb == 0)
    return msr::launch<float, float>(w, v, b, bits, out, batch, K, N, r, st);
  if (tv == 0 && tb == 1)
    return msr::launch<float, __nv_bfloat16>(w, v, b, bits, out, batch, K, N,
                                             r, st);
  if (tv == 1 && tb == 0)
    return msr::launch<__nv_bfloat16, float>(w, v, b, bits, out, batch, K, N,
                                             r, st);
  if (tv == 1 && tb == 1)
    return msr::launch<__nv_bfloat16, __nv_bfloat16>(w, v, b, bits, out,
                                                     batch, K, N, r, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 w, v and out; tb = 0 (fp32 B, carried as a
// bf16 hi, lo pair) or 1 (bf16 B).  w, v, b and out hold `batch`
// contiguous (K, N), (K, r), (N, r) and (K, N) items, out may equal w;
// K, N and r are multiples of 8 and every pointer is 16-byte aligned.
// Returns 0 (queued), a CUDA error, or a negated CUresult of the
// tensor-map encoding.
extern "C" int lowrank_merge_tc_launch(int tb, const void* w, const void* v,
                                       const void* b, void* out,
                                       long long batch, int K, int N, int r,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || N % 8 || r % 8 || r < 8) return (int)cudaErrorInvalidValue;
  if (tb == 0) return mtc::launch<true>(w, v, b, out, batch, K, N, r, st);
  if (tb == 1) return mtc::launch<false>(w, v, b, out, batch, K, N, r, st);
  return (int)cudaErrorInvalidValue;
}

// The small-rank merge (an elementwise pass): tw, tv, tb 0 (fp32) or 1
// (bf16) for w and out, v, b, with an fp32 w or v; 1 <= r <= 16.  w, v,
// b and out hold `batch` contiguous (K, N), (K, r), (N, r) and (K, N)
// items; out may equal w.  Returns cudaGetLastError() (0 = queued).
extern "C" int lowrank_merge_ew_launch(int tw, int tv, int tb, const void* w,
                                       const void* v, const void* b,
                                       void* out, long long batch, int K,
                                       int N, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > mew::MAX_R || K < 1 || N < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  return mew::pick_wv(tw, tv, tb, w, v, b, out, batch, K, N, r, st);
}
