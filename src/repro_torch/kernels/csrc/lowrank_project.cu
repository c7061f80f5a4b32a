// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_update.py::lowrank_project, GaLore's projection of
// a full gradient onto its basis:
//
//     G_B = Gᵀ V        G (K, N), V (K, r) -> (N, r) fp32
//
// over `batch` leading items (a group's (G, L) dims folded) in one call.
// G is the clipped fp32 gradient and V the basis stored in the compute
// dtype (bf16 on the card); the product accumulates in fp32.
//
// The TPU kernel walks K on a sequential grid axis into a (bn, r) VMEM
// accumulator.  What bounds the work on this card is bytes: G is read
// once in fp32 (77% of them at the llama-100m shapes), and 2 K N r
// operations at the bf16 tensor-core rate take a third of that time.  Two
// routes, chosen by the Python wrapper:
//
// * tensor cores (lowrank_project_tc_launch; bf16 V, fp32 or bf16 G, K,
//   N and r multiples of 8 so TMA can address every row): one block owns
//   128 output rows (N) x 128 rank columns of one item and reduces over
//   its K range in 64-deep stages, so each G element belongs to one tile
//   and is read from HBM once.  A producer warp keeps a 3-stage TMA ring
//   full: G's 64 x 128 tile (3-D maps, column, row, item, so a ragged K
//   or N zero-fills at its item) and V's 64 x 128 tile (B, N-major,
//   128-byte swizzle).  A = Gᵀ is M-major, which wgmma takes only in
//   16-bit types, so an fp32 G is carried as bf16 hi = bf16(G) and lo =
//   bf16(G - hi): each consumer warpgroup reads its 64 columns of the fp32
//   stage, splits them and writes hi and lo into a double-buffered
//   swizzled M-major tile, then issues two wgmma m64n128k16 per k16 step
//   against the same V stage; one stage's split overlaps the previous
//   stage's products.  V is exact in bf16, so the sum keeps 16 bits of
//   G.  A bf16 G is TMA-loaded straight into its M-major tile and runs
//   one segment.  Where an item's tiles cannot fill the card, K is split
//   into balanced ranges of whole stages, as many as keep the blocks
//   within one wave (a block's 210 KB of shared memory leaves room for
//   one per SM): every block writes its fp32 partial
//   tile, and the block that arrives last at the tile's counter (an
//   integer atomic, reset by that block) sums the partials in split
//   order; no float atomics, so two launches are bit-equal.
// * SIMT (lowrank_project_launch; fp32 V, rows TMA cannot address): one
//   block owns a 64 x 64 tile of one item's output (gemm_tile.cuh,
//   blockIdx.z = item and K range) on fp32 FMAs; Gᵀ is read through a
//   strided view, and K ranges are summed by a second pass, reduce_items,
//   in a fixed order.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/lowrank_update.py) allocates output and scratch.

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

namespace {

using lrk::Gemm;
using lrk::View;

// out[t, i] = sum_z part[t, z, i], z in order
__global__ void reduce_items(const float* __restrict__ part,
                             float* __restrict__ out, int64_t count, int S,
                             int64_t total) {
  const int64_t at = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= total) return;
  const int64_t t = at / count, i = at % count;
  const float* p = part + t * S * count + i;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += p[(int64_t)z * count];
  out[at] = s;
}

template <typename TG, typename TV>
int project(const void* g, const void* v, float* out, float* part,
            int splits, int64_t batch, int K, int N, int r,
            cudaStream_t st) {
  Gemm<TG, TV, float, float, float, float> m{};
  // Gᵀ(n, k) = g[k * N + n]
  m.a = View<TG>{static_cast<const TG*>(g), 1, N, (int64_t)K * N};
  m.b = View<TV>{static_cast<const TV*>(v), r, 1, (int64_t)K * r};
  m.rows = N;
  m.cols = r;
  m.k = K;
  m.splits = splits;
  if (splits == 1) {
    m.out = out;
    m.out_batch = (int64_t)N * r;
    return lrk::launch_gemm(m, batch, st);
  }
  m.part = part;
  int err = lrk::launch_gemm(m, batch, st);
  if (err != 0) return err;
  const int64_t count = (int64_t)N * r, total = batch * count;
  reduce_items<<<(unsigned)lrk::ceil_div(total, 256), 256, 0, st>>>(
      part, out, count, splits, total);
  return (int)cudaGetLastError();
}

template <typename TG>
int pick_v(int tv, const void* g, const void* v, float* out, float* part,
           int splits, int64_t batch, int K, int N, int r, cudaStream_t st) {
  if (tv == 0)
    return project<TG, float>(g, v, out, part, splits, batch, K, N, r, st);
  if (tv == 1)
    return project<TG, __nv_bfloat16>(g, v, out, part, splits, batch, K, N,
                                      r, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------

// (an unnamed namespace: prepare()'s static must not be one object across
// the libraries that are loaded together)
namespace {
namespace ptc {

constexpr int BM = 128;                    // output rows per block (N)
constexpr int BN = 128;                    // output columns per block (r)
constexpr int BK = tc::BK;                 // depth of a stage
constexpr int STAGES = 3;
constexpr int CONSUMERS = tc::CONSUMERS;   // two warpgroups
constexpr int THREADS = tc::THREADS;       // and one producer warp
constexpr uint32_t BOX = tc::BOX;          // a 64 x 64 bf16 box: 8 KB
constexpr uint32_t A16 = 2 * BOX;          // a bf16 A tile, two M-major boxes
constexpr uint32_t G32 = BK * BM * 4;      // an fp32 G tile, 512-byte rows
constexpr uint32_t V_BYTES = 2 * BOX;      // a V tile, two N-major boxes

struct Args {
  CUtensorMap g, v;        // 3-D (column, row, item)
  float* out;              // `items` (N, r) fp32 matrices
  float* part;             // splits > 1: (splits, tiles, BM, BN) fp32
  int* counters;           // splits > 1: one per tile; zero before and after
  int K, N, r, splits, tiles_n, tiles_r;
};

template <bool F32G>
__host__ __device__ constexpr uint32_t a_bytes() { return F32G ? G32 : A16; }

template <bool F32G>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)STAGES * (a_bytes<F32G>() + V_BYTES) +
         (F32G ? 4 * A16 : 0) + 2 * STAGES * 8;
}

template <bool F32G>
__global__ void __launch_bounds__(THREADS, 1)
    project_tc_kernel(const __grid_constant__ Args g) {
  constexpr uint32_t A_BYTES = a_bytes<F32G>();
  constexpr uint32_t STAGE = A_BYTES + V_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t hilo = base + STAGES * STAGE;  // hi[0], lo[0], hi[1], lo[1]
  const uint32_t full = hilo + (F32G ? 4 * A16 : 0);
  const uint32_t empty = full + 8 * STAGES;
  uint8_t* gen = smem_raw + (base - raw);       // generic pointer to base

  const int z = blockIdx.x % g.splits, tile = blockIdx.x / g.splits;
  const int r0 = (tile % g.tiles_r) * BN;
  const int n0 = (tile / g.tiles_r % g.tiles_n) * BM;
  const int item = tile / g.tiles_r / g.tiles_n;
  // range z: stages [z S / splits, (z + 1) S / splits) of the S in K
  const int64_t all = (g.K + BK - 1) / BK;
  const int kb = (int)(z * all / g.splits) * BK;
  const int ke = min(g.K, (int)((z + 1) * all / g.splits) * BK);
  const int nk = (ke - kb + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(full + 8 * s, 1);
      tc::mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role as a warp-uniform value: wgmma must not sit in a path the
  // compiler takes for divergent
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == CONSUMERS / 128) {
    // producer: one thread issues every load.  A box that would lie wholly
    // past N or r is not loaded: it feeds only output rows or columns that
    // are never stored.
    if (threadIdx.x != CONSUMERS) return;
    const bool g2 = n0 + 64 < g.N, v2 = r0 + 64 < g.r;
    const uint32_t bytes = (F32G ? G32 : (g2 ? A16 : BOX)) +
                           (v2 ? V_BYTES : BOX);
    for (int t = 0; t < nk; ++t) {
      const int st = t % STAGES, k0 = kb + t * BK;
      if (t >= STAGES)
        tc::mbar_wait(empty + 8 * st, ((t / STAGES) - 1) & 1);
      const uint32_t bar = full + 8 * st;
      const uint32_t sa = base + st * STAGE, sb = sa + A_BYTES;
      tc::mbar_expect_tx(bar, bytes);
      tc::tma_load3(sa, &g.g, bar, n0, k0, item);
      if (!F32G && g2) tc::tma_load3(sa + BOX, &g.g, bar, n0 + 64, k0, item);
      tc::tma_load3(sb, &g.v, bar, r0, k0, item);
      if (v2) tc::tma_load3(sb + BOX, &g.v, bar, r0 + 64, k0, item);
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64)
  const int wg = role, tw = threadIdx.x % 128;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  tc::fence_regs(d);
  for (int t = 0; t < nk; ++t) {
    const int st = t % STAGES;
    tc::mbar_wait(full + 8 * st, (t / STAGES) & 1);
    const uint32_t sa = base + st * STAGE, sb = sa + A_BYTES;
    uint32_t a_hi = sa + wg * BOX, a_lo = 0;
    if constexpr (F32G) {
      // this warpgroup's 64 columns of the fp32 stage, split into the hi
      // and lo tiles of buffer t % 2 (the products of stage t - 2, which
      // read that buffer, have retired)
      a_hi = hilo + (t & 1) * 2 * A16 + wg * BOX;
      a_lo = a_hi + A16;
      const float* g32 = reinterpret_cast<const float*>(gen + st * STAGE);
      uint8_t* hi = gen + (a_hi - base);
      uint8_t* lo = gen + (a_lo - base);
      float4 x[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tw + 128 * i, k = u >> 3, c = u & 7;
        const float4* src =
            reinterpret_cast<const float4*>(g32 + k * BM + 64 * wg + 8 * c);
        x[i][0] = src[0];
        x[i][1] = src[1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tw + 128 * i, k = u >> 3, c = u & 7;
        uint4 h, l;
        tc::split_hi_lo8(x[i][0], x[i][1], h, l);
        *reinterpret_cast<uint4*>(hi + tc::swz128(k, c)) = h;
        *reinterpret_cast<uint4*>(lo + tc::swz128(k, c)) = l;
      }
      tc::fence_proxy_async();
      tc::bar_sync(1 + wg, 128);
    }
    tc::wg_fence();
    tc::mma_stage<BN, 1, 1>(d, a_hi, sb);
    if constexpr (F32G) tc::mma_stage<BN, 1, 1>(d, a_lo, sb);
    tc::wg_commit();
    tc::wg_wait<1>();
    if (t > 0) tc::mbar_arrive(empty + 8 * ((t - 1) % STAGES));
  }
  tc::wg_wait<0>();
  tc::fence_regs(d);

  // accumulator element (row, column): row 16 * warp + lane / 4 (+ 8),
  // columns in pairs
  const int lane = tw % 32, warp = tw / 32;
  const int row = 64 * wg + 16 * warp + lane / 4;
  auto store = [&](const float (&acc)[BN / 2]) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = r0 + 8 * j + 2 * (lane % 4);
      if (c >= g.r) continue;     // r is even: c + 1 < r too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + row + 8 * h;
        if (n < g.N)
          *reinterpret_cast<float2*>(g.out + ((size_t)item * g.N + n) * g.r +
                                     c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  };
  if (g.splits == 1) {
    store(d);
    return;
  }

  // split K: every block writes its partial tile and arrives; the last to
  // arrive sums the partials in split order, its own read back too (the
  // accumulator is free before the sum is built)
  const size_t tiles = gridDim.x / g.splits;
  auto part_at = [&](int zz, int j, int h) {
    return g.part + ((size_t)zz * tiles + tile) * BM * BN +
           (size_t)(row + 8 * h) * BN + 8 * j + 2 * (lane % 4);
  };
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part_at(z, j, h)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  __threadfence();
  tc::bar_sync(3, CONSUMERS);
  if (threadIdx.x == 0)
    s_last = atomicAdd(&g.counters[tile], 1) == g.splits - 1;
  tc::bar_sync(3, CONSUMERS);
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) g.counters[tile] = 0;
  float sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  for (int zz = 0; zz < g.splits; ++zz) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 p =
            __ldcg(reinterpret_cast<const float2*>(part_at(zz, j, h)));
        sum[4 * j + 2 * h] += p.x;
        sum[4 * j + 2 * h + 1] += p.y;
      }
  }
  store(sum);
}

template <bool F32G>
int prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(project_tc_kernel<F32G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<F32G>());
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

template <bool F32G>
int launch(const void* g_, const void* v, float* out, float* part,
           int* counters, int splits, int64_t items, int K, int N, int r,
           cudaStream_t st) {
  int err = prepare<F32G>();
  if (err != 0) return err;
  Args a;
  memset(&a, 0, sizeof(a));
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  err = F32G ? tc::make_map3(&a.g, g_, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                             items, K, N, BM, BK,
                             CU_TENSOR_MAP_SWIZZLE_NONE)
             : tc::make_map3(&a.g, g_, bf, 2, items, K, N, 64, BK, sw);
  if (err == 0) err = tc::make_map3(&a.v, v, bf, 2, items, K, r, 64, BK, sw);
  if (err != 0) return err;
  a.out = out;
  a.part = part;
  a.counters = counters;
  a.K = K;
  a.N = N;
  a.r = r;
  a.splits = splits;
  a.tiles_n = (int)tc::ceil_div(N, BM);
  a.tiles_r = (int)tc::ceil_div(r, BN);
  const int64_t blocks = items * a.tiles_n * a.tiles_r * splits;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  project_tc_kernel<F32G>
      <<<(unsigned)blocks, THREADS, smem_bytes<F32G>(), st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ptc
}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for g and v.  g and v hold
// `batch` contiguous (K, N) and (K, r) items; out holds `batch` (N, r)
// fp32 items.  With splits > 1, part is fp32 scratch of batch * splits
// (N, r) items (else unused).  Returns cudaGetLastError() (0 = queued).
extern "C" int lowrank_project_launch(int tg, int tv, const void* g,
                                      const void* v, float* out, float* part,
                                      int splits, long long batch, int K,
                                      int N, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (tg == 0)
    return pick_v<float>(tv, g, v, out, part, splits, batch, K, N, r, st);
  if (tg == 1)
    return pick_v<__nv_bfloat16>(tv, g, v, out, part, splits, batch, K, N, r,
                                 st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 v; tg = 0 (fp32 G, carried as a bf16 hi, lo
// pair) or 1 (bf16 G).  g and v hold `batch` contiguous (K, N) and (K, r)
// items, out `batch` (N, r) fp32 items; K, N and r are multiples of 8 and
// every pointer is 16-byte aligned.  K is cut into `splits` ranges of
// whole 64-deep stages, balanced to within one stage (none empty: splits
// is at most ceil(K / 64)); with splits > 1, part is fp32
// scratch of splits x tiles x 128 x 128 (tiles = batch x ceil(N / 128) x
// ceil(r / 128)) and counters holds `tiles` zeroed ints, zero again once
// the launch has run.  Returns 0 (queued), a CUDA error, or a negated
// CUresult of the tensor-map encoding.
extern "C" int lowrank_project_tc_launch(int tg, const void* g,
                                         const void* v, float* out,
                                         float* part, int* counters,
                                         int splits, long long batch, int K,
                                         int N, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || N % 8 || r % 8 || K < 1 || N < 1 || r < 1 || splits < 1 ||
      splits > tc::ceil_div(K, ptc::BK) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (tg == 0)
    return ptc::launch<true>(g, v, out, part, counters, splits, batch, K, N,
                             r, st);
  if (tg == 1)
    return ptc::launch<false>(g, v, out, part, counters, splits, batch, K,
                              N, r, st);
  return (int)cudaErrorInvalidValue;
}
