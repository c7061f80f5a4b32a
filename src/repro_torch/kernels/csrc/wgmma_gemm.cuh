// A tensor-core GEMM mainloop for Hopper (sm_90a), shared by the
// bf16 routes of lowrank_forward.cu and lowrank_backward.cu.  Its
// device pieces (mbarriers, TMA loads and stores over 2-D and 3-D maps,
// descriptors, the in-kernel fp32 -> bf16 (hi, lo) split, the wgmma
// instantiations at n = 8, 16, 64 and 128) also build the per-row-B
// decode kernel of lowrank_forward.cu and the item-batched kernels of
// lowrank_merge.cu and lowrank_project.cu.
//
// One block computes a 128 x BN output tile (BN = 128, or 64 where the
// grid would otherwise hold fewer blocks than the card has SMs) with 288
// threads: two consumer warpgroups, each running
// wgmma.mma_async.m64nBNk16 (bf16 in, fp32 accumulators in registers) on
// 64 of the rows, and one producer warp whose first thread keeps TMA
// loads (cp.async.bulk.tensor.2d) in flight.  The operands stream through
// a ring of STAGES stages of 64-deep K tiles in dynamic shared memory,
// written by TMA with the 128-byte swizzle; each stage has a "full"
// mbarrier (the producer's expect_tx, completed by the TMA bytes) and an
// "empty" one (one arrival per consumer thread once the wgmma that read
// the stage has retired).  The consumers keep one stage of wgmma in
// flight (wait_group 1) while the next is issued.
//
// The reduction runs over up to three segments in turn into the same
// fp32 accumulator, each with its own operands, depth and layouts:
//
//   acc = A0 B0 + A1 B1 + A2 B2
//
// which is how the rank-r term joins the dense product without a second
// pass over the output (y = x W + p_hi Bᵀ + p_lo Bᵀ).  Every operand is
// a row-major bf16 tensor the caller already has: A is K-major (stored
// (M, K)) or M-major (stored (K, M)), B is K-major (stored (N, K)) or
// N-major (stored (K, N)); wgmma's transpose bits take either, so no
// transposed copy is made.  TMA zero-fills what lies outside a tensor,
// so a ragged M, N, K or r needs no padding; the epilogue masks its
// stores.  Segment 0 may be split over its depth (blockIdx.z), for an
// output too small to fill the card on its own; the later segments then
// run in split 0 only.
//
// Epilogues, straight from the accumulator registers (row 16 * warp +
// lane / 4, and 8 below it; columns in pairs):
//   EPI_BF16: the tile cast to bf16 (y, dx);
//   EPI_HILO: fp32 to a (hi, lo) pair of bf16, hi = bf16(v) and
//             lo = bf16(v - hi), 16 significant bits in all (p, q: the
//             fp32 rank-r activations, carried into a later bf16 wgmma
//             segment as hi and lo);
//   EPI_F32:  fp32 split-K partials at out0 + z * M * N, for a
//             fixed-order reduce (dB): no float atomics, so results do
//             not depend on scheduling.
//
// Tensor maps are encoded on the host for each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// -lcuda), and passed by value in a __grid_constant__ argument.  TMA
// needs 16-byte-aligned base pointers and row strides: in bf16 every
// row length a multiple of 8.  The Python wrappers route anything else
// to the SIMT kernels.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Everything here has internal linkage (an unnamed namespace): the
// header is compiled into several shared libraries, and a function-local
// static of an inline or template function with external linkage would
// be one object across all of them (GNU unique symbols), so one
// library's "shared memory limit already set" would skip another's.
namespace tc {
namespace {

constexpr int BM = 128;              // output rows per block
constexpr int BK = 64;               // depth of a stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int MAX_SEGS = 3;
constexpr int SMS = 132;             // H100 SXM streaming multiprocessors
constexpr uint32_t BOX = 64 * BK * 2;  // bytes of a 64 x 64 bf16 box

enum { EPI_BF16 = 0, EPI_HILO = 1, EPI_F32 = 2 };

struct Args {
  CUtensorMap a[MAX_SEGS];
  CUtensorMap b[MAX_SEGS];
  int k[MAX_SEGS];      // reduction depth of each segment
  int a_mn[MAX_SEGS];   // 1: A stored (K, M), else (M, K)
  int b_mn[MAX_SEGS];   // 1: B stored (K, N), else (N, K)
  int nseg;
  int M, N;             // output rows and columns
  int k_chunk;          // segment 0's depth per split, a multiple of BK
  void* out0;
  void* out1;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box at (c0 = column, c1 = row) of `map` into shared memory at `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// box at (c0 = column, c1 = row, c2 = item) of a 3-D `map` (make_map3)
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// shared memory at `src` to the box at (c0, c1, c2) of a 3-D `map`; the
// parts of the box outside the tensor are not written
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the issuing thread's bulk stores since the last commit, as one group
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until the issuing thread's committed bulk stores have read their
// shared memory (it may then be reused, or the block exit)
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's generic stores to shared memory made visible to the async
// proxy (wgmma operands, TMA stores); a barrier must follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// element (row, 16-byte chunk) of a 128-byte-swizzled tile of 128-byte rows
// (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte-aligned
// shared memory): the chunk index XOR the row's place in its 8-row group
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return (uint32_t)row * 128u + ((uint32_t)(chunk ^ (row & 7)) << 4);
}

// fp32 x[0..7] as bf16 hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest, eight values to a 16-byte vector each
__device__ __forceinline__ void split_hi_lo8(const float4& a, const float4& b,
                                             uint4& hi, uint4& lo) {
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&hi);
  __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h[i]);
    l[i] = __floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x n, fp32) += A (64 x 16) B (16 x n); TA / TB = 1: A M-major /
// B N-major in shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the skinny widths of the decode forward's swap-AB tile (n = the 8 or
// 16 decode rows)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 8)
    wgmma_n8<TA, TB>(d, da, db);
  else if constexpr (BN == 16)
    wgmma_n16<TA, TB>(d, da, db);
  else if constexpr (BN == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

// One stage: the warpgroup's 64 x 64 A box at `a` and the stage's
// 64 x BN B tile at `b`, four k16 steps.  A K-major box holds row m at
// m * 128 bytes (8-row groups 1024 bytes apart); an M- or N-major box
// holds K row k at k * 128 bytes (64 values of M or N), 8-row groups
// 1024 bytes apart and the next 64 values of N one box (8 KB) on.  The
// layouts are template arguments: a wgmma behind a branch is serialized.
template <int BN, int TA, int TB>
__device__ __forceinline__ void mma_stage(float (&d)[BN / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int k = 0; k < BK / 16; ++k) {
    const uint64_t da =
        TA ? desc(a + k * 2048, BOX, 1024) : desc(a + k * 32, 16, 1024);
    const uint64_t db =
        TB ? desc(b + k * 2048, BOX, 1024) : desc(b + k * 32, 16, 1024);
    mma<BN, TA, TB>(d, da, db);
  }
}

// [k_begin, k_end) of segment s in split z
__device__ __forceinline__ void seg_range(const Args& g, int s, int z,
                                          int& k_begin, int& k_end) {
  if (s == 0) {
    k_begin = z * g.k_chunk;
    k_end = min(g.k[0], k_begin + g.k_chunk);
  } else {
    k_begin = 0;
    k_end = z == 0 ? g.k[s] : 0;
  }
}

// The consumers' loop over one segment's K tiles [kb, ke); t counts the
// stages consumed so far, across segments.  Each stage is handed back
// once the wgmma of the next one has been issued and its own retired.
template <int BN, int TA, int TB>
__device__ __forceinline__ void consume(float (&d)[BN / 2], int kb, int ke,
                                        int& t, uint32_t base,
                                        uint32_t full, uint32_t empty,
                                        int wg) {
  constexpr uint32_t STAGE = (BM + BN) * BK * 2;
  for (int k0 = kb; k0 < ke; k0 += BK, ++t) {
    const int st = t % STAGES;
    mbar_wait(full + 8 * st, (t / STAGES) & 1);
    const uint32_t sa = base + st * STAGE;
    wg_fence();
    mma_stage<BN, TA, TB>(d, sa + wg * BOX, sa + BM * BK * 2);
    wg_commit();
    wg_wait<1>();
    if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
  }
}

template <int BN>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)STAGES * (BM + BN) * BK * 2 + 2 * STAGES * 8;
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ Args g) {
  constexpr uint32_t A_BYTES = BM * BK * 2;
  constexpr uint32_t STAGE = (BM + BN) * BK * 2;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE;   // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role as a warp-uniform value: wgmma must not sit in a path the
  // compiler takes for divergent
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == CONSUMERS / 128) {
    // producer: one thread issues every load of the run
    if (threadIdx.x != CONSUMERS) return;
    int t = 0;
    for (int s = 0; s < g.nseg; ++s) {
      int kb, ke;
      seg_range(g, s, z, kb, ke);
      const CUtensorMap* ma = &g.a[s];
      const CUtensorMap* mb = &g.b[s];
      for (int k0 = kb; k0 < ke; k0 += BK, ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + 8 * st, ((t / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t sa = base + st * STAGE, sb = sa + A_BYTES;
        mbar_expect_tx(bar, STAGE);
        if (g.a_mn[s]) {
          tma_load(sa, ma, bar, m0, k0);
          tma_load(sa + BOX, ma, bar, m0 + 64, k0);
        } else {
          tma_load(sa, ma, bar, k0, m0);
        }
        if (g.b_mn[s]) {
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load(sb + h * BOX, mb, bar, n0 + 64 * h, k0);
        } else {
          tma_load(sb, mb, bar, k0, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = role;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  fence_regs(d);
  int t = 0;
  for (int s = 0; s < g.nseg; ++s) {
    int kb, ke;
    seg_range(g, s, z, kb, ke);
    if (g.a_mn[s]) {
      if (g.b_mn[s])
        consume<BN, 1, 1>(d, kb, ke, t, base, full, empty, wg);
      else
        consume<BN, 1, 0>(d, kb, ke, t, base, full, empty, wg);
    } else {
      if (g.b_mn[s])
        consume<BN, 0, 1>(d, kb, ke, t, base, full, empty, wg);
      else
        consume<BN, 0, 0>(d, kb, ke, t, base, full, empty, wg);
    }
  }
  wg_wait<0>();
  fence_regs(d);

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = m0 + 64 * wg + 16 * warp + lane / 4;
  const int64_t z_off = (int64_t)z * g.M * g.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= g.N) continue;   // N is even: col + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= g.M) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      const int64_t at = (int64_t)r * g.N + col;
      if constexpr (EPI == EPI_BF16) {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(g.out0) + at) =
            __floats2bfloat162_rn(v0, v1);
      } else if constexpr (EPI == EPI_HILO) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(g.out0) + at) = hi;
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(g.out1) + at) =
            __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(g.out0) + z_off +
                                   at) = make_float2(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A row-major bf16 tensor (rows, cols) as it is stored; mn marks the
// operand's M- or N-major use (A stored (K, M), B stored (K, N)).
struct Operand {
  const void* ptr;
  int64_t rows, cols;
  bool mn;
};

struct Segment {
  Operand a, b;
  int k;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// boxes of 64 columns x box_rows rows, 128-byte swizzle, zero fill
// outside the tensor.  Returns 0, or the driver's CUresult negated.
inline int make_map(CUtensorMap* map, const Operand& o, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)o.cols, (cuuint64_t)o.rows};
  const cuuint64_t strides[1] = {(cuuint64_t)o.cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(o.ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// `items` contiguous row-major (rows, cols) matrices of `esize`-byte
// elements as a 3-D map (column, row, item) with boxes of box_cols x
// box_rows x 1: a box that runs past an item's last row or column is
// zero-filled there (loads) or clipped (stores), never read from or
// written into the next item.  Returns 0, or the driver's CUresult negated.
inline int make_map3(CUtensorMap* map, const void* ptr,
                     CUtensorMapDataType type, int esize, int64_t items,
                     int64_t rows, int64_t cols, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * esize),
                                 (cuuint64_t)(rows * cols * esize)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the dynamic shared memory limit, set once per device and kernel
template <int BN, int EPI>
int prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(gemm_kernel<BN, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<BN>());
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

template <int BN, int EPI>
int launch_tile(const Args& g, int splits, cudaStream_t st) {
  int err = prepare<BN, EPI>();
  if (err != 0) return err;
  const dim3 grid((unsigned)ceil_div(g.N, BN), (unsigned)ceil_div(g.M, BM),
                  (unsigned)splits);
  gemm_kernel<BN, EPI><<<grid, THREADS, smem_bytes<BN>(), st>>>(g);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_epi(const Args& g, int bn, int splits, cudaStream_t st) {
  return bn == 128 ? launch_tile<128, EPI>(g, splits, st)
                   : launch_tile<64, EPI>(g, splits, st);
}

// out (M, N) = sum over the segments of A_s B_s, stored by epilogue `epi`;
// segment 0 split over `splits` depth ranges of ceil(k / splits) rounded
// up to BK (EPI_F32 only).  Returns 0, a CUDA error, or a negated
// CUresult of the tensor-map encoding.
inline int gemm(const Segment* segs, int nseg, int M, int N, int splits,
                int epi, void* out0, void* out1, cudaStream_t st) {
  if (nseg < 1 || nseg > MAX_SEGS || splits < 1 ||
      (splits > 1 && (nseg != 1 || epi != EPI_F32)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int bn =
      ceil_div(N, 128) * ceil_div(M, BM) * splits >= SMS ? 128 : 64;
  Args g;
  memset(&g, 0, sizeof(g));
  for (int s = 0; s < nseg; ++s) {
    const Segment& sg = segs[s];
    int err = make_map(&g.a[s], sg.a, sg.a.mn ? 64 : BM);
    if (err == 0) err = make_map(&g.b[s], sg.b, sg.b.mn ? 64 : bn);
    if (err != 0) return err;
    g.k[s] = sg.k;
    g.a_mn[s] = sg.a.mn;
    g.b_mn[s] = sg.b.mn;
  }
  g.nseg = nseg;
  g.M = M;
  g.N = N;
  g.k_chunk = (int)(ceil_div(ceil_div(segs[0].k, splits), BK) * BK);
  g.out0 = out0;
  g.out1 = out1;
  switch (epi) {
    case EPI_BF16: return launch_epi<EPI_BF16>(g, bn, splits, st);
    case EPI_HILO: return launch_epi<EPI_HILO>(g, bn, splits, st);
    case EPI_F32: return launch_epi<EPI_F32>(g, bn, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tc
