// A tensor-core GEMM mainloop for Hopper (sm_90a), shared by the
// bf16 routes of lowrank_forward.cu and lowrank_backward.cu.  Its
// device pieces (mbarriers, TMA loads and stores over 2-D and 3-D maps,
// descriptors, the in-kernel fp32 -> bf16 (hi, lo) split, the wgmma
// instantiations at n = 8, 16, 64, 128 and 256) also build the per-row-B
// decode kernel of lowrank_forward.cu and the item-batched kernels of
// lowrank_merge.cu and lowrank_project.cu.
//
// What bounds it: at the training shapes (M = 16384) the operations at
// the bf16 tensor-core peak, where short reductions (K = 640 and the
// rank segments: 14 stages a tile) make each tile's ring fill and
// epilogue a large share; at prefill (M <= 512) the weights' bytes,
// where a row or two of output tiles cannot fill the card.
//
// The work is cut into units: a unit is one 128 x BN output tile (BN =
// 64, 128 or 256) and one of its `splits` depth ranges of segment 0.
// The grid is persistent: at most the blocks the card holds at once (one
// an SM: a deep ring), each walking units blockIdx.x, + gridDim.x, ...,
// tiles taken in groups of GROUP rows of tiles so that a slab of B is
// read from L2 by the blocks beside it.  Where the operations bound a
// pass (the training shapes), two blocks of a cluster take the two tiles
// one above the other in a column: each loads half of every B stage and
// multicasts it into both rings, so B's reads from L2 halve; a stage is
// free again once both blocks' consumers have released it.
//
// A block has 288 threads: two consumer warpgroups, each running
// wgmma.mma_async.m64nBNk16 (bf16 in, fp32 accumulators in registers) on
// 64 of the tile's rows, and one producer warp whose first thread keeps
// TMA loads (cp.async.bulk.tensor.2d) in flight.  The operands stream
// through a ring of 64-deep K stages in dynamic shared memory (eight of
// 24 KB at BN = 64, six of 32 KB at 128, four of 48 KB at 256), written
// by TMA with the 128-byte swizzle; each stage has a "full" mbarrier
// (the producer's expect_tx, completed by the TMA bytes) and an "empty"
// one (one arrival per consumer warp of each block sharing the stage,
// once the wgmma that read it has retired).  The ring runs on across
// units, so the producer loads the next unit's stages while the
// consumers store the last one.  The consumers keep one stage of wgmma
// in flight (wait_group 1) while the next is issued.
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
// so a ragged M, N, K or r needs no padding; stores are clipped.
//
// Split K, for an output whose tiles cannot fill the card: segment 0's
// depth is cut into `splits` non-empty ranges of ceil(K / splits)
// rounded up to BK, and the later (rank) segments run whole in the last
// split only.  Every split writes its fp32 partial; the block that
// arrives last at the tile's integer counter sums all of them in split
// order and runs the pass's own epilogue on the sum, then zeroes the
// counter: no float atomics, so results do not depend on scheduling.
// Plans (BN, splits) come from the Python wrapper
// (lowrank_forward.py::gemm_plan), a pure function of the shapes.
//
// Epilogues, on the whole fp32 sum of a tile (row 64 wg + 16 warp +
// lane / 4, and 8 below it; columns in pairs):
//   EPI_BF16: the tile cast to bf16 (y, dx);
//   EPI_HILO: fp32 to a (hi, lo) pair of bf16, hi = bf16(v) and
//             lo = bf16(v - hi), 16 significant bits in all (p, q: the
//             fp32 rank-r activations, carried into a later bf16 wgmma
//             segment as hi and lo);
//   both staged through shared memory (the 128-byte-swizzled boxes TMA
//   stores, written without bank conflicts) and stored by TMA while the
//   block goes on to its next unit;
//   EPI_F32:  fp32 straight from the registers (dB).
//
// Two launches in a row may overlap: every launch lets a dependent one
// start (griddepcontrol.launch_dependents), and a launch whose later
// segments read the one before (the y pass reads p, the dx pass q) is a
// programmatic dependent launch whose producer waits
// (griddepcontrol.wait) only before its first such segment, so its x W
// or dy Wᵀ mainloop runs while p or q finish.
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

#include "device_fit.cuh"

// Everything here has internal linkage (an unnamed namespace): the
// header is compiled into several shared libraries, and a function-local
// static of an inline or template function with external linkage would
// be one object across all of them (GNU unique symbols), so one
// library's "shared memory limit already set" would skip another's.
namespace tc {
namespace {

constexpr int BM = 128;              // output rows per tile
constexpr int BK = 64;               // depth of a stage: one 128-byte row
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int MAX_SEGS = 3;
constexpr uint32_t BOX = 64 * BK * 2;  // bytes of a 64 x 64 bf16 box

enum { EPI_BF16 = 0, EPI_HILO = 1, EPI_F32 = 2 };

struct Args {
  CUtensorMap a[MAX_SEGS];
  CUtensorMap b[MAX_SEGS];
  CUtensorMap out[2];   // bf16 outputs (hi, lo), boxes of 64 x BM
  int k[MAX_SEGS];      // reduction depth of each segment
  int a_mn[MAX_SEGS];   // 1: A stored (K, M), else (M, K)
  int b_mn[MAX_SEGS];   // 1: B stored (K, N), else (N, K)
  int nseg;
  int M, N;             // output rows and columns
  int splits;           // depth ranges of segment 0 per tile
  int k_chunk;          // segment 0's depth per split, a multiple of BK
  int tiles_m, tiles_n;
  int units;            // tiles x splits
  int wait_seg;         // first segment that reads the previous launch
  float* part;          // (units, BM x BN) fp32 partials when splits > 1
  int* counters;        // one per tile when splits > 1, zero before/after
  float* out_f32;       // EPI_F32's (M, N) output
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

// the training tile: 64 x 256 a warpgroup (128 fp32 accumulators a thread)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
  else if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db);
  else
    wgmma_n256<TA, TB>(d, da, db);
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

// ---------------------------------------------------------------------------
// The mainloop kernel
// ---------------------------------------------------------------------------

constexpr int GROUP = 8;   // rows of tiles walked together: B reused from L2

// the ring's depth and the epilogue's staging, per tile width and
// epilogue (one block an SM): eight 24 KB stages at BN = 64, six 32 KB
// ones at BN = 128 and four 48 KB ones at BN = 256 (one fewer beside
// EPI_HILO's two bf16 output tiles); the staging holds at most 128 of
// the tile's columns, a wider tile is stored in two halves
template <int BN, int EPI>
__host__ __device__ constexpr int ring_stages() {
  return (BN == 64 ? 8 : BN == 128 ? 6 : 4) - (EPI == EPI_HILO && BN > 64);
}
template <int BN>
__host__ __device__ constexpr int staged_cols() {
  return BN < 128 ? BN : 128;
}
template <int BN, int EPI>
__host__ __device__ constexpr uint32_t epi_bytes() {
  return EPI == EPI_F32
             ? 0u
             : (EPI == EPI_HILO ? 2u : 1u) * BM * staged_cols<BN>() * 2u;
}
template <int BN, int EPI>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)ring_stages<BN, EPI>() * (BM + BN) * BK * 2 +
         epi_bytes<BN, EPI>() + 2 * ring_stages<BN, EPI>() * 8;
}

// shared memory at `src` to the box at (c0 = column, c1 = row) of a 2-D
// `map`; the parts of the box outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// wait until the issuing thread's committed bulk stores have completed
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// box at (c0, c1) of `map` into shared memory at `dst` of every block of
// the cluster in `mask`, each completing its own mbarrier at `bar` (the
// same offsets in every block)
__device__ __forceinline__ void tma_load_mc(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// one arrival on the mbarrier at `bar` of cluster block `cta`
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
      ::"r"(bar), "r"(cta)
      : "memory");
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the tile and split of block `rank` of a cluster of CL blocks in its
// cluster's work unit pu: units run split-fastest over clusters of CL
// tiles one above the other (sharing B), taken in groups of GROUP such
// rows, column by column
template <int BN, int CL>
__device__ __forceinline__ void unit_of(const Args& g, int pu, int rank,
                                        int& tile, int& z, int& m0,
                                        int& n0) {
  const int ptile = pu / g.splits;
  z = pu - ptile * g.splits;
  const int span = GROUP * g.tiles_n;
  const int group = ptile / span, in = ptile - group * span;
  const int rows = min(GROUP, g.tiles_m / CL - group * GROUP);
  m0 = (CL * (group * GROUP + in % rows) + rank) * BM;
  n0 = (in / rows) * BN;
  tile = ptile * CL + rank;
}

// a stage's release: one arrival on its empty mbarrier in every block of
// the cluster (a block's B arrives in every block's ring)
template <int CL>
__device__ __forceinline__ void release(uint32_t bar) {
  if constexpr (CL == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (int c = 0; c < CL; ++c) mbar_arrive_at(bar, c);
  }
}

// [k_begin, k_end) of segment s in split z: segment 0 over its depth
// ranges, the later (rank) segments whole in the last split only
__device__ __forceinline__ void seg_range(const Args& g, int s, int z,
                                          int& k_begin, int& k_end) {
  if (s == 0) {
    k_begin = z * g.k_chunk;
    k_end = min(g.k[0], k_begin + g.k_chunk);
  } else {
    k_begin = 0;
    k_end = z == g.splits - 1 ? g.k[s] : 0;
  }
}

// The consumers' loop over one segment's K tiles [kb, ke); t counts the
// stages consumed so far, across segments and units.  A stage is handed
// back once the wgmma of the next one has been issued and its own
// retired, by one arrival a warp (`leader`, lane 0: wait_group is
// warp-synchronous); `held`: stage t - 1 is not handed back yet.
template <int BN, int ST, int CL, int TA, int TB>
__device__ __forceinline__ void consume(float (&d)[BN / 2], int kb, int ke,
                                        int& t, bool& held, uint32_t base,
                                        uint32_t full, uint32_t empty,
                                        int wg, bool leader) {
  constexpr uint32_t STAGE = (BM + BN) * BK * 2;
  for (int k0 = kb; k0 < ke; k0 += BK, ++t) {
    const int st = t % ST;
    mbar_wait(full + 8 * st, (t / ST) & 1);
    const uint32_t sa = base + st * STAGE;
    wg_fence();
    mma_stage<BN, TA, TB>(d, sa + wg * BOX, sa + BM * BK * 2);
    wg_commit();
    wg_wait<1>();
    if (held && leader) release<CL>(empty + 8 * ((t + ST - 1) % ST));
    held = true;
  }
}

// The producer thread: every TMA load of the block's units, in the
// order the consumers take them, each stage once the consumers of every
// block sharing it have released its last use.
template <int BN, int ST, int CL>
__device__ __forceinline__ void produce(const Args& g, int rank, int units,
                                        uint32_t base, uint32_t full,
                                        uint32_t empty) {
  constexpr uint32_t A_BYTES = BM * BK * 2;
  constexpr uint32_t STAGE = (BM + BN) * BK * 2;
  int t = 0;
  bool waited = false;
  for (int pu = blockIdx.x / CL; pu < units; pu += gridDim.x / CL) {
    int tile, z, m0, n0;
    unit_of<BN, CL>(g, pu, rank, tile, z, m0, n0);
    for (int s = 0; s < g.nseg; ++s) {
      int kb, ke;
      seg_range(g, s, z, kb, ke);
      if (s >= g.wait_seg && kb < ke && !waited) {
        asm volatile("griddepcontrol.wait;" ::: "memory");
        waited = true;
      }
      const CUtensorMap* ma = &g.a[s];
      const CUtensorMap* mb = &g.b[s];
      for (int k0 = kb; k0 < ke; k0 += BK, ++t) {
        const int st = t % ST;
        if (t >= ST) mbar_wait(empty + 8 * st, ((t / ST) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t sa = base + st * STAGE, sb = sa + A_BYTES;
        mbar_expect_tx(bar, STAGE);
        if (g.a_mn[s]) {
          tma_load(sa, ma, bar, m0, k0);
          tma_load(sa + BOX, ma, bar, m0 + 64, k0);
        } else {
          tma_load(sa, ma, bar, k0, m0);
        }
        if constexpr (CL == 1) {
          if (g.b_mn[s]) {
#pragma unroll
            for (int h = 0; h < BN / 64; ++h)
              tma_load(sb + h * BOX, mb, bar, n0 + 64 * h, k0);
          } else {
            tma_load(sb, mb, bar, k0, n0);
          }
        } else {
          // this block's share of B (its boxes of 64 columns, or its
          // BN / CL rows), into every block of the cluster
          constexpr uint16_t ALL = (1u << CL) - 1;
          if (g.b_mn[s]) {
#pragma unroll
            for (int h = 0; h < BN / 64 / CL; ++h) {
              const int hb = rank * (BN / 64 / CL) + h;
              tma_load_mc(sb + hb * BOX, mb, bar, n0 + 64 * hb, k0, ALL);
            }
          } else {
            tma_load_mc(sb + rank * (BN / CL) * 128, mb, bar, k0,
                        n0 + rank * (BN / CL), ALL);
          }
        }
      }
    }
  }
}

// A persistent grid of clusters of CL blocks: each cluster walks work
// units pu = cluster, cluster + clusters, ...; a unit is CL 128 x BN
// output tiles, one above the other, and their split z.  With CL = 2 the
// two blocks share B: each loads half of every B stage and multicasts
// it into both rings, and a stage is free again once the consumers of
// both blocks have released it.  The producer's ring runs on across
// units, so the next unit's loads are in flight while the consumers
// finish the last one.  With one split a unit stores its tile; with
// several, each writes its fp32 partial and the last to arrive at the
// tile's counter sums the splits in split order and stores the tile.
// The kernel lets a dependent launch start at once
// (griddepcontrol.launch_dependents); the producer waits for the grid it
// depends on (griddepcontrol.wait) only before the first segment from
// g.wait_seg on, which reads that grid's output.
template <int BN, int EPI, int CL>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ Args g) {
  constexpr int ST = ring_stages<BN, EPI>();
  constexpr uint32_t STAGE = (BM + BN) * BK * 2;
  constexpr int COLS = staged_cols<BN>();       // columns staged at once
  constexpr uint32_t OUT_TILE = BM * COLS * 2;  // one bf16 staging tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t epi = base + ST * STAGE;        // the output's staging
  const uint32_t full = epi + epi_bytes<BN, EPI>();  // full[s] at + 8 s
  const uint32_t empty = full + 8 * ST;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CL * CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the other block's mbarriers are ready before any multicast or
  // remote arrival reaches them
  if constexpr (CL > 1) cluster_sync();
  const int rank = CL > 1 ? blockIdx.x % CL : 0;
  const int units = g.units / CL;

  // the role as a warp-uniform value: wgmma must not sit in a path the
  // compiler takes for divergent
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == CONSUMERS / 128) {
    // producer: one thread issues every load of the block
    if (threadIdx.x == CONSUMERS)
      produce<BN, ST, CL>(g, rank, units, base, full, empty);
    // a block leaves only with the other's (its loads into this block's
    // ring and its releases of this block's stages are done)
    if constexpr (CL > 1) {
      __syncwarp();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // d[4 j + 2 h + e] is row 64 wg + 16 warp + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e
  const int wg = role, ctid = threadIdx.x;
  const int lane = ctid % 32, warp = (ctid % 128) / 32;
  const int row0 = 64 * wg + 16 * warp + lane / 4;
  const bool leader = lane == 0;
  int t = 0;
  bool held = false;
  for (int pu = blockIdx.x / CL; pu < units; pu += gridDim.x / CL) {
    int tile, z, m0, n0;
    unit_of<BN, CL>(g, pu, rank, tile, z, m0, n0);
    const int u = tile * g.splits + z;   // the unit's partial
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    fence_regs(d);
    for (int s = 0; s < g.nseg; ++s) {
      int kb, ke;
      seg_range(g, s, z, kb, ke);
      if (g.a_mn[s]) {
        if (g.b_mn[s])
          consume<BN, ST, CL, 1, 1>(d, kb, ke, t, held, base, full, empty, wg,
                                  leader);
        else
          consume<BN, ST, CL, 1, 0>(d, kb, ke, t, held, base, full, empty, wg,
                                  leader);
      } else {
        if (g.b_mn[s])
          consume<BN, ST, CL, 0, 1>(d, kb, ke, t, held, base, full, empty, wg,
                                  leader);
        else
          consume<BN, ST, CL, 0, 0>(d, kb, ke, t, held, base, full, empty, wg,
                                  leader);
      }
    }
    wg_wait<0>();
    fence_regs(d);
    if (held) {
      if (leader) release<CL>(empty + 8 * ((t + ST - 1) % ST));
      held = false;
    }

    if (g.splits > 1) {
      // every split writes its partial (thread-major float4s, coalesced);
      // the last to arrive sums them all in split order, its own read
      // back too, so the sum does not depend on which block was last
      float4* mine = reinterpret_cast<float4*>(g.part + (size_t)u * BM * BN);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        __stcg(mine + i * CONSUMERS + ctid,
               make_float4(d[4 * i], d[4 * i + 1], d[4 * i + 2],
                           d[4 * i + 3]));
      __threadfence();
      bar_sync(1, CONSUMERS);
      if (ctid == 0)
        s_last = atomicAdd(g.counters + tile, 1) == g.splits - 1;
      bar_sync(1, CONSUMERS);
      if (!s_last) continue;
      __threadfence();
      if (ctid == 0) g.counters[tile] = 0;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      for (int j = 0; j < g.splits; ++j) {
        const float4* pj = reinterpret_cast<const float4*>(
            g.part + (size_t)(u - z + j) * BM * BN);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float4 v = __ldcg(pj + i * CONSUMERS + ctid);
          d[4 * i] += v.x;
          d[4 * i + 1] += v.y;
          d[4 * i + 2] += v.z;
          d[4 * i + 3] += v.w;
        }
      }
    }

    if constexpr (EPI == EPI_F32) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= g.N) continue;   // N is even: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row0 + 8 * h;
          if (r < g.M)
            *reinterpret_cast<float2*>(g.out_f32 + (int64_t)r * g.N + col) =
                make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
    } else {
      // through shared memory (the 128-byte-swizzled boxes of 64 columns
      // that TMA stores, conflict-free) to one TMA store per box, COLS
      // columns at a time; the last stores must have read the staging
#pragma unroll
      for (int c0 = 0; c0 < BN; c0 += COLS) {
        if (ctid == 0) tma_store_wait_read();
        bar_sync(1, CONSUMERS);
#pragma unroll
        for (int j = c0 / 8; j < (c0 + COLS) / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h, jl = j - c0 / 8;
            const uint32_t off = (jl / 8) * (BM * 128) + row * 128 +
                                 (((jl % 8) ^ (row & 7)) << 4) +
                                 4 * (lane % 4);
            const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(smem_raw + (epi - raw) +
                                               off) = hi;
            if constexpr (EPI == EPI_HILO) {
              const float2 hf = __bfloat1622float2(hi);
              *reinterpret_cast<__nv_bfloat162*>(smem_raw + (epi - raw) +
                                                 OUT_TILE + off) =
                  __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
            }
          }
        fence_proxy_async();
        bar_sync(1, CONSUMERS);
        if (ctid == 0) {
#pragma unroll
          for (int h = 0; h < COLS / 64; ++h) {
            tma_store(&g.out[0], epi + h * (BM * 128), n0 + c0 + 64 * h, m0);
            if constexpr (EPI == EPI_HILO)
              tma_store(&g.out[1], epi + OUT_TILE + h * (BM * 128),
                        n0 + c0 + 64 * h, m0);
          }
          tma_store_commit();
        }
      }
    }
  }
  if (EPI != EPI_F32 && ctid == 0) tma_store_wait_all();
  if constexpr (CL > 1) {
    __syncwarp();
    cluster_sync();
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

// How one launch runs, as the Python wrapper planned it from the shapes
// (lowrank_forward.py::gemm_plan): the tile width, segment 0's depth
// ranges per tile, their scratch, and the first segment that reads the
// output of the launch before it (a programmatic dependent launch; nseg
// or more: an ordinary one).
struct Pass {
  int bn;          // 64, 128 or 256 output columns per tile
  int splits;      // non-empty depth ranges of segment 0 per tile
  float* part;     // (tiles x splits, BM x bn) fp32 when splits > 1
  int* counters;   // one zeroed int per tile when splits > 1; left zero
  int wait_seg;
  int cluster;     // 1, or 2 blocks sharing B (bn >= 128, EPI_BF16, an
                   // even number of tile rows)
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

// the clusters of CL blocks the current device holds at once, asked once
// per device and kernel (one block an SM: a cluster of 2 takes two SMs of
// one GPC)
template <int BN, int EPI, int CL>
cudaError_t resident_clusters(cudaLaunchConfig_t cfg, int* fit) {
  constexpr int kMaxDevices = 64;
  static int fits[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && fits[dev] > 0) {
    *fit = fits[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(gemm_kernel<BN, EPI, CL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(fit, gemm_kernel<BN, EPI, CL>, &cfg);
  if (err != cudaSuccess) return err;
  if (*fit < 1) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) fits[dev] = *fit;
  return cudaSuccess;
}

// a grid of at most the blocks (or clusters) the card holds at once; a
// dependent launch may start while the launch before it runs
template <int BN, int EPI, int CL>
int launch_tile(const Args& g, bool dependent, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<BN, EPI>();
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  int fit = 0;
  cudaError_t err;
  if constexpr (CL == 1) {
    static devfit::ResidentBlocks resident;
    err = resident.get(gemm_kernel<BN, EPI, CL>, THREADS, smem, &fit);
  } else {
    cfg.gridDim = dim3(CL);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = resident_clusters<BN, EPI, CL>(cfg, &fit);
  }
  if (err != cudaSuccess) return (int)err;
  const int clusters = g.units / CL;
  cfg.gridDim = dim3((unsigned)(CL * (clusters < fit ? clusters : fit)));
  cfg.attrs = CL > 1 ? attr : attr + 1;
  cfg.numAttrs = (CL > 1) + (dependent ? 1 : 0);
  err = cudaLaunchKernelEx(&cfg, gemm_kernel<BN, EPI, CL>, g);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int EPI>
int launch_epi(const Args& g, int bn, int cluster, bool dependent,
               cudaStream_t st) {
  if (cluster == 2) {
    if constexpr (EPI == EPI_BF16) {
      if (bn == 256) return launch_tile<256, EPI, 2>(g, dependent, st);
      if (bn == 128) return launch_tile<128, EPI, 2>(g, dependent, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  return bn == 256   ? launch_tile<256, EPI, 1>(g, dependent, st)
         : bn == 128 ? launch_tile<128, EPI, 1>(g, dependent, st)
                     : launch_tile<64, EPI, 1>(g, dependent, st);
}

// out (M, N) = sum over the segments of A_s B_s, stored by epilogue `epi`
// (EPI_BF16: out0 bf16; EPI_HILO: hi to out0, lo to out1; EPI_F32: out0
// fp32), run as `p` says: segment 0 split over p.splits depth ranges of
// ceil(k / splits) rounded up to BK, each non-empty.  Returns 0, a CUDA
// error, or a negated CUresult of the tensor-map encoding.
inline int gemm(const Segment* segs, int nseg, int M, int N, const Pass& p,
                int epi, void* out0, void* out1, cudaStream_t st) {
  if (nseg < 1 || nseg > MAX_SEGS ||
      (p.bn != 64 && p.bn != 128 && p.bn != 256) || p.splits < 1 ||
      epi < EPI_BF16 || epi > EPI_F32 ||
      (p.cluster != 1 &&
       (p.cluster != 2 || p.bn < 128 || ceil_div(M, BM) % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Args g;
  memset(&g, 0, sizeof(g));
  for (int s = 0; s < nseg; ++s) {
    const Segment& sg = segs[s];
    int err = make_map(&g.a[s], sg.a, sg.a.mn ? 64 : BM);
    if (err == 0)
      err = make_map(&g.b[s], sg.b, sg.b.mn ? 64 : p.bn / p.cluster);
    if (err != 0) return err;
    g.k[s] = sg.k;
    g.a_mn[s] = sg.a.mn;
    g.b_mn[s] = sg.b.mn;
  }
  const int64_t k0 = segs[0].k > 0 ? segs[0].k : 1;
  const int64_t chunk = ceil_div(ceil_div(k0, p.splits), BK) * BK;
  const int64_t tiles = ceil_div(M, BM) * ceil_div(N, p.bn);
  if (ceil_div(k0, chunk) != p.splits || tiles * p.splits > INT32_MAX ||
      (p.splits > 1 && (p.part == nullptr || p.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (epi != EPI_F32) {
    int err = make_map(&g.out[0], Operand{out0, M, N, false}, BM);
    if (err == 0 && epi == EPI_HILO)
      err = make_map(&g.out[1], Operand{out1, M, N, false}, BM);
    if (err != 0) return err;
  }
  g.nseg = nseg;
  g.M = M;
  g.N = N;
  g.splits = p.splits;
  g.k_chunk = (int)chunk;
  g.tiles_m = (int)ceil_div(M, BM);
  g.tiles_n = (int)ceil_div(N, p.bn);
  g.units = (int)(tiles * p.splits);
  g.wait_seg = p.wait_seg;
  g.part = p.part;
  g.counters = p.counters;
  g.out_f32 = static_cast<float*>(out0);
  const bool dependent = p.wait_seg < nseg;
  switch (epi) {
    case EPI_BF16:
      return launch_epi<EPI_BF16>(g, p.bn, p.cluster, dependent, st);
    case EPI_HILO:
      return launch_epi<EPI_HILO>(g, p.bn, p.cluster, dependent, st);
    default:
      return launch_epi<EPI_F32>(g, p.bn, p.cluster, dependent, st);
  }
}

}  // namespace
}  // namespace tc
