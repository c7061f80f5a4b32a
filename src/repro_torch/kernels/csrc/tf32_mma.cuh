// Device helpers shared by the port's 3xTF32 kernels (ssd_chunk.cu, the
// SSD forward; ssd_chunk_bwd.cu, its backward; lowrank_forward.cu, the
// fp32 small-rank forward): cp.async copies into shared memory, and
// mma.sync m16n8k8 TF32 with the 3xTF32 split (hi.hi plus the two cross
// products keep fp32 accuracy); and the bounds checks of the checked
// build.  Header-only, in an unnamed namespace as wgmma_gemm.cuh is (each
// source is a library of its own; lowrank_forward.cu includes this
// header, gemm_tile.cuh and wgmma_gemm.cuh, whose names live in the
// namespaces lrk and tc).
//
// The checked build (-DLRK_CHECKED, kernels/_build.py CHECKED): LRK_CHECK
// asserts an index in [0, limit) and, on failure, prints the function, the
// array, the index and the limit and traps; every cp.async destination and
// fragment read of this header is asserted inside the CTA's dynamic shared
// memory.  Without the define every check is empty, and the arithmetic is
// the same instructions either way.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A holds (row
// g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, column
// g), (t + 4, g); the sum D holds (row g, columns 2t, 2t + 1) and (g + 8,
// 2t, 2t + 1).  A product reads its k either in that order ("natural")
// or paired (below); both operands of one product use the same order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef LRK_CHECKED
#include <cstdio>
#endif

namespace {

// ---- bounds checks (the checked build) ----------------------------------

#ifdef LRK_CHECKED
__device__ __noinline__ void lrk_out_of_bounds(const char* fn,
                                               const char* array,
                                               long long index,
                                               long long limit) {
  printf("LRK_CHECKED: %s: %s index %lld outside [0, %lld) (block %u, "
         "thread %u)\n",
         fn, array, index, limit, blockIdx.x, threadIdx.x);
  __trap();
}
#define LRK_CHECK(array, index, limit)                                  \
  do {                                                                  \
    const long long lrk_i_ = (long long)(index);                        \
    const long long lrk_n_ = (long long)(limit);                        \
    if (lrk_i_ < 0 || lrk_i_ >= lrk_n_)                                 \
      lrk_out_of_bounds(__func__, array, lrk_i_, lrk_n_);               \
  } while (0)
// `bytes` at p lie inside the CTA's dynamic shared memory
__device__ __forceinline__ void lrk_check_smem(const char* fn, const void* p,
                                               int bytes) {
  extern __shared__ __align__(16) float lrk_dynamic_smem[];
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(lrk_dynamic_smem));
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned size;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(size));
  if (at < base || at + bytes > base + size)
    lrk_out_of_bounds(fn, "shared memory (bytes from its start)",
                      (long long)at - base + bytes - 1, size);
}
#define LRK_SMEM(p, bytes) lrk_check_smem(__func__, p, bytes)
#else
#define LRK_CHECK(array, index, limit) ((void)0)
#define LRK_SMEM(p, bytes) ((void)0)
#endif

// ---- asynchronous copies -------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const void* src, bool ok) {
  LRK_SMEM(dst, 16);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const void* src, bool ok) {
  LRK_SMEM(dst, 4);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// 16 bytes at dst from the first `bytes` (0, 4, 8, 12 or 16) at src, the
// rest zero; with bytes = 0, src is not read
__device__ __forceinline__ void cp16n(float* dst, const void* src,
                                      int bytes) {
  LRK_SMEM(dst, 16);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// wait until at most `pending` (0..3) of this thread's groups are in flight
__device__ __forceinline__ void cp_wait_at_most(int pending) {
  if (pending <= 0) cp_wait<0>();
  else if (pending == 1) cp_wait<1>();
  else if (pending == 2) cp_wait<2>();
  else cp_wait<3>();
}

// ---- 3xTF32 mma.sync -----------------------------------------------------

// hi = v rounded to tf32 (10 mantissa bits, to nearest, ties away: as
// cvt.rna.tf32.f32, in two integer operations); lo = v - hi, exact in
// fp32, whose low 13 bits the MMA ignores.  A value already exact in tf32
// (a bf16 input) passes as it is.
__device__ __forceinline__ uint32_t tf32(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16 x 8 A operand and an 8 x 8 B operand as tf32 (hi, lo) pairs; with
// kALo / kBLo false that operand is exact in tf32 (bf16 inputs) and its lo
// is not kept.
template <bool kALo, bool kBLo>
struct Frag {
  uint32_t ah[4], al[4], bh[2], bl[2];
  __device__ __forceinline__ void set_a(int k, float v) {
    if constexpr (kALo) split(v, ah[k], al[k]);
    else ah[k] = tf32(v);
  }
  __device__ __forceinline__ void set_b(int k, float v) {
    if constexpr (kBLo) split(v, bh[k], bl[k]);
    else bh[k] = tf32(v);
  }
  // d + c += a b: hi . hi into d, the cross terms into c (two chains)
  __device__ __forceinline__ void mma3(float (&d)[4], float (&c)[4]) const {
    if constexpr (kALo) mma(c, al, bh);
    if constexpr (kBLo) mma(c, ah, bl);
    mma(d, ah, bh);
  }
};

// Fragments with the k index paired: every product reads the 8 k of its
// step in the order (0, 2, 4, 6 | 1, 3, 5, 7), so that a lane's two k of
// a row (2t and 2t + 1; g = lane / 4, t = lane % 4) are adjacent and
// come in one 8-byte load.  A and B use the same order, so the sum is
// the same.
//
// A operand at rows (g, g+8), columns (2t, 2t+1) of a row-major matrix
// with row stride s
template <class F>
__device__ __forceinline__ void load_a(F& f, const float* m, int s, int g,
                                       int t) {
  LRK_SMEM(m + g * s + 2 * t, 8);
  LRK_SMEM(m + (g + 8) * s + 2 * t, 8);
  const float2 r0 = *reinterpret_cast<const float2*>(m + g * s + 2 * t);
  const float2 r1 =
      *reinterpret_cast<const float2*>(m + (g + 8) * s + 2 * t);
  f.set_a(0, r0.x);
  f.set_a(1, r1.x);
  f.set_a(2, r0.y);
  f.set_a(3, r1.y);
}
// B operand (k x n) read from a matrix stored k by row: rows 2t and
// 2t + 1, column g
template <class F>
__device__ __forceinline__ void load_b_krow(F& f, const float* m, int s,
                                            int g, int t) {
  LRK_SMEM(m + 2 * t * s + g, 4);
  LRK_SMEM(m + (2 * t + 1) * s + g, 4);
  f.set_b(0, m[2 * t * s + g]);
  f.set_b(1, m[(2 * t + 1) * s + g]);
}
// B operand read from a matrix stored n by row: row g, columns (2t, 2t+1)
template <class F>
__device__ __forceinline__ void load_b_nrow(F& f, const float* m, int s,
                                            int g, int t) {
  LRK_SMEM(m + g * s + 2 * t, 8);
  const float2 r = *reinterpret_cast<const float2*>(m + g * s + 2 * t);
  f.set_b(0, r.x);
  f.set_b(1, r.y);
}

// Fragments in the natural k order (a lane's k are t and t + 4), read with
// 4-byte loads: conflict-free where a row-wise operand has a row stride of
// 4 mod 32 and a k-by-row one 8 mod 32.
//
// A operand at rows (g, g+8), columns (t, t+4) of a row-major matrix
template <class F>
__device__ __forceinline__ void load_a_nat(F& f, const float* m, int s,
                                           int g, int t) {
  LRK_SMEM(m + g * s + t, 4);
  LRK_SMEM(m + (g + 8) * s + t + 4, 4);
  f.set_a(0, m[g * s + t]);
  f.set_a(1, m[(g + 8) * s + t]);
  f.set_a(2, m[g * s + t + 4]);
  f.set_a(3, m[(g + 8) * s + t + 4]);
}
// A operand read from its transpose (a matrix stored k by row): rows t,
// t + 4, columns g, g + 8
template <class F>
__device__ __forceinline__ void load_at_nat(F& f, const float* m, int s,
                                            int g, int t) {
  LRK_SMEM(m + t * s + g, 4);
  LRK_SMEM(m + (t + 4) * s + g + 8, 4);
  f.set_a(0, m[t * s + g]);
  f.set_a(1, m[t * s + g + 8]);
  f.set_a(2, m[(t + 4) * s + g]);
  f.set_a(3, m[(t + 4) * s + g + 8]);
}
// A operand read from its transpose in the paired order: rows 2t, 2t + 1
template <class F>
__device__ __forceinline__ void load_at(F& f, const float* m, int s, int g,
                                        int t) {
  LRK_SMEM(m + 2 * t * s + g, 4);
  LRK_SMEM(m + (2 * t + 1) * s + g + 8, 4);
  f.set_a(0, m[2 * t * s + g]);
  f.set_a(1, m[2 * t * s + g + 8]);
  f.set_a(2, m[(2 * t + 1) * s + g]);
  f.set_a(3, m[(2 * t + 1) * s + g + 8]);
}
// B operand from a matrix stored k by row: rows t, t + 4, column g
template <class F>
__device__ __forceinline__ void load_b_krow_nat(F& f, const float* m, int s,
                                                int g, int t) {
  LRK_SMEM(m + t * s + g, 4);
  LRK_SMEM(m + (t + 4) * s + g, 4);
  f.set_b(0, m[t * s + g]);
  f.set_b(1, m[(t + 4) * s + g]);
}
// B operand from a matrix stored n by row: row g, columns t, t + 4
template <class F>
__device__ __forceinline__ void load_b_nrow_nat(F& f, const float* m, int s,
                                                int g, int t) {
  LRK_SMEM(m + g * s + t, 4);
  LRK_SMEM(m + g * s + t + 4, 4);
  f.set_b(0, m[g * s + t]);
  f.set_b(1, m[g * s + t + 4]);
}

}  // namespace
