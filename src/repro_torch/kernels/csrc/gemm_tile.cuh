// A shared-memory tiled SIMT GEMM for the training kernels of the port
// (lowrank_backward.cu, lowrank_merge.cu).
//
// One block computes a 64 x 64 output tile with 256 threads, 4 x 4
// outputs per thread, fp32 FMAs from shared memory (no tensor cores, no
// TMA, no wgmma: a first version that is right; those are later work).
// Every operand is a strided view -- element (i, j) of a view lies at
// p[i * si + j * sj] -- so one kernel reads A, Aᵀ, B or Bᵀ without a
// transposed copy.  The loads walk the operand's contiguous axis across
// neighbouring threads.
//
// The kernel evaluates, for batch item t and K-split z of the launch,
//
//   out[t, z](m, n) = sum_{k in split z} A(m, k) B(k, n)
//                   + [z == 0] ( sum_c A2(m, c) B2(c, n) + C(m, n) )
//
// where the second product (rank-r, k2 = r) and the addend C are
// optional.  With one split the tile is cast and stored in the output
// dtype (the output may alias C: each element is read and written by the
// same thread); with several, fp32 partials go to `part` and a
// fixed-order reduce (sum_splits) follows, so results never depend on
// scheduling (no float atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lrk {

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

template <typename T>
struct View {
  const T* p;
  int64_t si, sj;   // element (i, j) at p[i * si + j * sj]
  int64_t batch;    // elements between batch items
};

template <typename TA, typename TB, typename TA2, typename TB2, typename TC,
          typename TO>
struct Gemm {
  View<TA> a;       // (rows, k)
  View<TB> b;       // (k, cols)
  View<TA2> a2;     // (rows, k2), read when k2 > 0
  View<TB2> b2;     // (k2, cols)
  int k2;
  const TC* c;      // addend, row-major (rows, cols), or nullptr
  int64_t c_batch;
  TO* out;          // row-major (rows, cols) output when part == nullptr
  int64_t out_batch;
  float* part;      // fp32 partials (batch * splits, rows, cols) or nullptr
  int rows, cols, k, k_chunk, splits;
};

struct Smem {
  float a[BK][BM + 4];
  float b[BK][BN];
};

// acc += A[row0 : row0 + BM, k_begin : k_end] B[k_begin : k_end, col0 : ..]
template <typename TA, typename TB>
__device__ __forceinline__ void mma_range(float (&acc)[TM][TN],
                                          const TA* a, int64_t asi,
                                          int64_t asj, const TB* b,
                                          int64_t bsi, int64_t bsj, int rows,
                                          int cols, int k_begin, int k_end,
                                          int row0, int col0, Smem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const bool a_k_fast = asj == 1;   // k is A's contiguous axis
  const bool b_n_fast = bsj == 1;   // n is B's contiguous axis
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      int m, kk;
      if (a_k_fast) {
        m = i / BK;
        kk = i % BK;
      } else {
        kk = i / BM;
        m = i % BM;
      }
      const int gm = row0 + m, gk = k0 + kk;
      s.a[kk][m] = (gm < rows && gk < k_end)
                       ? to_f(a[(int64_t)gm * asi + (int64_t)gk * asj])
                       : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      int n, kk;
      if (b_n_fast) {
        kk = i / BN;
        n = i % BN;
      } else {
        n = i / BK;
        kk = i % BK;
      }
      const int gk = k0 + kk, gn = col0 + n;
      s.b[kk][n] = (gk < k_end && gn < cols)
                       ? to_f(b[(int64_t)gk * bsi + (int64_t)gn * bsj])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = s.a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = s.b[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename TA, typename TB, typename TA2, typename TB2, typename TC,
          typename TO>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const Gemm<TA, TB, TA2, TB2, TC, TO> g) {
  __shared__ Smem s;
  const int z = blockIdx.z % g.splits;
  const int64_t t = blockIdx.z / g.splits;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = z * g.k_chunk;
  const int k_end = min(g.k, k_begin + g.k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  mma_range(acc, g.a.p + t * g.a.batch, g.a.si, g.a.sj, g.b.p + t * g.b.batch,
            g.b.si, g.b.sj, g.rows, g.cols, k_begin, k_end, row0, col0, s);
  if (z == 0 && g.k2 > 0)
    mma_range(acc, g.a2.p + t * g.a2.batch, g.a2.si, g.a2.sj,
              g.b2.p + t * g.b2.batch, g.b2.si, g.b2.sj, g.rows, g.cols, 0,
              g.k2, row0, col0, s);

  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gm >= g.rows || gn >= g.cols) continue;
      const int64_t at = (int64_t)gm * g.cols + gn;
      float v = acc[i][j];
      if (g.c != nullptr && z == 0) v += to_f(g.c[t * g.c_batch + at]);
      if (g.part != nullptr)
        g.part[(int64_t)blockIdx.z * g.rows * g.cols + at] = v;
      else
        store(g.out + t * g.out_batch + at, v);
    }
  }
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Launch over `batch` items and g.splits K ranges (g.k_chunk is set here).
template <typename TA, typename TB, typename TA2, typename TB2, typename TC,
          typename TO>
int launch_gemm(Gemm<TA, TB, TA2, TB2, TC, TO> g, int64_t batch,
                cudaStream_t st) {
  g.k_chunk = (int)(ceil_div(ceil_div(g.k, g.splits), BK) * BK);
  const dim3 grid((unsigned)ceil_div(g.cols, BN),
                  (unsigned)ceil_div(g.rows, BM),
                  (unsigned)(batch * g.splits));
  gemm_kernel<TA, TB, TA2, TB2, TC, TO><<<grid, THREADS, 0, st>>>(g);
  return (int)cudaGetLastError();
}

// out[i] = sum_s part[s * count + i], s in order
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int64_t count, int S) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += part[(int64_t)j * count + i];
  out[i] = s;
}

}  // namespace lrk
