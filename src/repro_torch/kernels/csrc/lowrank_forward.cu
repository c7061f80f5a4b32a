// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_forward.py::lowrank_forward:
//
//     y = x W + (x V) B^T        x (M,K), W (K,N), V (K,r), B (N,r)
//
// in two call forms: a shared B (prefill through LRPack, and the training
// forward) and one B per batch row (decode through BatchLRPack: flattened
// row m uses B[m / seq]).  x, W, V, B and y share one dtype, fp32 or
// bf16; every product accumulates in fp32 and p = x V is kept in fp32 for
// the B^T product, as the TPU kernel keeps it in VMEM.  The training form
// (the TPU kernel's return_p) also writes p in x's dtype, the only
// activation the backward keeps, from the same reduce that builds the
// fp32 p (step 2 below).
//
// The TPU kernel builds p only while its sequential grid sweeps the
// j == 0 column slab and reuses the VMEM scratch for later slabs.  GPU
// blocks run in no order, and recomputing p in every output tile would
// cost M*K*N*r/bn extra MACs (double the work at r = bn = 128).  So the
// port runs four launches on the caller's stream:
//
//   1. gemm_partial: p_part[s] = x[:, Ks] V[Ks, :]  (split K, fp32)
//   2. sum_splits:   p = sum_s p_part[s]            (fixed order; with
//                    return_p also p_out = p cast to x's dtype)
//   3. gemm_partial: y_part[s] = x[:, Ks] W[Ks, :]  (split K, fp32)
//   4. finish:       y = sum_s y_part[s] + p B[row]^T, cast to x's dtype
//
// Splitting K keeps enough blocks in flight when M is a decode batch of
// a few rows; the partial sums are reduced in a fixed order, so results
// do not depend on scheduling (no float atomics).
//
// What bounds it: at decode (M <= 16) the weights' bytes, so the bound
// is bytes / 3.35 TB/s; at prefill (M = 128) the MACs.  This first
// version is a plain shared-memory tiled SIMT GEMM with fp32 FMAs: no
// tensor cores, no TMA, no wgmma.  Those are later work.
//
// Plain C interface, loaded with ctypes; scratch and outputs are
// allocated by the Python wrapper (repro_torch/kernels/lowrank_forward.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// out[i] = sum_s part[s * count + i], s in order; cast[i] = out[i] in T
// when cast is given
template <typename T>
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, T* __restrict__ cast,
                           int64_t count, int S) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += part[(int64_t)j * count + i];
  out[i] = s;
  if (cast != nullptr) store(cast + i, s);
}

// y[m, n] = sum_s y_part[s, m, n] + sum_c p[m, c] b[m / seq][n, c]
// One warp per output; lanes stride over c so B rows are read coalesced.
// Consecutive warps take consecutive m of one n, so a B row is reused
// from L1 across the rows that share it.
template <typename T>
__global__ void finish(const float* __restrict__ y_part, int Sy,
                       const float* __restrict__ p, const T* __restrict__ b,
                       T* __restrict__ y, int M, int N, int r, int seq,
                       int64_t b_stride) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int64_t n_warps = (int64_t)gridDim.x * blockDim.x / 32;
  const int64_t total = (int64_t)M * N;
  for (int64_t o = warp; o < total; o += n_warps) {
    const int n = (int)(o / M);
    const int m = (int)(o % M);
    const T* brow = b + (int64_t)(m / seq) * b_stride + (int64_t)n * r;
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
               int64_t b_stride, cudaStream_t st) {
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
              st>>>(y_part, s_y, p, static_cast<const T*>(b),
                    static_cast<T*>(y), M, N, r, seq, b_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  seq: rows per adapter (M for a
// shared B); b_stride: elements between adapters (0 for a shared B).
// p_out (M, r) in x's dtype receives p, or is null (serving).
// p_part (s_p, M, r), p (M, r) and y_part (s_y, M, N) are fp32 scratch.
// Returns cudaGetLastError() of the launches (0 = all queued).
extern "C" int lowrank_forward_launch(int dtype, const void* x,
                                      const void* w, const void* v,
                                      const void* b, void* y, void* p_out,
                                      float* p_part,
                                      int s_p, float* p, float* y_part,
                                      int s_y, int M, int K, int N, int r,
                                      int seq, long long b_stride,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(x, w, v, b, y, p_out, p_part, s_p, p, y_part,
                             s_y, M, K, N, r, seq, (int64_t)b_stride, st);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(x, w, v, b, y, p_out, p_part, s_p, p,
                                     y_part, s_y, M, K, N, r, seq,
                                     (int64_t)b_stride, st);
  return (int)cudaErrorInvalidValue;
}
