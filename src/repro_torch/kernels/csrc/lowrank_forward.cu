// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_forward.py::lowrank_forward:
//
//     y = x W + (x V) B^T        x (M,K), W (K,N), V (K,r), B (N,r)
//
// in two call forms: a shared B (prefill through LRPack, and the training
// forward) and one B per batch row (decode through BatchLRPack: flattened
// row m uses B[m / seq]).  x, W, V, B and y share one dtype, fp32 or
// bf16; every product accumulates in fp32 and p = x V is kept to fp32
// precision for the B^T product, as the TPU kernel keeps it in VMEM.  The
// training form (the TPU kernel's return_p) also writes p in x's dtype,
// the only activation the backward keeps.
//
// The TPU kernel builds p only while its sequential grid sweeps the
// j == 0 column slab and reuses the VMEM scratch for later slabs.  GPU
// blocks run in no order, and recomputing p in every output tile would
// cost M*K*N*r/bn extra MACs (double the work at r = bn = 128), so p is
// a pass of its own.  Two routes, chosen by the Python wrapper:
//
// * tensor cores (lowrank_forward_tc_launch; shared B in bf16, every row
//   length a multiple of 8 so TMA can address it), two launches of the
//   wgmma mainloop of wgmma_gemm.cuh:
//
//     1. p pass: p = x V, stored as p_hi = bf16(p) (exactly the return_p
//        output) and p_lo = bf16(p - p_hi): 16 significant bits, so the
//        rank-r term keeps the fp32 p of the reference to about 2^-17;
//     2. y pass: y = x W + p_hi B^T + p_lo B^T, three reduction segments
//        into one fp32 accumulator, cast to bf16 once.
//
//   What bounds it: at the training shapes (M = 16384) the operations at
//   the bf16 tensor-core peak; at serving (M <= 128) the weights' bytes.
//   The SIMT route lost 34-56x to cuBLAS here: fp32 FMAs on operands
//   converted on their way into shared memory, synchronous loads, and a
//   per-output warp epilogue (finish) that wrote and re-read an fp32
//   (s, M, N) scratch.  This route keeps bf16 operands, streams them with
//   TMA into a swizzled ring that wgmma reads directly, and adds the
//   rank-r term inside the same tile, so y is written once and nothing
//   of size M x N is ever re-read.
//
// * SIMT (lowrank_forward_launch; fp32, a row length that TMA cannot
//   address, and the per-row-B decode form), shared-memory tiled fp32
//   FMAs:
//
//     1. gemm_partial: p_part[s] = x[:, Ks] V[Ks, :]  (split K, fp32)
//     2. sum_splits:   p = sum_s p_part[s]            (fixed order; with
//                      return_p also p_out = p cast to x's dtype)
//     shared B:
//     3. lrk::gemm_kernel: y = x W + p B^T, the rank-r term a second
//                      reduction segment of z == 0; split over K into
//                      fp32 partials when the output alone cannot fill
//                      the card, then a fixed-order sum_splits cast
//     per-row B (decode, bound by the weights' bytes at M <= 16):
//     3. gemm_partial: y_part[s] = x[:, Ks] W[Ks, :]  (split K, fp32)
//     4. finish:       y = sum_s y_part[s] + p B[row]^T, cast to x's dtype
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
              st>>>(y_part, s_y, p, static_cast<const T*>(b),
                    static_cast<T*>(y), M, N, r, seq, b_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// The SIMT route.  dtype: 0 = float32, 1 = bfloat16.  seq: rows per
// adapter (M for a shared B); b_stride: elements between adapters (0 for
// a shared B).  p_out (M, r) in x's dtype receives p, or is null
// (serving).  p_part (s_p, M, r), p (M, r) and y_part (s_y, M, N) are
// fp32 scratch; y_part is unused (may be null) for a shared B with
// s_y = 1.  Returns cudaGetLastError() of the launches (0 = all queued).
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

// The tensor-core route: shared B, bf16, K, N and r multiples of 8 and
// 16-byte-aligned pointers (the wrapper checks).  p_hi (M, r) receives
// bf16(p) -- the return_p output -- and p_lo (M, r) bf16(p - p_hi).
// Returns 0 when both launches were queued, a CUDA error, or a negated
// CUresult of the tensor-map encoding.
extern "C" int lowrank_forward_tc_launch(const void* x, const void* w,
                                         const void* v, const void* b,
                                         void* y, void* p_hi, void* p_lo,
                                         int M, int K, int N, int r,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // p = x V: A = x (M, K), B = V (K, r) N-major
  const tc::Segment sp{{x, M, K, false}, {v, K, r, true}, K};
  int err = tc::gemm(&sp, 1, M, r, 1, tc::EPI_HILO, p_hi, p_lo, st);
  if (err != 0) return err;
  // y = x W + p_hi B^T + p_lo B^T: W (K, N) N-major, B^T from B (N, r)
  // K-major
  const tc::Segment sy[3] = {{{x, M, K, false}, {w, K, N, true}, K},
                             {{p_hi, M, r, false}, {b, N, r, false}, r},
                             {{p_lo, M, r, false}, {b, N, r, false}, r}};
  return tc::gemm(sy, 3, M, N, 1, tc::EPI_BF16, y, nullptr, st);
}
