// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_backward.py::lowrank_backward:
//
//     dx = dy Wᵀ + (dy B) Vᵀ     (M, K) in dy's dtype
//     dB = dyᵀ p                 (N, r) fp32,  p = x V saved by the forward
//
// dy (M, N), W (K, N), V (K, r), B (N, r) and p (M, r) share one dtype,
// fp32 or bf16; every product accumulates in fp32.
//
// The TPU kernel makes one pass over dy tiles on a sequential grid: dx
// keeps a full-K fp32 (bm, K) accumulator in VMEM across the j sweep, and
// dB accumulates across the i sweep into one whole-array VMEM output.
// GPU blocks run in no order and nothing carries between them, so the
// port splits the work into four launches on the caller's stream:
//
//   1. q = dy B                   (M, r) fp32, one tile pass over N
//   2. dx = dy Wᵀ + q Vᵀ          K tiled; the rank-r term is a second
//                                 reduction segment of the same tile, so
//                                 dx is written once, in dy's dtype
//   3. dB_part[s] = dy[Ms]ᵀ p[Ms] split over M
//   4. dB = sum_s dB_part[s]      fixed order, no float atomics, so the
//                                 result does not depend on scheduling
//
// W is read transposed through a strided view (no transposed copy).
// What bounds it: at the training shapes (M = 16384) the operations, at
// the bf16 tensor-core peak; this first version runs fp32 FMAs on SIMT
// units (gemm_tile.cuh), far from that bound.  Tensor cores are later
// work.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/lowrank_backward.py) allocates outputs and scratch.

#include "gemm_tile.cuh"

namespace {

using lrk::Gemm;
using lrk::View;

template <typename T>
int launch_all(const void* dy_, const void* w_, const void* v_,
               const void* b_, const void* p_, void* dx_, float* db,
               float* q, float* db_part, int s_db, int M, int K, int N,
               int r, cudaStream_t st) {
  const T* dy = static_cast<const T*>(dy_);
  const T* w = static_cast<const T*>(w_);
  const T* v = static_cast<const T*>(v_);
  const T* b = static_cast<const T*>(b_);
  const T* p = static_cast<const T*>(p_);
  int err;

  // 1. q = dy B: A = dy (M, N), B = b (N, r)
  Gemm<T, T, float, float, float, float> gq{};
  gq.a = View<T>{dy, N, 1, 0};
  gq.b = View<T>{b, r, 1, 0};
  gq.out = q;
  gq.rows = M;
  gq.cols = r;
  gq.k = N;
  gq.splits = 1;
  if ((err = lrk::launch_gemm(gq, 1, st)) != 0) return err;

  // 2. dx = dy Wᵀ + q Vᵀ: Wᵀ(n, k) = w[k * N + n], Vᵀ(c, k) = v[k * r + c]
  Gemm<T, T, float, T, float, T> gx{};
  gx.a = View<T>{dy, N, 1, 0};
  gx.b = View<T>{w, 1, N, 0};
  gx.a2 = View<float>{q, r, 1, 0};
  gx.b2 = View<T>{v, 1, r, 0};
  gx.k2 = r;
  gx.out = static_cast<T*>(dx_);
  gx.rows = M;
  gx.cols = K;
  gx.k = N;
  gx.splits = 1;
  if ((err = lrk::launch_gemm(gx, 1, st)) != 0) return err;

  // 3. dB partials over M ranges: dyᵀ(n, m) = dy[m * N + n], p (M, r)
  Gemm<T, T, float, float, float, float> gb{};
  gb.a = View<T>{dy, 1, N, 0};
  gb.b = View<T>{p, r, 1, 0};
  gb.part = db_part;
  gb.rows = N;
  gb.cols = r;
  gb.k = M;
  gb.splits = s_db;
  if ((err = lrk::launch_gemm(gb, 1, st)) != 0) return err;

  // 4. fixed-order reduce of the partials
  const int64_t count = (int64_t)N * r;
  lrk::reduce_splits<<<(unsigned)lrk::ceil_div(count, 256), 256, 0, st>>>(
      db_part, db, count, s_db);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, w, v, b, p and dx).  db (N, r) is
// fp32; q (M, r) and db_part (s_db, N, r) are fp32 scratch.  Returns
// cudaGetLastError() of the launches (0 = all queued).
extern "C" int lowrank_backward_launch(int dtype, const void* dy,
                                       const void* w, const void* v,
                                       const void* b, const void* p,
                                       void* dx, float* db, float* q,
                                       float* db_part, int s_db, int M,
                                       int K, int N, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(dy, w, v, b, p, dx, db, q, db_part, s_db, M, K,
                             N, r, st);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(dy, w, v, b, p, dx, db, q, db_part,
                                     s_db, M, K, N, r, st);
  return (int)cudaErrorInvalidValue;
}
