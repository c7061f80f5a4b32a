// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_backward.py::lowrank_backward:
//
//     dx = dy Wᵀ + (dy B) Vᵀ     (M, K) in dy's dtype
//     dB = dyᵀ p                 (N, r) fp32,  p = x V saved by the forward
//
// dy (M, N), W (K, N), V (K, r), B (N, r) and p (M, r) share one dtype,
// fp32 or bf16; every product accumulates in fp32, and q = dy B keeps
// fp32 precision for the Vᵀ product, as the TPU kernel keeps it.
//
// The TPU kernel makes one pass over dy tiles on a sequential grid: dx
// keeps a full-K fp32 (bm, K) accumulator in VMEM across the j sweep, and
// dB accumulates across the i sweep into one whole-array VMEM output.
// GPU blocks run in no order and nothing carries between them, so the
// port splits the work into passes on the caller's stream:
//
//   1. q = dy B                   (M, r), one pass over N
//   2. dx = dy Wᵀ + q Vᵀ          K tiled; the rank-r term is a second
//                                 reduction segment of the same tile, so
//                                 dx is written once, in dy's dtype
//   3. dB_part[s] = dy[Ms]ᵀ p[Ms] split over M, so that the (N, r) output
//                                 fills the card
//   4. dB = sum_s dB_part[s]      fixed order, no float atomics, so the
//                                 result does not depend on scheduling
//
// Two routes, chosen by the Python wrapper.  What bounds the work at the
// training shapes (M = 16384) is the operations, at the bf16 tensor-core
// peak.
//
// * tensor cores (lowrank_backward_tc_launch; bf16, every row length a
//   multiple of 8 so TMA can address it): three launches of the
//   persistent wgmma mainloop of wgmma_gemm.cuh.  q is stored as q_hi =
//   bf16(q) and q_lo = bf16(q - q_hi), 16 significant bits, and pass 2
//   reduces over three segments, dy Wᵀ + q_hi Vᵀ + q_lo Vᵀ, a
//   programmatic dependent launch whose dy Wᵀ mainloop runs while the q
//   pass finishes.  Every operand is read in the layout the caller holds
//   it: Wᵀ and Vᵀ K-major, B and p N-major, dyᵀ M-major (wgmma's
//   transpose bits), so there are no transposed copies.  Each pass's plan
//   (lowrank_backward.py::tc_plan) sets its tile width, pairs the dx
//   pass's blocks to share Wᵀ's stages at the training shapes, and splits
//   the reduction where the output tiles cannot fill the card (dB's
//   (N, r) over M; q and dx at a few rows over N); the tile's last split
//   sums the fp32 partials in split order in the kernel, so passes 3 and
//   4 above are one launch.  The SIMT route this replaces ran 16-39x
//   slower than cuBLAS: fp32 FMAs on operands converted on their way
//   into shared memory, synchronous loads, no tensor cores.
// * SIMT (lowrank_backward_launch; fp32 and row lengths TMA cannot
//   address): the same four passes on gemm_tile.cuh's tiled fp32 FMAs,
//   reading Wᵀ and dyᵀ through strided views; q in fp32.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/lowrank_backward.py) allocates outputs and scratch.

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

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

// The SIMT route.  dtype: 0 = float32, 1 = bfloat16 (dy, w, v, b, p and dx).  db (N, r) is
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

// The tensor-core route: bf16, K, N and r multiples of 8 and 16-byte-
// aligned pointers (the wrapper checks).  q_hi, q_lo (M, r) are bf16
// scratch.  plan: tile width, splits of K and cluster size of the q, dx
// and dB passes (bn_q, s_q, cl_q, bn_x, ..., cl_b;
// lowrank_backward.py::tc_plan, every split non-empty); part_q, part_x,
// part_b: their fp32 partials (tiles x splits, 128 x bn), unused (may be
// null) where a pass does not split; counters: one zeroed int per tile
// of the three passes in that order, left zero.  The dx pass may start
// before the q pass ends (programmatic dependent launch).  Returns 0
// when every launch was queued, a CUDA error, or a negated CUresult of
// the tensor-map encoding.
extern "C" int lowrank_backward_tc_launch(const void* dy, const void* w,
                                          const void* v, const void* b,
                                          const void* p, void* dx,
                                          float* db, void* q_hi, void* q_lo,
                                          float* part_q, float* part_x,
                                          float* part_b, int* counters,
                                          const int* plan, int M, int K,
                                          int N, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < 3; ++i)
    if (plan[3 * i] != 64 && plan[3 * i] != 128 && plan[3 * i] != 256)
      return (int)cudaErrorInvalidValue;
  int* cx = counters + tc::ceil_div(M, tc::BM) * tc::ceil_div(r, plan[0]);
  int* cb = cx + tc::ceil_div(M, tc::BM) * tc::ceil_div(K, plan[3]);
  // 1. q = dy B: A = dy (M, N), B = b (N, r) N-major
  const tc::Segment sq{{dy, M, N, false}, {b, N, r, true}, N};
  const tc::Pass pq{plan[0], plan[1], part_q, counters, tc::MAX_SEGS,
                    plan[2]};
  int err = tc::gemm(&sq, 1, M, r, pq, tc::EPI_HILO, q_hi, q_lo, st);
  if (err != 0) return err;
  // 2. dx = dy Wᵀ + q_hi Vᵀ + q_lo Vᵀ: Wᵀ from W (K, N) and Vᵀ from
  // V (K, r), both K-major; only the rank segments wait for q
  const tc::Segment sx[3] = {{{dy, M, N, false}, {w, K, N, false}, N},
                             {{q_hi, M, r, false}, {v, K, r, false}, r},
                             {{q_lo, M, r, false}, {v, K, r, false}, r}};
  const tc::Pass px{plan[3], plan[4], part_x, cx, 1, plan[5]};
  err = tc::gemm(sx, 3, M, K, px, tc::EPI_BF16, dx, nullptr, st);
  if (err != 0) return err;
  // 3. dB = dyᵀ p, M split: dyᵀ M-major, p N-major; the fixed-order sum
  // of the splits in the kernel
  const tc::Segment sb{{dy, M, N, true}, {p, M, r, true}, M};
  const tc::Pass pb{plan[6], plan[7], part_b, cb, tc::MAX_SEGS, plan[8]};
  return tc::gemm(&sb, 1, N, r, pb, tc::EPI_F32, db, nullptr, st);
}
