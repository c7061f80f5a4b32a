// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/lowrank_update.py::lowrank_project, GaLore's projection of
// a full gradient onto its basis:
//
//     G_B = Gᵀ V        G (K, N), V (K, r) -> (N, r) fp32
//
// over `batch` leading items (a group's (G, L) dims folded) in one call.
// G is the clipped fp32 gradient and V the basis stored in the compute
// dtype (bf16 on the card), so each operand has its own dtype, fp32 or
// bf16 (four instantiations); the product accumulates in fp32.
//
// The TPU kernel walks K on a sequential grid axis into a (bn, r) VMEM
// accumulator.  Here one block owns a 64 x 64 tile of one item's output
// (gemm_tile.cuh, blockIdx.z = item and K range); Gᵀ is read through a
// strided view (element (n, k) at g[k * N + n], neighbouring threads on
// neighbouring n), so no transposed copy is made.  When an item's tiles
// are too few to fill the card, K is split into ranges whose fp32
// partials a second pass sums in a fixed order, item by item: no float
// atomics, so the result does not depend on scheduling.
// What bounds it: operations (2 K N r, r = 128: 64 FLOP per fp32 byte of
// G, above the fp32 SIMT balance point of ~20); this first version runs
// fp32 FMAs on SIMT units.  Tensor cores are later work.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/lowrank_update.py) allocates output and scratch.

#include "gemm_tile.cuh"

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
