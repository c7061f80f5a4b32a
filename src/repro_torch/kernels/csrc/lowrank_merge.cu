// Hopper (sm_90a) ports of the TPU kernels
// repro/kernels/lowrank_update.py::lowrank_merge and ::lowrank_merge_sr,
// the outer step's weight merge (Algorithm 1, line 8):
//
//     W' = W + V Bᵀ        W (K, N), V (K, r), B (N, r); fp32 accumulate,
//                          W' in W's dtype
//     W' = sr_bf16(W + V Bᵀ, bits)
//                          the same sum stochastically rounded into a
//                          bf16 W with caller-supplied (K, N) noise in
//                          [0, 2^16): bf16 masters stay unbiased across
//                          outer cycles
//
// over `batch` leading items (a group's (G, L) dims folded) in one launch.
// The dtypes are mixed on the training path: W is the stored parameter
// (bf16 for the paper's models), V is stored in the compute dtype and B is
// the fp32 master.  Each operand therefore has its own dtype, fp32 or
// bf16 (eight instantiations); the rank-r product accumulates in fp32 and
// the sum is rounded once, into W's dtype.
//
// The TPU kernel tiles (bk, bn) output blocks with the whole rank
// resident in VMEM and vmaps over the leading dims.  Here one block owns
// a 64 x 64 tile of one batch item (gemm_tile.cuh, blockIdx.z = item);
// W is the addend of the tile's epilogue and may be the output itself
// (in-place merge: each element is read and written by the same thread).
// What bounds it: bytes (W read and written, r = 128 gives 2r FLOP per
// W element, below the card's ~295 FLOP/byte bf16 balance point).
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/lowrank_update.py) allocates the output.

#include "gemm_tile.cuh"

namespace {

using lrk::Gemm;
using lrk::View;

template <typename TW, typename TV, typename TB>
int merge(const void* w, const void* v, const void* b, void* out,
          const uint32_t* bits, int64_t batch, int K, int N, int r,
          cudaStream_t st) {
  Gemm<TV, TB, float, float, TW, TW> g{};
  g.a = View<TV>{static_cast<const TV*>(v), r, 1, (int64_t)K * r};
  // Bᵀ(c, n) = b[n * r + c]
  g.b = View<TB>{static_cast<const TB*>(b), 1, r, (int64_t)N * r};
  g.c = static_cast<const TW*>(w);
  g.c_batch = (int64_t)K * N;
  g.out = static_cast<TW*>(out);
  g.out_batch = (int64_t)K * N;
  g.bits = bits;
  g.bits_batch = (int64_t)K * N;
  g.rows = K;
  g.cols = N;
  g.k = r;
  g.splits = 1;
  return lrk::launch_gemm(g, batch, st);
}

template <typename TW, typename TV>
int pick_b(int tb, const void* w, const void* v, const void* b, void* out,
           const uint32_t* bits, int64_t batch, int K, int N, int r,
           cudaStream_t st) {
  if (tb == 0)
    return merge<TW, TV, float>(w, v, b, out, bits, batch, K, N, r, st);
  if (tb == 1)
    return merge<TW, TV, __nv_bfloat16>(w, v, b, out, bits, batch, K, N, r,
                                        st);
  return (int)cudaErrorInvalidValue;
}

template <typename TW>
int pick_v(int tv, int tb, const void* w, const void* v, const void* b,
           void* out, const uint32_t* bits, int64_t batch, int K, int N,
           int r, cudaStream_t st) {
  if (tv == 0)
    return pick_b<TW, float>(tb, w, v, b, out, bits, batch, K, N, r, st);
  if (tv == 1)
    return pick_b<TW, __nv_bfloat16>(tb, w, v, b, out, bits, batch, K, N, r,
                                     st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, one per operand (W and the
// output share tw).  w, v, b hold `batch` contiguous (K, N), (K, r),
// (N, r) items; out may equal w.  `bits` is nullptr for the plain merge;
// given, it holds `batch` contiguous (K, N) items of values in [0, 2^16)
// and the merge is the stochastically rounded one, which needs a bf16 W.
// Returns cudaGetLastError() (0 = queued).
extern "C" int lowrank_merge_launch(int tw, int tv, int tb, const void* w,
                                    const void* v, const void* b,
                                    const uint32_t* bits, void* out,
                                    long long batch, int K, int N, int r,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tw == 0 && bits == nullptr)
    return pick_v<float>(tv, tb, w, v, b, out, nullptr, batch, K, N, r, st);
  if (tw == 1)
    return pick_v<__nv_bfloat16>(tv, tb, w, v, b, out, bits, batch, K, N, r,
                                 st);
  return (int)cudaErrorInvalidValue;
}
