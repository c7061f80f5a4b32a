// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/subspace_adam.py::subspace_adam (_adam_kernel), the fused
// Adam-with-decay on the subspace variable B:
//
//     m' = β1 m + (1 − β1) g
//     v' = β2 v + (1 − β2) g²
//     b' = b − lr ((m'/bc1) / (√(v'/bc2) + eps) + wd b)
//
// b, m, v are fp32 in and out (masters and moments are never downcast);
// g is fp32 or bf16 and is cast up in registers.  One launch covers a
// whole group's (G, L, N, r) buffer, flattened.
//
// The TPU kernel takes lr, bc1 and bc2 as scalar-prefetch operands.  Here
// they are a (3,) fp32 device tensor that every thread reads, so a
// training step never waits on the host for them and the launch can be
// captured in a CUDA graph.  β1, β2, eps and wd are launch constants.
// The products and sums are rounded one by one (__fmul_rn/__fadd_rn, no
// FMA contraction), as the plain PyTorch version computes them.
//
// What bounds it: bytes (7 fp32 words moved per element for about 15
// operations).  A grid-stride loop with coalesced scalar loads; the
// outputs may alias the inputs (each element is read, then written, by
// one thread).
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/subspace_adam.py) allocates the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TG>
__global__ void adam_kernel(const float* b, const TG* g, const float* m,
                            const float* v, float* b_out, float* m_out,
                            float* v_out, const float* __restrict__ scalars,
                            int64_t n, float beta1, float one_m_beta1,
                            float beta2, float one_m_beta2, float eps,
                            float wd) {
  const float lr = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = to_f(g[i]);
    const float bi = b[i];
    const float m2 =
        __fadd_rn(__fmul_rn(beta1, m[i]), __fmul_rn(one_m_beta1, gi));
    const float v2 = __fadd_rn(__fmul_rn(beta2, v[i]),
                               __fmul_rn(__fmul_rn(one_m_beta2, gi), gi));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), eps);
    const float delta =
        __fadd_rn(__fdiv_rn(__fdiv_rn(m2, bc1), denom), __fmul_rn(wd, bi));
    b_out[i] = __fsub_rn(bi, __fmul_rn(lr, delta));
    m_out[i] = m2;
    v_out[i] = v2;
  }
}

}  // namespace

// g_dtype: 0 = float32, 1 = bfloat16.  scalars: (lr, bc1, bc2) fp32 on the
// device.  Returns cudaGetLastError() of the launch (0 = queued).
extern "C" int subspace_adam_launch(int g_dtype, const float* b,
                                    const void* g, const float* m,
                                    const float* v, float* b_out,
                                    float* m_out, float* v_out,
                                    const float* scalars, long long n,
                                    float beta1, float one_m_beta1,
                                    float beta2, float one_m_beta2,
                                    float eps, float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (g_dtype == 0)
    adam_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        b, static_cast<const float*>(g), m, v, b_out, m_out, v_out, scalars,
        n, beta1, one_m_beta1, beta2, one_m_beta2, eps, wd);
  else if (g_dtype == 1)
    adam_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        b, static_cast<const __nv_bfloat16*>(g), m, v, b_out, m_out, v_out,
        scalars, n, beta1, one_m_beta1, beta2, one_m_beta2, eps, wd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
