// Hopper (sm_90a) ports of the TPU kernels
// repro/kernels/subspace_adam.py::subspace_adam (_adam_kernel) and
// ::subspace_lion (_lion_kernel), the fused updates of the subspace
// variable B on fp32 moments:
//
//   Adam:  m' = β1 m + (1 − β1) g
//          v' = β2 v + (1 − β2) g²
//          b' = b − lr ((m'/bc1) / (√(v'/bc2) + eps) + wd b)
//   Lion:  b' = b − lr (sign(β1 m + (1 − β1) g) + wd b)
//          m' = β2 m + (1 − β2) g
//
// m and v are fp32 in and out (moments are never downcast); b is the
// fp32 master or a bf16 one (bf16 masters on fp32 moments: the caller
// stochastically rounds the fp32 b' afterwards), g is fp32 or bf16; both
// are cast up in registers, and b' is fp32.  One launch covers a whole
// group's (G, L, N, r) buffer, flattened.
//
// The TPU kernels take lr, bc1 and bc2 as scalar-prefetch operands.
// Here they are a small fp32 device tensor that every thread reads
// ((lr, bc1, bc2) for Adam, (lr) for Lion), so a training step never
// waits on the host for them and the launch can be captured in a CUDA
// graph.  β1, β2, eps and wd are launch constants.  The products and
// sums are rounded one by one (__fmul_rn/__fadd_rn, no FMA
// contraction), as the plain PyTorch version computes them, and
// sign(0) is 0 (as torch.sign and jnp.sign).
//
// What bounds them: bytes (Adam moves 7 words per element for about 15
// operations, Lion 5 for about 8).  A grid-stride loop with coalesced
// scalar loads; the outputs may alias the inputs (each element is read,
// then written, by one thread).
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

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename TB, typename TG>
__global__ void adam_kernel(const TB* b, const TG* g, const float* m,
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
    const float bi = to_f(b[i]);
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

template <typename TB, typename TG>
__global__ void lion_kernel(const TB* b, const TG* g, const float* m,
                            float* b_out, float* m_out,
                            const float* __restrict__ scalars, int64_t n,
                            float beta1, float one_m_beta1, float beta2,
                            float one_m_beta2, float wd) {
  const float lr = scalars[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = to_f(g[i]);
    const float bi = to_f(b[i]);
    const float mi = m[i];
    const float u = sign_of(
        __fadd_rn(__fmul_rn(beta1, mi), __fmul_rn(one_m_beta1, gi)));
    b_out[i] = __fsub_rn(bi, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, bi))));
    m_out[i] = __fadd_rn(__fmul_rn(beta2, mi), __fmul_rn(one_m_beta2, gi));
  }
}

template <typename TB, typename TG>
void adam_launch(const void* b, const void* g, const float* m,
                 const float* v, float* b_out, float* m_out, float* v_out,
                 const float* scalars, long long n, float beta1,
                 float one_m_beta1, float beta2, float one_m_beta2,
                 float eps, float wd, cudaStream_t st) {
  adam_kernel<TB, TG><<<grid_for(n, 256), 256, 0, st>>>(
      static_cast<const TB*>(b), static_cast<const TG*>(g), m, v, b_out,
      m_out, v_out, scalars, n, beta1, one_m_beta1, beta2, one_m_beta2, eps,
      wd);
}

template <typename TB, typename TG>
void lion_launch(const void* b, const void* g, const float* m, float* b_out,
                 float* m_out, const float* scalars, long long n,
                 float beta1, float one_m_beta1, float beta2,
                 float one_m_beta2, float wd, cudaStream_t st) {
  lion_kernel<TB, TG><<<grid_for(n, 256), 256, 0, st>>>(
      static_cast<const TB*>(b), static_cast<const TG*>(g), m, b_out, m_out,
      scalars, n, beta1, one_m_beta1, beta2, one_m_beta2, wd);
}

}  // namespace

// b_dtype, g_dtype: 0 = float32, 1 = bfloat16.  scalars: (lr, bc1, bc2)
// fp32 on the device.  Returns cudaGetLastError() of the launch (0 =
// queued).
extern "C" int subspace_adam_launch(int b_dtype, int g_dtype, const void* b,
                                    const void* g, const float* m,
                                    const float* v, float* b_out,
                                    float* m_out, float* v_out,
                                    const float* scalars, long long n,
                                    float beta1, float one_m_beta1,
                                    float beta2, float one_m_beta2,
                                    float eps, float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_dtype == 0 && g_dtype == 0)
    adam_launch<float, float>(b, g, m, v, b_out, m_out, v_out, scalars, n,
                              beta1, one_m_beta1, beta2, one_m_beta2, eps,
                              wd, st);
  else if (b_dtype == 0 && g_dtype == 1)
    adam_launch<float, __nv_bfloat16>(b, g, m, v, b_out, m_out, v_out,
                                      scalars, n, beta1, one_m_beta1, beta2,
                                      one_m_beta2, eps, wd, st);
  else if (b_dtype == 1 && g_dtype == 0)
    adam_launch<__nv_bfloat16, float>(b, g, m, v, b_out, m_out, v_out,
                                      scalars, n, beta1, one_m_beta1, beta2,
                                      one_m_beta2, eps, wd, st);
  else if (b_dtype == 1 && g_dtype == 1)
    adam_launch<__nv_bfloat16, __nv_bfloat16>(
        b, g, m, v, b_out, m_out, v_out, scalars, n, beta1, one_m_beta1,
        beta2, one_m_beta2, eps, wd, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The same dtype codes; scalars: (lr) fp32 on the device.
extern "C" int subspace_lion_launch(int b_dtype, int g_dtype, const void* b,
                                    const void* g, const float* m,
                                    float* b_out, float* m_out,
                                    const float* scalars, long long n,
                                    float beta1, float one_m_beta1,
                                    float beta2, float one_m_beta2,
                                    float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_dtype == 0 && g_dtype == 0)
    lion_launch<float, float>(b, g, m, b_out, m_out, scalars, n, beta1,
                              one_m_beta1, beta2, one_m_beta2, wd, st);
  else if (b_dtype == 0 && g_dtype == 1)
    lion_launch<float, __nv_bfloat16>(b, g, m, b_out, m_out, scalars, n,
                                      beta1, one_m_beta1, beta2,
                                      one_m_beta2, wd, st);
  else if (b_dtype == 1 && g_dtype == 0)
    lion_launch<__nv_bfloat16, float>(b, g, m, b_out, m_out, scalars, n,
                                      beta1, one_m_beta1, beta2,
                                      one_m_beta2, wd, st);
  else if (b_dtype == 1 && g_dtype == 1)
    lion_launch<__nv_bfloat16, __nv_bfloat16>(b, g, m, b_out, m_out,
                                              scalars, n, beta1, one_m_beta1,
                                              beta2, one_m_beta2, wd, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
