// Hopper (sm_90a) ports of the TPU kernels
// repro/kernels/subspace_adam.py::subspace_adam_q8 (_adam_q8_kernel) and
// ::subspace_lion_q8 (_lion_q8_kernel): the subspace updates of B on
// int8 block-quantized moments.
//
// The moments arrive in the (R, 128) block layout, int8 payload with one
// fp32 absmax scale per row (R,):  m in the linear codec (m = q s), v in
// the sqrt codec (v = (q s)²).  Per row the kernel dequantizes, runs the
// fp32 update, and requantizes, so the fp32 moments never reach device
// memory:
//
//   Adam:  m' = β1 m + (1 − β1) g,  v' = β2 v + (1 − β2) g²
//          b' = b − lr ((m'/bc1) / (√(v'/bc2) + eps) + wd b)
//          (q, s) ← requant(m'),  requant(√max(v', 0))
//   Lion:  b' = b − lr (sign(β1 m + (1 − β1) g) + wd b)
//          (q, s) ← requant(β2 m + (1 − β2) g)
//
//   requant(x): s = max|x| / 127 over the row (a true division),
//               q = clamp(rint(x / (s > 0 ? s : 1)), −127, 127)
//               (round half to even, as jnp.round and torch.round)
//
// b is the fp32 or bf16 master and b' keeps its dtype.  With `bits`
// (R, 128) values in [0, 2^16) b' is stochastically rounded to bf16 (the
// bits are added to the fp32 pattern, which is then cut to its top 16
// bits); without, it is rounded to nearest.  lr (and bc1, bc2 for Adam)
// come from a small fp32 device tensor; every operation is rounded as
// written (__fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn, no FMA contraction)
// so the kernel computes what the plain PyTorch version computes.
//
// The TPU kernel owns a (blk, 128) tile and its (blk, 1) scales.  Here
// one warp owns one 128-element row (4 elements a lane, neighbouring
// lanes on neighbouring addresses) and a shuffle-max gives the row's
// absmax; 8 rows per block, grid-stride over rows.  What bounds it:
// bytes (Adam moves about 2·4 + 4 + 2 + 2 bytes per element and 16 per
// row for about 25 operations).  The outputs may alias the inputs: a
// warp reads its whole row before it writes any of it.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/subspace_adam.py) allocates the outputs and pads
// a ragged last row (repro_torch/kernels/dispatch.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;            // elements per quantization block
constexpr int PER_LANE = ROW / 32;
constexpr int WARPS = 8;            // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// the fp32 value whose top 16 bits are bf16(x) stochastically rounded
__device__ __forceinline__ float sr_bits(float x, uint32_t bits) {
  return __uint_as_float((__float_as_uint(x) + bits) & 0xFFFF0000u);
}

// requantize one row held as PER_LANE values per lane of the warp
__device__ __forceinline__ void requant_row(const float (&x)[PER_LANE],
                                            int8_t* q, float* scale,
                                            int64_t row, int lane) {
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) amax = fmaxf(amax, fabsf(x[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fdiv_rn(amax, 127.f);
  const float safe = s > 0.f ? s : 1.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    float r = rintf(__fdiv_rn(x[k], safe));
    r = fminf(fmaxf(r, -127.f), 127.f);
    q[row * ROW + lane + 32 * k] = (int8_t)r;
  }
  if (lane == 0) scale[row] = s;
}

template <typename TB, typename TG, bool ADAM>
__global__ void __launch_bounds__(WARPS * 32)
    q8_kernel(const TB* b, const TG* g, const int8_t* mq, const float* ms,
              const int8_t* vq, const float* vs, const uint32_t* bits,
              TB* b_out, int8_t* mq_out, float* ms_out, int8_t* vq_out,
              float* vs_out, const float* __restrict__ scalars, int64_t rows,
              float beta1, float one_m_beta1, float beta2, float one_m_beta2,
              float eps, float wd) {
  const float lr = scalars[0];
  const float bc1 = ADAM ? scalars[1] : 1.f;
  const float bc2 = ADAM ? scalars[2] : 1.f;
  const int lane = threadIdx.x % 32;
  for (int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
       row < rows; row += (int64_t)gridDim.x * WARPS) {
    const float m_s = ms[row];
    const float v_s = ADAM ? vs[row] : 0.f;
    float m_new[PER_LANE], v_new[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int64_t i = row * ROW + lane + 32 * k;
      const float gi = to_f(g[i]);
      const float bi = to_f(b[i]);
      const float m = __fmul_rn((float)mq[i], m_s);
      const float mix = __fadd_rn(__fmul_rn(beta1, m),
                                  __fmul_rn(one_m_beta1, gi));
      float b_new;
      if (ADAM) {
        const float y = __fmul_rn((float)vq[i], v_s);
        const float v2 = __fadd_rn(__fmul_rn(beta2, __fmul_rn(y, y)),
                                   __fmul_rn(__fmul_rn(one_m_beta2, gi), gi));
        const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), eps);
        const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(mix, bc1), denom),
                                      __fmul_rn(wd, bi));
        b_new = __fsub_rn(bi, __fmul_rn(lr, delta));
        m_new[k] = mix;
        v_new[k] = __fsqrt_rn(fmaxf(v2, 0.f));
      } else {
        const float u = sign_of(mix);
        b_new = __fsub_rn(bi, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, bi))));
        m_new[k] = __fadd_rn(__fmul_rn(beta2, m), __fmul_rn(one_m_beta2, gi));
      }
      if (bits != nullptr) b_new = sr_bits(b_new, bits[i]);
      store(b_out + i, b_new);
    }
    requant_row(m_new, mq_out, ms_out, row, lane);
    if (ADAM) requant_row(v_new, vq_out, vs_out, row, lane);
  }
}

template <bool ADAM, typename TB, typename TG>
int launch(const void* b, const void* g, const int8_t* mq, const float* ms,
           const int8_t* vq, const float* vs, const uint32_t* bits,
           void* b_out, int8_t* mq_out, float* ms_out, int8_t* vq_out,
           float* vs_out, const float* scalars, long long rows, float beta1,
           float one_m_beta1, float beta2, float one_m_beta2, float eps,
           float wd, cudaStream_t st) {
  long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  q8_kernel<TB, TG, ADAM><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
      static_cast<const TB*>(b), static_cast<const TG*>(g), mq, ms, vq, vs,
      bits, static_cast<TB*>(b_out), mq_out, ms_out, vq_out, vs_out, scalars,
      rows, beta1, one_m_beta1, beta2, one_m_beta2, eps, wd);
  return (int)cudaGetLastError();
}

template <bool ADAM>
int pick(int b_dtype, int g_dtype, const void* b, const void* g,
         const int8_t* mq, const float* ms, const int8_t* vq, const float* vs,
         const uint32_t* bits, void* b_out, int8_t* mq_out, float* ms_out,
         int8_t* vq_out, float* vs_out, const float* scalars, long long rows,
         float beta1, float one_m_beta1, float beta2, float one_m_beta2,
         float eps, float wd, cudaStream_t st) {
#define Q8_ARGS                                                          \
  b, g, mq, ms, vq, vs, bits, b_out, mq_out, ms_out, vq_out, vs_out,     \
      scalars, rows, beta1, one_m_beta1, beta2, one_m_beta2, eps, wd, st
  if (b_dtype == 0 && g_dtype == 0)
    return launch<ADAM, float, float>(Q8_ARGS);
  if (b_dtype == 0 && g_dtype == 1)
    return launch<ADAM, float, __nv_bfloat16>(Q8_ARGS);
  if (b_dtype == 1 && g_dtype == 0)
    return launch<ADAM, __nv_bfloat16, float>(Q8_ARGS);
  if (b_dtype == 1 && g_dtype == 1)
    return launch<ADAM, __nv_bfloat16, __nv_bfloat16>(Q8_ARGS);
#undef Q8_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// b_dtype, g_dtype: 0 = float32, 1 = bfloat16 (b_out has b's dtype).
// b, g, mq, vq, bits and the outputs hold `rows` contiguous rows of 128;
// ms, vs, ms_out, vs_out one fp32 scale per row; bits may be null (round
// to nearest).  scalars: (lr, bc1, bc2) fp32 on the device.  Returns
// cudaGetLastError() of the launch (0 = queued).
extern "C" int subspace_adam_q8_launch(
    int b_dtype, int g_dtype, const void* b, const void* g, const int8_t* mq,
    const float* ms, const int8_t* vq, const float* vs, const uint32_t* bits,
    void* b_out, int8_t* mq_out, float* ms_out, int8_t* vq_out,
    float* vs_out, const float* scalars, long long rows, float beta1,
    float one_m_beta1, float beta2, float one_m_beta2, float eps, float wd,
    void* stream) {
  return pick<true>(b_dtype, g_dtype, b, g, mq, ms, vq, vs, bits, b_out,
                    mq_out, ms_out, vq_out, vs_out, scalars, rows, beta1,
                    one_m_beta1, beta2, one_m_beta2, eps, wd,
                    static_cast<cudaStream_t>(stream));
}

// The Lion form: no v; scalars: (lr) fp32 on the device.
extern "C" int subspace_lion_q8_launch(
    int b_dtype, int g_dtype, const void* b, const void* g, const int8_t* mq,
    const float* ms, const uint32_t* bits, void* b_out, int8_t* mq_out,
    float* ms_out, const float* scalars, long long rows, float beta1,
    float one_m_beta1, float beta2, float one_m_beta2, float wd,
    void* stream) {
  return pick<false>(b_dtype, g_dtype, b, g, mq, ms, nullptr, nullptr, bits,
                     b_out, mq_out, ms_out, nullptr, nullptr, scalars, rows,
                     beta1, one_m_beta1, beta2, one_m_beta2, 0.f, wd,
                     static_cast<cudaStream_t>(stream));
}
