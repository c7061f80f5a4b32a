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
// The TPU kernel owns a (blk, 128) tile and its (blk, 1) scales.  What
// bounds it here: bytes (Adam moves about 2·4 + 4 + 2 + 2 bytes per
// element and 16 per row), and close behind them instructions: the exact
// arithmetic takes five IEEE divisions and two square roots an Adam
// element (about 100 instructions with their range checks, the
// reciprocals on the MUFU pipe at an eighth of the FMA rate), about 60%
// of the bytes' time at the largest group.  So the design is the width
// of every memory access and the loads in flight.  Half a warp owns one
// 128-element row,
// each lane 8 contiguous elements, two rows a warp: every load and store
// is 8 to 32 bytes a lane (g 32 or 16, b 16 or 32, bits 32, the int8
// payloads one 8-byte pair of words), and a lane issues all its row's
// loads, the two scales too, before its arithmetic.  The row's absmax is
// a 4-step shuffle-max within the half-warp, the m and v reductions
// interleaved; it is order-free, so the result is the plain version's
// exactly.  The grid covers the rows, up to 8 times the blocks the card
// holds at once (SMs × blocks an SM fits, from the occupancy query):
// against a grid of one resident wave striding over the rows it measured
// 10% faster on an H100, since a block's rows then wait on no loop of
// its own.  A warp's two rows are independent; the outputs
// may alias the inputs: a half-warp reads its whole row before it writes
// any of it, and no other lane touches that row.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/subspace_adam.py) allocates the outputs, checks
// the 16-byte alignment the vector accesses need and pads a ragged last
// row (repro_torch/kernels/dispatch.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_fit.cuh"

namespace {

constexpr int ROW = 128;            // elements per quantization block
constexpr int PER_LANE = 8;         // contiguous elements a lane
constexpr int THREADS = 256;        // 16 rows a block
constexpr int ROWS_PER_BLOCK = THREADS * PER_LANE / ROW;
// the grid: at most WAVES times the blocks the card holds at once, each
// block striding over row pairs beyond that
constexpr int WAVES = 8;

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(wd[k] << 16);
    x[2 * k + 1] = __uint_as_float(wd[k] & 0xFFFF0000u);
  }
}

// 8 contiguous values at p (16-byte aligned), widened to fp32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  unpack(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void load8(const uint32_t* p, uint32_t (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
// 8 int8 payload values (8-byte aligned), as fp32
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    x[k] = (float)(int8_t)(((k < 4 ? u.x : u.y) >> (8 * (k % 4))) & 0xFFu);
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
// rounded to nearest (a value already cut to 16 bits stays as it is)
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[8]) {
  uint32_t wd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    wd[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// the fp32 value whose top 16 bits are bf16(x) stochastically rounded
__device__ __forceinline__ float sr_bits(float x, uint32_t bits) {
  return __uint_as_float((__float_as_uint(x) + bits) & 0xFFFF0000u);
}

// the absmax of a row held as PER_LANE values per lane of a half-warp
__device__ __forceinline__ float lane_absmax(const float (&x)[PER_LANE]) {
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) amax = fmaxf(amax, fabsf(x[k]));
  return amax;
}

// requantize a lane's 8 values with the row's scale s = amax / 127: one
// 8-byte store of the payload
__device__ __forceinline__ void requant8(const float (&x)[PER_LANE],
                                         float s, int8_t* q) {
  const float safe = s > 0.f ? s : 1.f;
  uint32_t wd[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    float r = rintf(__fdiv_rn(x[k], safe));
    r = fminf(fmaxf(r, -127.f), 127.f);
    wd[k / 4] |= ((uint32_t)(uint8_t)(int8_t)r) << (8 * (k % 4));
  }
  *reinterpret_cast<uint2*>(q) = make_uint2(wd[0], wd[1]);
}

template <typename TB, typename TG, bool ADAM>
__global__ void __launch_bounds__(THREADS)
    q8_kernel(const TB* b, const TG* g, const int8_t* mq, const float* ms,
              const int8_t* vq, const float* vs, const uint32_t* bits,
              TB* b_out, int8_t* mq_out, float* ms_out, int8_t* vq_out,
              float* vs_out, const float* __restrict__ scalars, int64_t rows,
              float beta1, float one_m_beta1, float beta2, float one_m_beta2,
              float eps, float wd) {
  const float lr = scalars[0];
  const float bc1 = ADAM ? scalars[1] : 1.f;
  const float bc2 = ADAM ? scalars[2] : 1.f;
  const int lane16 = threadIdx.x % 16;
  const int64_t stride = (int64_t)gridDim.x * ROWS_PER_BLOCK;
  // every lane of a warp runs the same trips (the shuffles take all 32);
  // a half-warp past the last row loads and stores nothing
  for (int64_t base = (int64_t)blockIdx.x * ROWS_PER_BLOCK +
                      (threadIdx.x / 32) * 2;
       base < rows; base += stride) {
    const int64_t row = base + (threadIdx.x % 32) / 16;
    const bool live = row < rows;
    const int64_t i = row * ROW + PER_LANE * lane16;
    float gi[PER_LANE], bi[PER_LANE], m[PER_LANE], y[PER_LANE];
    uint32_t bt[PER_LANE];
    float m_s = 0.f, v_s = 0.f;
    if (live) {
      m_s = ms[row];
      if (ADAM) v_s = vs[row];
      load8(g + i, gi);
      load8(b + i, bi);
      load8(mq + i, m);
      if (ADAM) load8(vq + i, y);
      if (bits != nullptr) load8(bits + i, bt);
    } else {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        gi[k] = bi[k] = m[k] = y[k] = 0.f;
        bt[k] = 0u;
      }
    }
    float m_new[PER_LANE], v_new[PER_LANE], b_new[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const float mk = __fmul_rn(m[k], m_s);
      const float mix = __fadd_rn(__fmul_rn(beta1, mk),
                                  __fmul_rn(one_m_beta1, gi[k]));
      if (ADAM) {
        const float yk = __fmul_rn(y[k], v_s);
        const float v2 = __fadd_rn(__fmul_rn(beta2, __fmul_rn(yk, yk)),
                                   __fmul_rn(__fmul_rn(one_m_beta2, gi[k]),
                                             gi[k]));
        const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), eps);
        const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(mix, bc1), denom),
                                      __fmul_rn(wd, bi[k]));
        b_new[k] = __fsub_rn(bi[k], __fmul_rn(lr, delta));
        m_new[k] = mix;
        v_new[k] = __fsqrt_rn(fmaxf(v2, 0.f));
      } else {
        const float u = sign_of(mix);
        b_new[k] = __fsub_rn(bi[k],
                             __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, bi[k]))));
        m_new[k] = __fadd_rn(__fmul_rn(beta2, mk),
                             __fmul_rn(one_m_beta2, gi[k]));
      }
      if (bits != nullptr) b_new[k] = sr_bits(b_new[k], bt[k]);
    }
    float am = lane_absmax(m_new);
    float av = ADAM ? lane_absmax(v_new) : 0.f;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, off));
      if (ADAM) av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, off));
    }
    if (!live) continue;
    store8(b_out + i, b_new);
    const float sm = __fdiv_rn(am, 127.f);
    requant8(m_new, sm, mq_out + i);
    if (lane16 == 0) ms_out[row] = sm;
    if (ADAM) {
      const float sv = __fdiv_rn(av, 127.f);
      requant8(v_new, sv, vq_out + i);
      if (lane16 == 0) vs_out[row] = sv;
    }
  }
}

template <bool ADAM, typename TB, typename TG>
int launch(const void* b, const void* g, const int8_t* mq, const float* ms,
           const int8_t* vq, const float* vs, const uint32_t* bits,
           void* b_out, int8_t* mq_out, float* ms_out, int8_t* vq_out,
           float* vs_out, const float* scalars, long long rows, float beta1,
           float one_m_beta1, float beta2, float one_m_beta2, float eps,
           float wd, cudaStream_t st) {
  // the resident blocks of the card, asked once per device
  static devfit::ResidentBlocks resident;
  int fit = 0;
  const cudaError_t err =
      resident.get(q8_kernel<TB, TG, ADAM>, THREADS, 0, &fit);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > (long long)WAVES * fit) blocks = (long long)WAVES * fit;
  if (blocks < 1) blocks = 1;
  q8_kernel<TB, TG, ADAM><<<(unsigned)blocks, THREADS, 0, st>>>(
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
