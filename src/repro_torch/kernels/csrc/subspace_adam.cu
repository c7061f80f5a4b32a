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
// sums are rounded one by one (__fmul_rn/__fadd_rn/__fdiv_rn/
// __fsqrt_rn, no FMA contraction), as the plain PyTorch version computes
// them, so the kernels equal it bit for bit; sign(0) is 0 (as torch.sign
// and jnp.sign).
//
// What bounds them: bytes.  Adam moves 28 bytes an element in fp32 (b,
// g, m, v in; b', m', v' out) for about 15 operations, Lion 20 for
// about 8.  The first design, a grid-stride loop of one element a
// thread (four 4-byte loads, three 4-byte stores, at most 132 x 16
// blocks), reached 75% of the bytes bound on an H100 at qwen3-moe's
// expert B groups (5.618 / 7.518 ms against 4.207 / 5.609) and 58-76%
// at llama-100m's, behind fused torch.optim.AdamW's 79-82%: 4-byte
// accesses and one element's loads in flight a thread, each load's
// latency then paid again by the arithmetic and the stores behind it.
//
// This design (route "vec16"): block t of THREADS lanes takes the tile
// of TILE = THREADS x UNROLL x VEC consecutive elements from t·TILE; in
// vector step u lane l owns the VEC = 4 elements from t·TILE + (u·THREADS
// + l)·VEC, so every access is one 16-byte word of an fp32 stream (8
// bytes of a bf16 one) and a warp's access covers 512 (256) consecutive
// bytes, whole 32-byte sectors.  (Eight consecutive elements a lane, two
// 16-byte words of a stream, leave each of the two loads half of every
// sector it touches: measured slower on an H100.)  A lane issues the
// loads of all its UNROLL vector steps before any arithmetic (UNROLL x
// 4 streams x 16 bytes in flight), so the arithmetic, about 1 ms of
// issue at 671 M elements, hides under the loads; each IEEE division's
// slow path is a subroutine behind FCHK's predicate, off the common
// path.  Loads and stores are evict-first (ld.global.cs / st.global.cs):
// each word is touched once a step.  The grid is one block a whole tile
// (n / TILE blocks, the wrapper's plan,
// repro_torch/kernels/subspace_adam.py::update_grid; a persistent grid
// striding over the tiles measured slower), and a second launch of one
// block takes the ragged last tile, when there is one, with the same
// arithmetic: as a branch of the one launch its code made the fp32
// instance spill.  The entry points say how many grids they queued, so
// the wrapper counts each launch.  Indices are 64-bit (qwen3-moe's
// w_gate·w_up B group holds 503 M elements).  The outputs may alias the
// inputs: a lane reads its elements before it writes them, and no other
// lane touches them.
//
// Plain C interface, loaded with ctypes; the Python wrapper allocates
// the outputs and refuses an operand that is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // lanes a block
constexpr int VEC = 4;         // consecutive elements a lane per step
constexpr int UNROLL = 4;      // vector steps loaded before arithmetic
constexpr int TILE = THREADS * UNROLL * VEC;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// every vector access is evict-first: each word is touched once a step
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldcs(p);
}
__device__ __forceinline__ void st(float4* p, float4 x) { __stcs(p, x); }

// the VEC values of a stream a lane reads at one vector step, as loaded:
// 16 bytes of fp32, 8 of bf16
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 w;
};
template <>
struct Raw<__nv_bfloat16> {
  uint2 w;
};

__device__ __forceinline__ void load(const float* p, Raw<float>& r) {
  r.w = ld(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Raw<__nv_bfloat16>& r) {
  r.w = ld(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[VEC]) {
  x[0] = r.w.x; x[1] = r.w.y; x[2] = r.w.z; x[3] = r.w.w;
}
// bf16 -> fp32 is exact: the bf16 bits are the fp32 value's top 16
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float (&x)[VEC]) {
  x[0] = __uint_as_float(r.w.x << 16);
  x[1] = __uint_as_float(r.w.x & 0xFFFF0000u);
  x[2] = __uint_as_float(r.w.y << 16);
  x[3] = __uint_as_float(r.w.y & 0xFFFF0000u);
}

__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  st(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}

// lr and the bias corrections, read from the device once a launch
struct Scalars {
  float lr, bc1, bc2;
};

// The per-element rules, in the plain version's order of operations;
// a rule holds the launch constants.
struct AdamRule {
  static constexpr bool kHasV = true;
  float beta1, one_m_beta1, beta2, one_m_beta2, eps, wd;
  __device__ __forceinline__ void operator()(const Scalars& s, float bi,
                                             float gi, float mi, float vi,
                                             float& b2, float& m2,
                                             float& v2) const {
    m2 = __fadd_rn(__fmul_rn(beta1, mi), __fmul_rn(one_m_beta1, gi));
    v2 = __fadd_rn(__fmul_rn(beta2, vi),
                   __fmul_rn(__fmul_rn(one_m_beta2, gi), gi));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.bc2)), eps);
    const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m2, s.bc1), denom),
                                  __fmul_rn(wd, bi));
    b2 = __fsub_rn(bi, __fmul_rn(s.lr, delta));
  }
};

struct LionRule {
  static constexpr bool kHasV = false;
  float beta1, one_m_beta1, beta2, one_m_beta2, wd;
  __device__ __forceinline__ void operator()(const Scalars& s, float bi,
                                             float gi, float mi, float,
                                             float& b2, float& m2,
                                             float&) const {
    const float u = sign_of(
        __fadd_rn(__fmul_rn(beta1, mi), __fmul_rn(one_m_beta1, gi)));
    b2 = __fsub_rn(bi, __fmul_rn(s.lr, __fadd_rn(u, __fmul_rn(wd, bi))));
    m2 = __fadd_rn(__fmul_rn(beta2, mi), __fmul_rn(one_m_beta2, gi));
  }
};

template <typename TB, typename TG>
struct Operands {
  const TB* b;
  const TG* g;
  const float* m;
  const float* v;   // Adam only
  float* b_out;
  float* m_out;
  float* v_out;     // Adam only
};

// one lane's loads of one vector step
template <typename Rule, typename TB, typename TG>
struct Step {
  Raw<TB> b;
  Raw<TG> g;
  Raw<float> m, v;

  __device__ __forceinline__ void load_at(const Operands<TB, TG>& o,
                                          int64_t i) {
    load(o.b + i, b);
    load(o.g + i, g);
    load(o.m + i, m);
    if (Rule::kHasV) load(o.v + i, v);
  }

  __device__ __forceinline__ void update_at(const Operands<TB, TG>& o,
                                            const Rule& rule,
                                            const Scalars& s,
                                            int64_t i) const {
    float bx[VEC], gx[VEC], mx[VEC], vx[VEC], b2[VEC], m2[VEC], v2[VEC];
    widen(b, bx);
    widen(g, gx);
    widen(m, mx);
    if (Rule::kHasV) widen(v, vx);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      rule(s, bx[k], gx[k], mx[k], Rule::kHasV ? vx[k] : 0.f, b2[k], m2[k],
           v2[k]);
    store(o.b_out + i, b2);
    store(o.m_out + i, m2);
    if (Rule::kHasV) store(o.v_out + i, v2);
  }
};

// The read-once streams of `rule` over n elements.  kWhole: block t
// takes the whole tile from t·TILE, step u of lane l the VEC elements
// from t·TILE + (u·THREADS + l)·VEC; else one block takes the ragged last
// tile from (n / TILE)·TILE the same way: a vector that ends by n whole,
// of the one that does not the elements before n one at a time.  (In one
// kernel, the ragged tile a branch of its block, the fp32 Adam instance
// spilled.)
template <typename Rule, typename TB, typename TG, bool kWhole>
__global__ void __launch_bounds__(THREADS)
    update_kernel(const Operands<TB, TG> o, const Rule rule,
                  const float* __restrict__ scalars, int64_t n) {
  Scalars s{scalars[0], 1.f, 1.f};
  if constexpr (Rule::kHasV) {
    s.bc1 = scalars[1];
    s.bc2 = scalars[2];
  }
  const int64_t tile = kWhole ? (int64_t)blockIdx.x * TILE : n / TILE * TILE;
  const int64_t base = tile + (int64_t)threadIdx.x * VEC;
  if constexpr (kWhole) {
    Step<Rule, TB, TG> steps[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      steps[u].load_at(o, base + (int64_t)u * THREADS * VEC);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      steps[u].update_at(o, rule, s, base + (int64_t)u * THREADS * VEC);
  } else {
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + (int64_t)u * THREADS * VEC;
      if (i + VEC <= n) {
        Step<Rule, TB, TG> one;
        one.load_at(o, i);
        one.update_at(o, rule, s, i);
      } else {
        for (int64_t j = i; j < n; ++j) {
          float b2, m2, v2;
          rule(s, to_f(o.b[j]), to_f(o.g[j]), o.m[j],
               Rule::kHasV ? o.v[j] : 0.f, b2, m2, v2);
          o.b_out[j] = b2;
          o.m_out[j] = m2;
          if (Rule::kHasV) o.v_out[j] = v2;
        }
      }
    }
  }
}

// grid blocks over the whole tiles, then one block over the ragged last
// tile when TILE does not divide n; *launched = the grids queued
template <typename Rule, typename TB, typename TG>
int launch_as(const void* b, const void* g, const float* m, const float* v,
              float* b_out, float* m_out, float* v_out, const Rule& rule,
              const float* scalars, long long n, int grid, int* launched,
              cudaStream_t st) {
  const Operands<TB, TG> o{static_cast<const TB*>(b),
                           static_cast<const TG*>(g), m, v, b_out, m_out,
                           v_out};
  *launched = 0;
  if (grid > 0) {
    update_kernel<Rule, TB, TG, true>
        <<<grid, THREADS, 0, st>>>(o, rule, scalars, n);
    ++*launched;
  }
  if (n % TILE) {
    update_kernel<Rule, TB, TG, false>
        <<<1, THREADS, 0, st>>>(o, rule, scalars, n);
    ++*launched;
  }
  return (int)cudaGetLastError();
}

// the instance of (b dtype, g dtype): 0 = float32, 1 = bfloat16
template <typename Rule>
int launch(int b_dtype, int g_dtype, const void* b, const void* g,
           const float* m, const float* v, float* b_out, float* m_out,
           float* v_out, const Rule& rule, const float* scalars,
           long long n, int grid, int* launched, cudaStream_t st) {
  // the wrapper's plan must be this library's: a block a whole tile
  if (n < 1 || grid != n / TILE) return (int)cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
  if (b_dtype == 0 && g_dtype == 0)
    return launch_as<Rule, float, float>(b, g, m, v, b_out, m_out, v_out,
                                         rule, scalars, n, grid, launched,
                                         st);
  if (b_dtype == 0 && g_dtype == 1)
    return launch_as<Rule, float, BF>(b, g, m, v, b_out, m_out, v_out, rule,
                                      scalars, n, grid, launched, st);
  if (b_dtype == 1 && g_dtype == 0)
    return launch_as<Rule, BF, float>(b, g, m, v, b_out, m_out, v_out, rule,
                                      scalars, n, grid, launched, st);
  if (b_dtype == 1 && g_dtype == 1)
    return launch_as<Rule, BF, BF>(b, g, m, v, b_out, m_out, v_out, rule,
                                   scalars, n, grid, launched, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// b_dtype, g_dtype: 0 = float32, 1 = bfloat16.  scalars: (lr, bc1, bc2)
// fp32 on the device.  grid: n / TILE blocks over the whole tiles, n >= 1
// (the wrapper's plan; another is refused).  *launched: the grids queued,
// 1 or 2 (the ragged last tile's).  Returns cudaGetLastError() of the
// launches (0 = queued).
extern "C" int subspace_adam_launch(int b_dtype, int g_dtype, const void* b,
                                    const void* g, const float* m,
                                    const float* v, float* b_out,
                                    float* m_out, float* v_out,
                                    const float* scalars, long long n,
                                    float beta1, float one_m_beta1,
                                    float beta2, float one_m_beta2,
                                    float eps, float wd, int grid,
                                    int* launched, void* stream) {
  const AdamRule rule{beta1, one_m_beta1, beta2, one_m_beta2, eps, wd};
  return launch(b_dtype, g_dtype, b, g, m, v, b_out, m_out, v_out, rule,
                scalars, n, grid, launched,
                static_cast<cudaStream_t>(stream));
}

// The same dtype codes, grid and count; scalars: (lr) fp32 on the
// device.
extern "C" int subspace_lion_launch(int b_dtype, int g_dtype, const void* b,
                                    const void* g, const float* m,
                                    float* b_out, float* m_out,
                                    const float* scalars, long long n,
                                    float beta1, float one_m_beta1,
                                    float beta2, float one_m_beta2,
                                    float wd, int grid, int* launched,
                                    void* stream) {
  const LionRule rule{beta1, one_m_beta1, beta2, one_m_beta2, wd};
  return launch(b_dtype, g_dtype, b, g, m, nullptr, b_out, m_out, nullptr,
                rule, scalars, n, grid, launched,
                static_cast<cudaStream_t>(stream));
}
