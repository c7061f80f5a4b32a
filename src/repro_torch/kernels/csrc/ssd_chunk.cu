// Hopper (sm_90a) port of the TPU kernel
// repro/kernels/ssd_chunk.py::ssd_intra_chunk (_ssd_kernel), the Mamba2
// SSD intra-chunk block, per (batch*chunk bc, head h):
//
//   clog    = cumsum(da)                         over the chunk's Q tokens
//   att_ij  = (C_i . B_j) exp(clog_i - clog_j) dt_j          for j <= i
//   y_i     = sum_{j<=i} att_ij x_j                          (Q, P)
//   state   = sum_j exp(clog_last - clog_j) dt_j B_j x_jᵀ    (N, P) fp32
//
// x (BC,Q,H,P), dt and da (BC,Q,H), b and c (BC,Q,H,N) share one dtype,
// fp32 or bf16; y is written in that dtype and the state in fp32.  b and c
// are read through strides (bc, q, head; n contiguous), so a head stride
// of 0 reads one B/C group for every head without a broadcast copy.
//
// The TPU kernel builds a (head-block, Q, Q) score cube in VMEM and runs
// the two contractions on the MXU.  Here one block of 256 threads owns one
// (bc, h) and keeps its whole chunk in shared memory: B (Q x N, rows
// padded by one float so that a warp reading 32 rows of one column hits 32
// banks) and x (Q x P), fp32, with the cumsum of da and dt (thread 0 sums
// in token order).  Scores are built 32 rows of i at a time, each thread a
// 4 x 4 register tile (rows by warp, columns by lane), and only over the
// column blocks that reach the diagonal: the causal half.  A pair j > i is
// never passed to expf: at mamba2's dt*A (A down to -16) clog_i - clog_j
// reaches hundreds over 128 tokens, expf gives inf, and inf * 0 is NaN.
// The row tile's y takes its masked scores from shared memory; then the
// block sums the (N, P) end state.  Everything accumulates in fp32.
//
// What bounds it: at the serving shapes (Q = 128, N = 128, P = 64) about
// 5.3 M fp32 operations over the causal half and 102 KB moved per (bc, h)
// (b and c read once per group and shared by the 48 heads), 52 operations
// per byte against the fp32 SIMT balance point of 20: operations by the
// roofline.  In this first
// version the per-block loads and the shared-memory loops set its time
// (one block per SM at 133 KB of shared memory).  Tensor cores and a
// head block per CTA are later work.
//
// Plain C interface, loaded with ctypes; the Python wrapper
// (repro_torch/kernels/ssd_chunk.py) allocates y and the state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // score rows per tile
constexpr int kRows = kTile / kWarps;      // rows per warp in a tile
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 128;
constexpr int kJB = kMaxQ / 32;            // column blocks of 32
constexpr int kPB = kMaxP / 32;            // p blocks of 32
constexpr int kNB = kMaxN / kWarps;        // state rows per warp

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// B (Qp x (Np+1)), x (Qp x Pp), a C row tile (kTile x Np), the masked
// scores of that tile (kTile x Qp), then clog, dt and the state weights.
__host__ __device__ inline size_t smem_floats(int Qp, int Pp, int Np) {
  return (size_t)Qp * (Np + 1) + (size_t)Qp * Pp + (size_t)kTile * Np +
         (size_t)kTile * Qp + 3 * (size_t)Qp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const T* __restrict__ da, const T* __restrict__ b,
               const T* __restrict__ c, T* __restrict__ y,
               float* __restrict__ state, int Q, int H, int P, int N,
               long long b_sbc, long long b_sq, long long b_sh,
               long long c_sbc, long long c_sq, long long c_sh) {
  extern __shared__ float smem[];
  const int bc = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Qp = round_up(Q, 32), Pp = round_up(P, 32),
            Np = round_up(N, kWarps);
  const int bstride = Np + 1, pb = Pp / 32, nb = Np / kWarps;
  float* Bs = smem;
  float* Xs = Bs + (size_t)Qp * bstride;
  float* Cs = Xs + (size_t)Qp * Pp;
  float* As = Cs + (size_t)kTile * Np;
  float* clog = As + (size_t)kTile * Qp;
  float* dts = clog + Qp;
  float* ws = dts + Qp;

  const long long row0 = (long long)bc * Q;  // first (bc, token) row
  for (int j = tid; j < Qp; j += kThreads) {
    const bool in = j < Q;
    const long long at = (row0 + j) * H + h;
    dts[j] = in ? to_f(dt[at]) : 0.f;
    clog[j] = in ? to_f(da[at]) : 0.f;
  }
  for (int e = tid; e < Qp * Pp; e += kThreads) {
    const int j = e / Pp, p = e - j * Pp;
    Xs[e] = (j < Q && p < P) ? to_f(x[((row0 + j) * H + h) * P + p]) : 0.f;
  }
  const T* bh = b + bc * b_sbc + h * b_sh;
  for (int e = tid; e < Qp * Np; e += kThreads) {
    const int j = e / Np, n = e - j * Np;
    Bs[j * bstride + n] = (j < Q && n < N) ? to_f(bh[j * b_sq + n]) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {  // inclusive cumsum, in token order
    float s = 0.f;
    for (int j = 0; j < Q; ++j) {
      s += clog[j];
      clog[j] = s;
    }
  }
  __syncthreads();
  const float clast = clog[Q - 1];
  for (int j = tid; j < Qp; j += kThreads)
    ws[j] = j < Q ? expf(clast - clog[j]) * dts[j] : 0.f;

  const T* ch = c + bc * c_sbc + h * c_sh;
  for (int t = 0; t < Qp / kTile; ++t) {
    const int i0 = t * kTile;
    for (int e = tid; e < kTile * Np; e += kThreads) {
      const int r = e / Np, n = e - r * Np, i = i0 + r;
      Cs[e] = (i < Q && n < N) ? to_f(ch[i * c_sq + n]) : 0.f;
    }
    __syncthreads();
    // scores of rows i0 + warp + kWarps*m against columns 32k + lane, over
    // the column blocks k <= t that reach the diagonal
    float acc[kRows][kJB];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int k = 0; k < kJB; ++k) acc[m][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) cv[m] = Cs[(warp + kWarps * m) * Np + n];
#pragma unroll
      for (int k = 0; k < kJB; ++k) {
        if (k <= t) {
          const float bv = Bs[(32 * k + lane) * bstride + n];
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            acc[m][k] = fmaf(cv[m], bv, acc[m][k]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int r = warp + kWarps * m, i = i0 + r;
#pragma unroll
      for (int k = 0; k < kJB; ++k) {
        if (k <= t) {
          const int j = 32 * k + lane;
          float a = 0.f;
          if (j <= i && i < Q)  // a masked pair never reaches expf
            a = acc[m][k] * expf(clog[i] - clog[j]) * dts[j];
          As[r * Qp + j] = a;
        }
      }
    }
    __syncthreads();
    // y of this tile's rows: sum over j <= i of the masked scores times x
    const int jend = min(i0 + kTile, Q);
    float out[kRows][kPB];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int q = 0; q < kPB; ++q) out[m][q] = 0.f;
    for (int j = 0; j < jend; ++j) {
      float xv[kPB];
#pragma unroll
      for (int q = 0; q < kPB; ++q)
        xv[q] = q < pb ? Xs[j * Pp + 32 * q + lane] : 0.f;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float a = As[(warp + kWarps * m) * Qp + j];
#pragma unroll
        for (int q = 0; q < kPB; ++q) out[m][q] = fmaf(a, xv[q], out[m][q]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = i0 + warp + kWarps * m;
#pragma unroll
      for (int q = 0; q < kPB; ++q) {
        const int p = 32 * q + lane;
        if (i < Q && q < pb && p < P)
          store(&y[((row0 + i) * H + h) * P + p], out[m][q]);
      }
    }
    __syncthreads();  // Cs and As are rewritten by the next tile
  }

  // the chunk's local end state, rows n = warp + kWarps*m, two p blocks
  // at a time
  float* sh = state + ((long long)bc * H + h) * N * P;
  for (int q0 = 0; q0 < pb; q0 += 2) {
    const bool two = q0 + 1 < pb;
    float st[kNB][2];
#pragma unroll
    for (int m = 0; m < kNB; ++m) st[m][0] = st[m][1] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float w = ws[j];
      const float x0 = w * Xs[j * Pp + 32 * q0 + lane];
      const float x1 = two ? w * Xs[j * Pp + 32 * (q0 + 1) + lane] : 0.f;
#pragma unroll
      for (int m = 0; m < kNB; ++m) {
        if (m < nb) {
          const float bv = Bs[j * bstride + warp + kWarps * m];
          st[m][0] = fmaf(bv, x0, st[m][0]);
          st[m][1] = fmaf(bv, x1, st[m][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kNB; ++m) {
      const int n = warp + kWarps * m;
      if (m < nb && n < N) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int p = 32 * (q0 + u) + lane;
          if (q0 + u < pb && p < P) sh[(long long)n * P + p] = st[m][u];
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a launch needs an opt-in.  It is
// set once per instantiation and device, to what the largest shape takes.
template <typename T>
cudaError_t allow_shared_memory() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxQ, kMaxP, kMaxN) * sizeof(float)));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* x, const void* dt, const void* da, const void* b,
           const void* c, void* y, float* state, long long BC, int Q, int H,
           int P, int N, long long b_sbc, long long b_sq, long long b_sh,
           long long c_sbc, long long c_sq, long long c_sh,
           cudaStream_t st) {
  const size_t bytes =
      smem_floats(round_up(Q, 32), round_up(P, 32), round_up(N, kWarps)) *
      sizeof(float);
  cudaError_t err = allow_shared_memory<T>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)BC, (unsigned)H);
  ssd_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(da), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), state, Q, H, P, N, b_sbc,
      b_sq, b_sh, c_sbc, c_sq, c_sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, dt, da, b, c and y).  x, dt,
// da are contiguous; b and c are read at bc * s_bc + q * s_q + h * s_h + n
// (element strides).  y (BC,Q,H,P) in the dtype, state (BC,H,N,P) fp32.
// 1 <= Q, N, P <= 128.  Returns cudaGetLastError() (0 = queued).
extern "C" int ssd_intra_chunk_launch(
    int dtype, const void* x, const void* dt, const void* da, const void* b,
    const void* c, void* y, float* state, long long BC, int Q, int H, int P,
    int N, long long b_sbc, long long b_sq, long long b_sh, long long c_sbc,
    long long c_sq, long long c_sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BC < 1 || BC > 0x7fffffffLL || H < 1 || H > 65535 || Q < 1 ||
      Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > kMaxP)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, dt, da, b, c, y, state, BC, Q, H, P, N, b_sbc,
                         b_sq, b_sh, c_sbc, c_sq, c_sh, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, da, b, c, y, state, BC, Q, H, P, N,
                                 b_sbc, b_sq, b_sh, c_sbc, c_sq, c_sh, st);
  return (int)cudaErrorInvalidValue;
}
