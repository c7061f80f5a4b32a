// The blocks of one kernel that the current device holds at once, asked
// once per device: the SM count times the blocks an SM fits at the
// launch's threads and dynamic shared memory (the occupancy query).  The
// persistent SR merge and the int8-state updates size their grids from
// it.  Header-only, in an unnamed namespace as wgmma_gemm.cuh is
// (each source is a library of its own); each launcher keeps one
// ResidentBlocks per kernel instance (a static in its template), so the
// query runs once per device and instance.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {
namespace devfit {

class ResidentBlocks {
 public:
  // *fit = SMs x blocks an SM holds of `kernel` at `threads` threads and
  // `smem` bytes of dynamic shared memory (at least one an SM).  A
  // kernel with more than 48 KB of dynamic shared memory is opted in
  // first, once per device.
  template <typename F>
  cudaError_t get(F kernel, int threads, size_t smem, int* fit) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && fit_[dev] > 0) {
      *fit = fit_[dev];
      return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    *fit = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) fit_[dev] = *fit;
    return cudaSuccess;
  }

 private:
  static constexpr int kMaxDevices = 64;
  int fit_[kMaxDevices] = {};
};

}  // namespace devfit
}  // namespace
