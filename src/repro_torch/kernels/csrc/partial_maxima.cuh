// What fb_epilogue.cu and quantize_layout.cu share: the most partial
// maxima one fb_epilogue launch leaves, which is the most a
// quantize_layout call takes in place of its own amax pass, and the
// card's SM count, by which both size their grids.

#pragma once

#include <cuda_runtime.h>

namespace partial_maxima {

// fb_epilogue_max_parts(); kernels/quantize_layout.py's MAX_GIVEN
constexpr int kMaxGiven = 4096;

// The current device's SM count, read once, to *sms; or the error that
// kept CUDA from saying.
inline cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) {
      cached = 0;
      return e;
    }
    if (cached < 1) {
      cached = 0;
      return cudaErrorInvalidDevice;
    }
  }
  *sms = cached;
  return cudaSuccess;
}

}  // namespace partial_maxima
