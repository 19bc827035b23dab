// float -> element-type converter shared by the float kernels
// (flash_attention.cu, and fused_gemm_epilogue.cu and packed_gemm.cu
// through mma_gemm.cuh): results are written back rounded to nearest
// even.

#pragma once

#include <cuda_bf16.h>

namespace float_io {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace float_io
