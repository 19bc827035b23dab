// Fused GEMM + bias + activation (+ residual) for Hopper.
//
// Replaces the Pallas kernel `fused_gemm_epilogue` (`_kernel`) of
// src/repro/kernels/fused_gemm_epilogue.py, reached through
// `ops.linear_fused`.  Per output element, in the JAX kernel's order:
//
//   y = sum_k x[m, k] * w[k, n]          float accumulation
//   y = y + b[n]
//   y = relu(y) | silu(y) | gelu_tanh(y) (or none)
//   y = y + residual[m, n]               (optional)
//   out = cast(y) to x's type            (float or bf16)
//
// GELU is the tanh form, as `jax.nn.gelu` is by default; SiLU is
// y * sigmoid(y).  The epilogue runs on the accumulator while it is still
// in registers, so the GEMM's output never goes to device memory before
// the activation: the point of the TPU kernel, kept.
//
// What bounds it on the H100: the float products.  At the shapes its
// callers use (256x512x256 in the kernel bench) the work is 67 MFLOP
// against ~1 MB of operands, so operations bound it, and this first
// kernel runs them on the CUDA cores (tile_gemm.cuh: 64x64 tiles, 4x4
// outputs per thread, K in steps of 16 through shared memory).

#include "tile_gemm.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

constexpr float kGeluC = 0.7978845608028654f;   // sqrt(2/pi)

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_SILU:
      return y * (1.0f / (1.0f + expf(-y)));
    case ACT_GELU:
      return y * (0.5f * (1.0f + tanhf(kGeluC * (y + 0.044715f * (y * y * y)))));
    default:
      return y;
  }
}

template <typename T>
__global__ void __launch_bounds__(tile_gemm::THREADS)
fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ res,
             T* __restrict__ out, int M, int N, int K, int act) {
  const int m0 = blockIdx.x * tile_gemm::BM, n0 = blockIdx.y * tile_gemm::BN;
  float acc[4][4] = {};
  tile_gemm::tile(x, w, m0, M, n0, N, K, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n >= N) continue;
      float y = activate(acc[r][c] + b[n], act);
      if (res) y += res[(size_t)m * N + n];
      out[(size_t)m * N + n] = tile_gemm::from_f32<T>(y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* res,
           void* out, int M, int N, int K, int act, cudaStream_t s) {
  const dim3 grid((M + tile_gemm::BM - 1) / tile_gemm::BM,
                  (N + tile_gemm::BN - 1) / tile_gemm::BN);
  fused_kernel<T><<<grid, tile_gemm::THREADS, 0, s>>>(
      (const T*)x, (const T*)w, (const float*)b, (const float*)res, (T*)out,
      M, N, K, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K), w (K, N) and out (M, N) of one type (dtype 0 float, 1 bf16);
// b (N,) and res (M, N) or null in float, as the JAX kernel reads them.
// act: 0 none, 1 relu, 2 silu, 3 gelu.
int fused_gemm_epilogue(const void* x, const void* w, const void* b,
                        const void* res, void* out, int M, int N, int K,
                        int act, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, res, out, M, N, K, act, s);
  return launch<float>(x, w, b, res, out, M, N, K, act, s);
}

const char* fused_gemm_epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
