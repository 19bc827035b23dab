// A 64x64 float-accumulating GEMM tile, shared by fused_gemm_epilogue.cu
// and packed_gemm.cu.
//
// 256 threads; thread (tx, ty) = (tid % 16, tid / 16) owns the 4x4 outputs
// at rows m0 + ty + 16r and columns n0 + tx + 16c.  K advances in steps of
// 16 through shared memory, operands converted to float on load (bf16 via
// __bfloat162float), and each output sums its products in K order with
// fmaf.  Rows at or past m_end, columns at or past N and k at or past K
// load as zeros, so ragged edges need no padding by the caller.
//
// What bounds it on the H100: at the shapes its callers use (M, N a few
// hundred, K up to 1k) the float products on the CUDA cores, 67 TFLOP/s
// at best, and at small M*N too few blocks to fill 132 SMs.  wgmma on
// bf16 / tf32 with a TMA-fed shared-memory ring is the later step.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_io.cuh"

namespace tile_gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

using float_io::from_f32;
using float_io::to_f32;

// acc[r][c] += sum_k x[m][k] * w[k][n] over the tile's rows m in [m0, m_end)
// and columns n in [n0, N); x is row-major (., K), w row-major (K, N).
template <typename T>
__device__ __forceinline__ void tile(const T* __restrict__ x,
                                     const T* __restrict__ w, int m0,
                                     int m_end, int n0, int N, int K,
                                     float (&acc)[4][4]) {
  __shared__ float As[BK][BM + 4];   // k-major, so a thread reads 4 rows
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < m_end && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN;
      const int n = n0 + c, k = k0 + kk;
      Bs[kk][c] = (n < N && k < K) ? to_f32(w[(size_t)k * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace tile_gemm
