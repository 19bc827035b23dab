// Grouped (MoE-expert) GEMM for Hopper: the BAS block-packing analogue.
//
// Replaces the Pallas kernel `packed_gemm` (`_kernel`) of
// src/repro/kernels/packed_gemm.py, reached through `ops.grouped_gemm`.
// x (Mp, K) holds rows sorted by group, each group padded to a multiple
// of block_m; tile_groups (Mp / block_m,) names the group of each
// block_m-row tile, and the tile's rows multiply w[g] (K, N):
//
//   out[m, n] = sum_k x[m, k] * w[tile_groups[m / block_m], k, n]
//
// in float, cast to x's type (float or bf16).  The TPU kernel gets the
// group id by scalar prefetch before its grid step; here each block
// reads its tile's id itself and points at w[g].  A block covers 64 rows
// of one tile (ceil(block_m / 64) blocks per tile, the last one masked)
// and 64 columns, K whole as in JAX (tile_gemm.cuh).
//
// What bounds it on the H100: the float products, as for
// fused_gemm_epilogue.cu (the kernel bench's case is 656 rows x 128 x
// 256 over 4 groups: 43 MFLOP against 0.8 MB).

#include "tile_gemm.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tile_gemm::THREADS)
packed_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const int32_t* __restrict__ tile_groups, T* __restrict__ out,
              int Mp, int N, int K, int block_m, int sub_tiles) {
  const int tile = blockIdx.x / sub_tiles, sub = blockIdx.x % sub_tiles;
  const int m0 = tile * block_m + sub * tile_gemm::BM;
  const int m_end = min((tile + 1) * block_m, Mp);
  const int n0 = blockIdx.y * tile_gemm::BN;
  const T* wg = w + (size_t)tile_groups[tile] * K * N;
  float acc[4][4] = {};
  tile_gemm::tile(x, wg, m0, m_end, n0, N, K, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= m_end) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) out[(size_t)m * N + n] = tile_gemm::from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* tile_groups, void* out,
           int Mp, int N, int K, int block_m, cudaStream_t s) {
  const int sub_tiles = (block_m + tile_gemm::BM - 1) / tile_gemm::BM;
  const int tiles = (Mp + block_m - 1) / block_m;
  const dim3 grid(tiles * sub_tiles, (N + tile_gemm::BN - 1) / tile_gemm::BN);
  packed_kernel<T><<<grid, tile_gemm::THREADS, 0, s>>>(
      (const T*)x, (const T*)w, (const int32_t*)tile_groups, (T*)out, Mp, N, K,
      block_m, sub_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (Mp, K), w (G, K, N), out (Mp, N) of one type (dtype 0 float,
// 1 bf16); tile_groups (ceil(Mp / block_m),) int32, each in [0, G).
int packed_gemm(const void* x, const void* w, const void* tile_groups,
                void* out, int Mp, int N, int K, int block_m, int dtype,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, tile_groups, out, Mp, N, K, block_m,
                                 s);
  return launch<float>(x, w, tile_groups, out, Mp, N, K, block_m, s);
}

const char* packed_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
