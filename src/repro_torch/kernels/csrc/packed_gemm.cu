// Grouped (MoE-expert) GEMM for Hopper: the BAS block-packing analogue.
//
// Replaces the Pallas kernel `packed_gemm` (`_kernel`) of
// src/repro/kernels/packed_gemm.py, reached through `ops.grouped_gemm`.
// x (Mp, K) holds rows sorted by group, each group padded to a multiple
// of block_m; tile_groups (ceil(Mp / block_m),) names the group of each
// block_m-row tile, and the tile's rows multiply w[g] (K, N):
//
//   out[m, n] = sum_k x[m, k] * w[tile_groups[m / block_m], k, n]
//
// in float, cast to x's type (float or bf16).  The TPU kernel gets the
// group id by scalar prefetch before its grid step; here each block
// reads its tile's id itself and points at w[g].
//
// What bounds it on the H100.  At the kernel bench's case (4 groups
// padded to 896 rows, K 128, N 256: 59 MFLOP against ~1 MB) the products
// are a microsecond on the tensor cores, so latency and the number of
// busy SMs bound it.  The first design ran 56 blocks of 64x64 on the
// CUDA cores.  This one runs the products on the tensor cores
// (mma_gemm.cuh: bf16 mma.sync, 3xTF32 for float32) with K whole (K is
// 128 at the bench: a split would not pay) and cuts the output finer:
// 32-column tiles where 64-column ones would leave blocks under twice
// the SM count (112 blocks at the bench), 64 columns otherwise.  A
// block's rows never span two block_m tiles: its row tile is the largest
// of 64 / 32 / 16 that divides block_m (packed_gemm.py:packed_tile);
// where none does, the last row tile of each block_m tile is masked at
// the boundary.

#include "mma_gemm.cuh"

namespace {

struct Args {
  const void* x;
  const void* w;
  const int32_t* tile_groups;
  void* out;
  int Mp, N, K, block_m, sub_tiles, vec_a, vec_b;
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(mma_gemm::THREADS) packed_kernel(Args a) {
  using C = mma_gemm::Tile<T, BM, BN>;
  constexpr int MI = C::MI, NI = C::NI, Q = BN / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile_c = reinterpret_cast<float*>(smem_raw);

  const int tile = blockIdx.x / a.sub_tiles, sub = blockIdx.x % a.sub_tiles;
  const int m0 = tile * a.block_m + sub * BM;
  const int m_end = min(min(m0 + BM, (tile + 1) * a.block_m), a.Mp);
  const int n0 = blockIdx.y * BN;
  const T* wg = (const T*)a.w + (size_t)a.tile_groups[tile] * a.K * a.N;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  mma_gemm::gemm_tile<T, BM, BN>(acc, (const T*)a.x, wg, m0, m_end, n0, a.N,
                                 a.K, 0, a.K, a.vec_a, a.vec_b,
                                 reinterpret_cast<T*>(smem_raw));
  __syncthreads();                       // the ring is free
  mma_gemm::acc_to_smem<BM, BN>(acc, tile_c);
  __syncthreads();
  for (int e = threadIdx.x; e < (m_end - m0) * Q; e += mma_gemm::THREADS) {
    const int r = e / Q, c = (e % Q) * 4;
    if (n0 + c >= a.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile_c + r * C::LDC + c);
    const float y[4] = {v.x, v.y, v.z, v.w};
    mma_gemm::store4<T>((T*)a.out, m0 + r, n0 + c, a.N, y);
  }
}

template <typename T, int BM, int BN>
int launch_tile(Args a, cudaStream_t s) {
  using C = mma_gemm::Tile<T, BM, BN>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      packed_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (allowed != cudaSuccess) return (int)allowed;
  a.sub_tiles = (a.block_m + BM - 1) / BM;
  a.vec_a = mma_gemm::rows_vec16<T>(a.x, a.K);
  a.vec_b = mma_gemm::rows_vec16<T>(a.w, a.N);
  const long long tiles = (a.Mp + a.block_m - 1) / a.block_m;
  const dim3 grid((unsigned)(tiles * a.sub_tiles), (a.N + BN - 1) / BN);
  packed_kernel<T, BM, BN><<<grid, mma_gemm::THREADS, C::SMEM_BYTES, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Args a, int bm, int bn, cudaStream_t s) {
  if (bn == 64) {
    if (bm == 64) return launch_tile<T, 64, 64>(a, s);
    if (bm == 32) return launch_tile<T, 32, 64>(a, s);
    if (bm == 16) return launch_tile<T, 16, 64>(a, s);
  } else if (bn == 32) {
    if (bm == 64) return launch_tile<T, 64, 32>(a, s);
    if (bm == 32) return launch_tile<T, 32, 32>(a, s);
    if (bm == 16) return launch_tile<T, 16, 32>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (Mp, K), w (G, K, N), out (Mp, N) of one type (dtype 0 float,
// 1 bf16); tile_groups (ceil(Mp / block_m),) int32, each in [0, G).
// The block tile is tile_m x tile_n, tile_m in {16, 32, 64} and tile_n
// in {32, 64} (packed_gemm.py:packed_tile).
int packed_gemm(const void* x, const void* w, const void* tile_groups,
                void* out, int Mp, int N, int K, int block_m, int tile_m,
                int tile_n, int dtype, void* stream) {
  if (block_m < 1) return (int)cudaErrorInvalidValue;
  Args a{x, w, (const int32_t*)tile_groups, out, Mp, N, K, block_m, 1, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, tile_m, tile_n, s);
  return launch<float>(a, tile_m, tile_n, s);
}

const char* packed_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
