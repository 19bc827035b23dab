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
// y * sigmoid(y).  The bias and the residual are read in their own type
// (float32 or bf16) and converted in registers, as the JAX kernel does.
// The epilogue runs on the accumulator while it is still on the SM, so
// the GEMM's output never goes to device memory before the activation:
// the point of the TPU kernel, kept.
//
// What bounds it on the H100.  At the shapes its callers use
// (256x512x256 in the kernel bench) the work is 67 MFLOP against ~1 MB
// of operands: about a microsecond on the tensor cores, so the kernel is
// bound by latency and by how many SMs it keeps busy, not by the
// products.  The first design ran the products on the CUDA cores in 16
// blocks of 64x64 with K serial (0.0586 ms).  This one:
//
// * runs the products on the tensor cores (mma_gemm.cuh: bf16 mma.sync,
//   3xTF32 for float32, a 4-deep cp.async ring);
// * splits K across the blocks of a thread-block cluster where the 64x64
//   output tiles are few: as many shares (at most 8) as keep the blocks
//   within the 132 SMs, each a multiple of two k-tiles (the split comes
//   from the shape alone: fused_gemm_epilogue.py:k_splits).  Block z of
//   a tile's cluster multiplies its share of K and leaves its float32
//   partial tile in its own shared memory; one cluster barrier; then it
//   reads rows [z*64/s, (z+1)*64/s) of all s partial tiles through
//   distributed shared memory (all s reads in flight), sums them in the
//   fixed order 0..s-1, arrives (relaxed) at a second cluster barrier and
//   runs the epilogue on those rows, waiting at that barrier only before
//   it exits, so that no block leaves while another still reads it.  No
//   workspace, no counters, no float atomics: the output is the same
//   from run to run.  (A first split, partials through a global
//   workspace and the last block to bump a per-tile counter summing
//   them, took 0.0198 ms at the bench shape: dependent global round
//   trips and a memset node.  Pushing the partial rows to their owners
//   instead made the barrier's GPU-scope membar wait out the remote
//   stores: PERF.md, PR 10.)
// * stages an unsplit tile in shared memory too, so every epilogue reads
//   the residual and writes the output 16 bytes at a time, and loads the
//   bias and the first residual row before the products.
//
// At the bench shape the measured phases of a block (PERF.md, PR 10)
// are: 1.2-1.7 us to the first k-tile, the products, ~1.4 us for the
// exchange and its barrier, 0.6-1.0 us of epilogue.

#include <cooperative_groups.h>

#include "mma_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using mma_gemm::THREADS;

constexpr int BM = 64;
constexpr int BN = 64;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

constexpr float kGeluC = 0.7978845608028654f;   // sqrt(2/pi)

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if constexpr (ACT == ACT_RELU) {
    return fmaxf(y, 0.0f);
  } else if constexpr (ACT == ACT_SILU) {
    return y * (1.0f / (1.0f + expf(-y)));
  } else if constexpr (ACT == ACT_GELU) {
    return y * (0.5f * (1.0f + tanhf(kGeluC * (y + 0.044715f * (y * y * y)))));
  } else {
    return y;
  }
}

// element i of a float32 (dt 0) or bf16 (dt 1) array, as float
__device__ __forceinline__ float load_f32(const void* p, size_t i, int dt) {
  return dt == 1 ? __bfloat162float(
                       reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

struct Args {
  const void* x;
  const void* w;
  const void* b;
  const void* res;      // null: no residual
  void* out;
  int M, N, K, act, b_dt, res_dt, splits, k_chunk, vec_a, vec_b;
};

// v[j] = element off + j of a float32 (dt 0) or bf16 (dt 1) array where
// n + j < N, else 0
__device__ __forceinline__ void load4(float (&v)[4], const void* p,
                                      size_t off, int n, int N, int dt) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = n + j < N ? load_f32(p, off + j, dt) : 0.0f;
}

constexpr int MAX_SPLITS = 8;  // the blocks of a split form one cluster

// Block (tile, z) of a cluster of `splits` blocks along y: K elements
// [z * k_chunk, (z + 1) * k_chunk) of output tile `tile`, then rows
// [z * BM / s, (z + 1) * BM / s) of its epilogue.  The activation is a
// template parameter, so each kernel holds the code of one.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS) fused_kernel(Args a) {
  using C = mma_gemm::Tile<T, BM, BN>;
  constexpr int MI = C::MI, NI = C::NI, LDC = C::LDC, Q = BN / 4;
  static_assert(2 * BM * LDC * 4 <= C::SMEM_BYTES, "no room for the sums");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  // after the products: this block's partial tile, then its rows' sums
  float* tile_c = reinterpret_cast<float*>(smem_raw);
  float* sums = tile_c + BM * LDC;

  const int tiles_n = (a.N + BN - 1) / BN;
  const int tile = blockIdx.x, z = blockIdx.y, s = a.splits;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int kbeg = z * a.k_chunk, kend = min(a.K, kbeg + a.k_chunk);
  // this thread's share of the epilogue: columns c..c+3 of the tile in
  // rows r0 + tid / Q + i * ROW_STEP, i < ITEMS, below r1
  constexpr int ROW_STEP = THREADS / Q, ITEMS = BM / ROW_STEP;
  const int r0 = z * BM / s, r1 = (z + 1) * BM / s;
  const int c = (threadIdx.x % Q) * 4, n = n0 + c;
  const int rt = r0 + threadIdx.x / Q;
  const bool col_in = n < a.N;
  // the bias and the first row's residual, in flight while the products
  // run
  float bias[4], next[4];
  load4(bias, col_in ? a.b : nullptr, n, n, col_in ? a.N : 0, a.b_dt);
  const bool res0 = a.res && col_in && rt < r1 && m0 + rt < a.M;
  load4(next, a.res, (size_t)(m0 + rt) * a.N + n, n, res0 ? a.N : 0,
        a.res_dt);

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  mma_gemm::gemm_tile<T, BM, BN>(acc, (const T*)a.x, (const T*)a.w, m0, a.M,
                                 n0, a.N, a.K, kbeg, kend, a.vec_a, a.vec_b,
                                 ring);
  __syncthreads();                       // the ring is free
  mma_gemm::acc_to_smem<BM, BN>(acc, tile_c);
  cg::cluster_group cluster = cg::this_cluster();
  if (s == 1) {
    __syncthreads();
  } else {
    // every block's partial tile in its own shared memory, then one
    // cluster barrier; this thread's rows summed over the s partial tiles
    // in the order 0..s-1, all s reads through distributed shared memory
    // in flight at once, into `sums`; a relaxed arrival says this block
    // is done reading the others (they wait for it before they exit)
    cluster.sync();
#pragma unroll 1
    for (int i = 0; i < ITEMS; ++i) {
      const int r = rt + i * ROW_STEP;
      if (r >= r1) break;
      float4 p[MAX_SPLITS];
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        if (q < s)
          p[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(tile_c, q) + r * LDC + c);
      float4 v = p[0];
#pragma unroll
      for (int q = 1; q < MAX_SPLITS; ++q)
        if (q < s) {
          v.x = __fadd_rn(v.x, p[q].x);
          v.y = __fadd_rn(v.y, p[q].y);
          v.z = __fadd_rn(v.z, p[q].z);
          v.w = __fadd_rn(v.w, p[q].w);
        }
      *reinterpret_cast<float4*>(sums + r * LDC + c) = v;
    }
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  }
  const float* total = s == 1 ? tile_c : sums;

  // row r: its total + b, activation, + residual, cast and store; the
  // next row's residual loads while this one is finished.  A row group
  // costs 0.4-0.5 us with SiLU, ~0.2 without (one warp per scheduler;
  // PERF.md, PR 10).
#pragma unroll 1
  for (int i = 0; i < ITEMS; ++i) {
    const int r = rt + i * ROW_STEP, m = m0 + r;
    if (r >= r1 || m >= a.M || !col_in) break;
    const float cur[4] = {next[0], next[1], next[2], next[3]};
    const bool more = a.res && r + ROW_STEP < r1 && m + ROW_STEP < a.M;
    load4(next, a.res, (size_t)(m + ROW_STEP) * a.N + n, n, more ? a.N : 0,
          a.res_dt);
    const float4 v = *reinterpret_cast<const float4*>(total + r * LDC + c);
    float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = activate<ACT>(y[j] + bias[j]);
      if (a.res) y[j] += cur[j];
    }
    mma_gemm::store4<T>((T*)a.out, m, n, a.N, y);
  }
  if (s > 1)   // the others are done reading this block's partial tile
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <typename T, int ACT>
int launch(Args a, cudaStream_t s) {
  using C = mma_gemm::Tile<T, BM, BN>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      fused_kernel<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (allowed != cudaSuccess) return (int)allowed;
  a.vec_a = mma_gemm::rows_vec16<T>(a.x, a.K);
  a.vec_b = mma_gemm::rows_vec16<T>(a.w, a.N);
  const int tiles = ((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fused_kernel<T, ACT>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int launch(Args a, cudaStream_t s) {
  switch (a.act) {
    case ACT_RELU:
      return launch<T, ACT_RELU>(a, s);
    case ACT_SILU:
      return launch<T, ACT_SILU>(a, s);
    case ACT_GELU:
      return launch<T, ACT_GELU>(a, s);
    default:
      return launch<T, ACT_NONE>(a, s);
  }
}

}  // namespace

extern "C" {

// x (M, K), w (K, N) and out (M, N) of one type (dtype 0 float, 1 bf16);
// b (N,) and res (M, N) or null, each float (0) or bf16 (1) by b_dtype
// and res_dtype.  act: 0 none, 1 relu, 2 silu, 3 gelu.  K is cut into
// `splits` (at most 8, the cluster) shares of k_chunk elements, a
// multiple of 64 (fused_gemm_epilogue.py:k_splits).
int fused_gemm_epilogue(const void* x, const void* w, const void* b,
                        const void* res, void* out, int M, int N, int K,
                        int act, int dtype, int b_dtype, int res_dtype,
                        int splits, int k_chunk, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || k_chunk % 64 != 0 ||
      (long long)splits * k_chunk < K ||
      (splits > 1 && (long long)(splits - 1) * k_chunk >= K))
    return (int)cudaErrorInvalidValue;
  Args a{x, w, b, res, out, M, N, K, act, b_dtype, res_dtype, splits,
         k_chunk, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return launch<float>(a, s);
}

const char* fused_gemm_epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
