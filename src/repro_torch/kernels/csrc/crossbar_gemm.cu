// HURRY crossbar GEMM for Hopper: (M, K) int8 x (K, N) int8 -> (M, N) int32.
//
// Replaces the Pallas kernel `crossbar_gemm` of
// src/repro/kernels/crossbar_gemm.py (`_kernel_exact` and `_kernel_sliced`).
// Both branches live in this file; the Python wrapper
// (src/repro_torch/kernels/crossbar_gemm.py) picks one per call.
// A leading slice axis, x (S, M, K) x w (S, K, N) -> y (S, M, N), runs in
// one launch with gridDim.z = S: the counterpart of `jax.vmap` over the
// Pallas call (attention's per-(batch, head) mounts); S = 1 is the 2-D
// call.
//
// Exact branch (`crossbar_gemm_exact`): no ADC clip can fire, so the
// bit-sliced pipeline is a plain int8 GEMM and the chunk structure drops
// out (int32 addition is associative).  |y| <= K * 2^14, so int32 cannot
// overflow at the program's K.  On the H100 it is bound by int8 operations
// at the program's shapes (K up to 4.6k, N up to 512); this first kernel
// runs them on the CUDA cores with __dp4a (4 int8 MACs per instruction)
// over 64x64 output tiles staged through shared memory, 4x4 outputs per
// thread, K in steps of 32 bytes.  Its ceiling is the CUDA cores' int
// rate, about a sixteenth of the tensor cores' 1979 TOPS; wgmma on s8 is
// the later step.  Ragged M, N and K are masked in the loads, so the
// caller pads nothing.
//
// Sliced branch (`crossbar_gemm_sliced`): the paper-faithful ADC
// semantics.  K splits into `rows`-row chunks (one array read each); for
// every (input bit i, weight bit j) the {0,1} bitline count of a chunk is
// clipped to [0, adc_max] before the shift-and-add, the MSB planes
// weighted -128.  A first kernel packs each chunk's bit planes into 32-bit
// masks (tail rows of a ragged chunk are zero bits): x row m -> xp[m][c][i][q],
// w column n -> wp[n][c][j][q], q over ceil(rows/32) words.  The GEMM
// kernel then computes count_ij = sum_q popc(xmask_i & wmask_j) per output
// from masks staged in shared memory.  It is bound by the popcount
// operations: 64 plane pairs x rows/32 words per chunk and output, which
// is two operations per MAC of the exact branch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- exact branch ---------------------------------------------------------

constexpr int EX_BM = 64;          // output rows per block
constexpr int EX_BN = 64;          // output columns per block
constexpr int EX_BK = 32;          // K (bytes) per shared-memory step
constexpr int EX_KQ = EX_BK / 4;   // packed int32 words per step
constexpr int EX_THREADS = 256;    // 16 x 16, 4 x 4 outputs each

// kSlices: the grid's z axis runs over slices.  The 2-D call compiles
// without the slice offsets (kSlices = false), as it did before the axis.
template <bool kSlices>
__global__ void __launch_bounds__(EX_THREADS)
exact_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             int32_t* __restrict__ y, int M, int N, int K) {
  __shared__ int32_t As[EX_KQ][EX_BM];   // 4 consecutive k of row m
  if (kSlices) {                         // this slice's operands
    x += (size_t)blockIdx.z * M * K;
    w += (size_t)blockIdx.z * K * N;
    y += (size_t)blockIdx.z * M * N;
  }
  __shared__ int32_t Bs[EX_KQ][EX_BN];   // 4 consecutive k of column n
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * EX_BM, n0 = blockIdx.y * EX_BN;
  int acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int k0 = 0; k0 < K; k0 += EX_BK) {
    for (int e = tid; e < EX_BM * EX_KQ; e += EX_THREADS) {
      const int r = e / EX_KQ, q = e % EX_KQ;
      const int m = m0 + r, k = k0 + 4 * q;
      uint32_t v = 0;
      if (m < M) {
        const int8_t* p = x + (size_t)m * K + k;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < K) v |= (uint32_t)(uint8_t)p[b] << (8 * b);
      }
      As[q][r] = (int32_t)v;
    }
    for (int e = tid; e < EX_BN * EX_KQ; e += EX_THREADS) {
      const int c = e % EX_BN, q = e / EX_BN;
      const int n = n0 + c, k = k0 + 4 * q;
      uint32_t v = 0;
      if (n < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < K)
            v |= (uint32_t)(uint8_t)w[(size_t)(k + b) * N + n] << (8 * b);
      }
      Bs[q][c] = (int32_t)v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < EX_KQ; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[q][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[q][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) y[(size_t)m * N + n] = acc[r][c];
    }
  }
}

// ---- sliced branch ----------------------------------------------------------

// Bit-plane masks of one operand with S slices.  Element (s, r, k) sits at
// src[s * stride_s + r * stride_r + k * stride_k]; with g = s * R + r,
// out[((g * C + c) * 8 + i) * W + q] holds bit i of rows
// k = c*rows + 32q + b (b = 0..31) of chunk c.  One thread builds the 8
// masks of one (g, c, q) word; g varies fastest across threads.
template <bool kSlices>
__global__ void pack_planes(const int8_t* __restrict__ src,
                            uint32_t* __restrict__ out, int S, int R, int K,
                            long long stride_s, long long stride_r,
                            long long stride_k, int rows, int C, int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long G = (long long)S * R;
  if (idx >= G * C * W) return;
  const long long g = idx % G;
  const long long t = idx / G;
  const int q = (int)(t % W);
  const int c = (int)(t / W);
  const long long s = kSlices ? g / R : 0;
  const int8_t* base = src + s * stride_s + (g - s * R) * stride_r;
  uint32_t mask[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mask[i] = 0;
  for (int b = 0; b < 32; ++b) {
    const int kr = 32 * q + b;                 // row inside the chunk
    const int k = c * rows + kr;
    if (kr >= rows || k >= K) break;
    const uint32_t v = (uint8_t)base[(long long)k * stride_k];
#pragma unroll
    for (int i = 0; i < 8; ++i) mask[i] |= ((v >> i) & 1u) << b;
  }
  uint32_t* o = out + (g * C + c) * 8 * W + q;
#pragma unroll
  for (int i = 0; i < 8; ++i) o[(long long)i * W] = mask[i];
}

constexpr int SL_T = 16;   // 16 x 16 outputs per block, one per thread

__device__ __forceinline__ int plane_weight(int i) {
  return i == 7 ? -128 : (1 << i);
}

// Shared memory: xs[SL_T][8W] then ws[SL_T][8W + 1] (the +1 keeps the 16
// columns a warp reads on distinct banks).
template <bool kSlices>
__global__ void __launch_bounds__(SL_T * SL_T)
sliced_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ wp,
              int32_t* __restrict__ y, int M, int N, int C, int W,
              int adc_max) {
  extern __shared__ uint32_t smem[];
  const int LX = 8 * W, LW = 8 * W + 1;
  uint32_t* xs = smem;
  uint32_t* ws = smem + SL_T * LX;
  if (kSlices) {                               // this slice's masks
    xp += (long long)blockIdx.z * M * C * LX;
    wp += (long long)blockIdx.z * N * C * LX;
    y += (long long)blockIdx.z * M * N;
  }
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SL_T + tx;
  const int m0 = blockIdx.x * SL_T, n0 = blockIdx.y * SL_T;
  const int m = m0 + ty, n = n0 + tx;
  int acc = 0;
  for (int c = 0; c < C; ++c) {
    for (int e = tid; e < SL_T * LX; e += SL_T * SL_T) {
      const int r = e / LX, o = e % LX;
      xs[r * LX + o] =
          m0 + r < M ? xp[((long long)(m0 + r) * C + c) * LX + o] : 0u;
      ws[r * LW + o] =
          n0 + r < N ? wp[((long long)(n0 + r) * C + c) * LX + o] : 0u;
    }
    __syncthreads();
    const uint32_t* xr = xs + ty * LX;
    const uint32_t* wr = ws + tx * LW;
    for (int i = 0; i < 8; ++i) {
      int part = 0;
      for (int j = 0; j < 8; ++j) {
        int cnt = 0;
        for (int q = 0; q < W; ++q) cnt += __popc(xr[i * W + q] & wr[j * W + q]);
        part += plane_weight(j) * min(cnt, adc_max);   // ADC clip
      }
      acc += plane_weight(i) * part;                     // shift-and-add
    }
    __syncthreads();
  }
  if (m < M && n < N) y[(long long)m * N + n] = acc;
}

}  // namespace

extern "C" {

// x (S, M, K), w (S, K, N), y (S, M, N); S = 1 is the 2-D GEMM.
int crossbar_gemm_exact(const void* x, const void* w, void* y, int S, int M,
                        int N, int K, void* stream) {
  const dim3 grid((M + EX_BM - 1) / EX_BM, (N + EX_BN - 1) / EX_BN, S);
  auto kernel = S == 1 ? exact_kernel<false> : exact_kernel<true>;
  kernel<<<grid, EX_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int32_t*)y, M, N, K);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory the sliced GEMM needs for W mask words.
int crossbar_gemm_sliced_smem(int W) {
  return (int)(sizeof(uint32_t) * (SL_T * 8 * W + SL_T * (8 * W + 1)));
}

// xp: S*M*C*8*W and wp: S*N*C*8*W uint32 scratch, allocated by the caller.
int crossbar_gemm_sliced(const void* x, const void* w, void* y, void* xp,
                         void* wp, int S, int M, int N, int K, int rows,
                         int adc_max, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int C = (K + rows - 1) / rows;
  const int W = (rows + 31) / 32;
  const int threads = 256;
  const long long nx = (long long)S * M * C * W;
  const long long nw = (long long)S * N * C * W;
  auto pack = S == 1 ? pack_planes<false> : pack_planes<true>;
  pack<<<(unsigned)((nx + threads - 1) / threads), threads, 0, s>>>(
      (const int8_t*)x, (uint32_t*)xp, S, M, K, (long long)M * K, K, 1, rows,
      C, W);
  pack<<<(unsigned)((nw + threads - 1) / threads), threads, 0, s>>>(
      (const int8_t*)w, (uint32_t*)wp, S, N, K, (long long)K * N, 1, N, rows,
      C, W);
  const int smem = crossbar_gemm_sliced_smem(W);
  auto kernel = S == 1 ? sliced_kernel<false> : sliced_kernel<true>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((M + SL_T - 1) / SL_T, (N + SL_T - 1) / SL_T, S);
  kernel<<<grid, dim3(SL_T, SL_T), smem, s>>>(
      (const uint32_t*)xp, (const uint32_t*)wp, (int32_t*)y, M, N, C, W,
      adc_max);
  return (int)cudaGetLastError();
}

const char* crossbar_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
