// Fused functional-block epilogue for Hopper: int32 crossbar output -> f32.
//
// Replaces the Pallas kernel `fb_epilogue` (`_kernel`) of
// src/repro/kernels/fb_epilogue.py.  Per element, in the canonical FB
// chain order:
//
//   v = fma(float(y), scale, bias)      one rounding, as jitted XLA contracts
//   v = v + residual                     (optional)
//   v = v * post_scale                   (optional, attention's 1/sqrt(hd))
//   v = relu(v) | gelu_tanh(v)           (optional)
//   then per row: layer norm (eps 1e-5)  (optional)
//   then one of: non-overlapping max / avg pool of window x window blocks
//   over each image's img_hw^2 im2col rows, seq-mean over `window` token
//   rows, or row softmax.
//
// What bounds it on the H100: memory traffic.  It does a few operations
// per element and reads 4 bytes of int32 (8 with a residual) per element
// it writes, so its floor is the bytes over 3.35 TB/s.  The design keeps
// every intermediate in registers or shared memory and touches device
// memory once per input element:
//
// * `elementwise_kernel` (no pool, no row reduction): one thread per
//   element, grid-stride, neighbouring threads on neighbouring columns.
// * `pool_kernel` (max / avg pool): one thread per output element loops
//   over its window x window inputs.  A program never holds a whole image
//   (the TPU kernel's img_hw^2-row block does not fit registers at 32x32).
// * `rows_kernel` (layer norm, softmax, seq-mean): one block per output
//   row holds the full feature row in shared memory for the row
//   reductions; for seq-mean it walks the sequence's `window` rows and
//   accumulates the column sums in shared memory.
//
// Arithmetic is written with explicit round-to-nearest intrinsics so nvcc
// contracts nothing the plain PyTorch version does not: the kernel equals
// the plain version bit for bit wherever the order of a sum is the same
// (none, relu, residual, post_scale, gelu, max and avg pool).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kGeluC = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float kLnEps = 1e-5f;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };
enum Pool { POOL_NONE = 0, POOL_MAX = 1, POOL_AVG = 2, POOL_SEQMEAN = 3 };

struct Chain {
  const int32_t* y;
  const float* scale;   // (1, 1) on the device: no host round trip
  const float* bias;
  const float* res;     // null: no residual
  const float* gamma;
  const float* beta;
  float* out;
  int M, N;
  int act;
  float post_scale;     // 0: off
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))), left to right
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(kGeluC, __fadd_rn(x, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

__device__ __forceinline__ float chain(const Chain& p, long long idx, int col,
                                       float scale) {
  float v = __fmaf_rn(__int2float_rn(p.y[idx]), scale, p.bias[col]);
  if (p.res) v = __fadd_rn(v, p.res[idx]);
  if (p.post_scale != 0.0f) v = __fmul_rn(v, p.post_scale);
  if (p.act == ACT_RELU) v = fmaxf(v, 0.0f);
  else if (p.act == ACT_GELU) v = gelu_tanh(v);
  return v;
}

__global__ void elementwise_kernel(Chain p) {
  const float scale = *p.scale;
  const long long total = (long long)p.M * p.N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    p.out[i] = chain(p, i, (int)(i % p.N), scale);
}

__global__ void pool_kernel(Chain p, int pool, int window, int img_hw) {
  const float scale = *p.scale;
  const int oh = img_hw / window;
  const long long images = p.M / ((long long)img_hw * img_hw);
  const long long total = images * oh * oh * p.N;
  const float inv = 1.0f / (float)(window * window);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % p.N);
    const long long orow = i / p.N;
    const int ox = (int)(orow % oh);
    const long long t = orow / oh;
    const int oy = (int)(t % oh);
    const long long img = t / oh;
    float acc = pool == POOL_MAX ? -CUDART_INF_F : 0.0f;
    for (int a = 0; a < window; ++a)
      for (int b = 0; b < window; ++b) {
        const long long r = img * img_hw * img_hw +
                            (long long)(oy * window + a) * img_hw +
                            ox * window + b;
        const float v = chain(p, r * p.N + c, c, scale);
        acc = pool == POOL_MAX ? fmaxf(acc, v) : __fadd_rn(acc, v);
      }
    p.out[i] = pool == POOL_MAX ? acc : __fmul_rn(acc, inv);
  }
}

// Block-wide reductions; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();                       // red[] free from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int k = 0; k < (int)(blockDim.x / 32); ++k) s += red[k];
  return s;
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int k = 0; k < (int)(blockDim.x / 32); ++k) m = fmaxf(m, red[k]);
  return m;
}

// One block per output row; `group` input rows per output row (the
// sequence length for seq-mean, else 1).  Each thread owns columns
// tid, tid + blockDim.x, ... of the shared row, so only the reductions
// synchronise.
__global__ void rows_kernel(Chain p, int group, int norm, int softmax,
                            int seqmean) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* row = smem;
  float* acc = smem + p.N;
  const int N = p.N;
  const float scale = *p.scale;
  const long long o = blockIdx.x;
  if (seqmean)
    for (int c = threadIdx.x; c < N; c += blockDim.x) acc[c] = 0.0f;
  for (int t = 0; t < group; ++t) {
    const long long r = o * group + t;
    for (int c = threadIdx.x; c < N; c += blockDim.x)
      row[c] = chain(p, r * N + c, c, scale);
    if (norm) {
      float s = 0.0f;
      for (int c = threadIdx.x; c < N; c += blockDim.x) s = __fadd_rn(s, row[c]);
      const float mean = __fdiv_rn(block_sum(s, red), (float)N);
      float q = 0.0f;
      for (int c = threadIdx.x; c < N; c += blockDim.x) {
        const float d = __fsub_rn(row[c], mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
      const float var = __fdiv_rn(block_sum(q, red), (float)N);
      const float den = __fsqrt_rn(__fadd_rn(var, kLnEps));
      for (int c = threadIdx.x; c < N; c += blockDim.x)
        row[c] = __fadd_rn(
            __fmul_rn(__fdiv_rn(__fsub_rn(row[c], mean), den), p.gamma[c]),
            p.beta[c]);
    }
    if (softmax) {
      float m = -CUDART_INF_F;
      for (int c = threadIdx.x; c < N; c += blockDim.x) m = fmaxf(m, row[c]);
      m = block_max(m, red);
      float s = 0.0f;
      for (int c = threadIdx.x; c < N; c += blockDim.x) {
        const float e = expf(__fsub_rn(row[c], m));
        row[c] = e;
        s = __fadd_rn(s, e);
      }
      s = block_sum(s, red);
      for (int c = threadIdx.x; c < N; c += blockDim.x)
        row[c] = __fdiv_rn(row[c], s);
    }
    if (seqmean) {
      for (int c = threadIdx.x; c < N; c += blockDim.x)
        acc[c] = __fadd_rn(acc[c], row[c]);
    } else {
      for (int c = threadIdx.x; c < N; c += blockDim.x)
        p.out[r * N + c] = row[c];
    }
  }
  if (seqmean)
    for (int c = threadIdx.x; c < N; c += blockDim.x)
      p.out[o * N + c] = __fdiv_rn(acc[c], (float)group);
}

unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 64;        // grid-stride beyond this
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory `rows_kernel` needs for N columns.
int fb_epilogue_rows_smem(int N, int seqmean) {
  return (int)(sizeof(float) * (size_t)N * (seqmean ? 2 : 1));
}

// pool: 0 none, 1 max, 2 avg, 3 seqmean.  res / gamma / beta may be null.
int fb_epilogue(const void* y, const void* scale, const void* bias,
                const void* res, const void* gamma, const void* beta,
                void* out, int M, int N, int act, float post_scale, int norm,
                int pool, int window, int img_hw, int softmax, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Chain p{(const int32_t*)y, (const float*)scale, (const float*)bias,
          (const float*)res,  (const float*)gamma, (const float*)beta,
          (float*)out,        M,                   N,
          act,                post_scale};
  const int threads = 256;
  if (pool == POOL_MAX || pool == POOL_AVG) {
    const int oh = img_hw / window;
    const long long total = (long long)(M / (img_hw * img_hw)) * oh * oh * N;
    pool_kernel<<<grid_for(total, threads), threads, 0, s>>>(p, pool, window,
                                                             img_hw);
  } else if (norm || softmax || pool == POOL_SEQMEAN) {
    const int seqmean = pool == POOL_SEQMEAN;
    const int group = seqmean ? window : 1;
    const int smem = fb_epilogue_rows_smem(N, seqmean);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int row_threads = N >= 256 ? 256 : (N > 64 ? 128 : 64);
    rows_kernel<<<M / group, row_threads, smem, s>>>(p, group, norm, softmax,
                                                     seqmean);
  } else {
    elementwise_kernel<<<grid_for((long long)M * N, threads), threads, 0, s>>>(
        p);
  }
  return (int)cudaGetLastError();
}

const char* fb_epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
