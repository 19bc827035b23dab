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
// it writes, so its floor is the bytes over 3.35 TB/s.  Every
// intermediate stays in registers (or shared memory for the long rows)
// and device memory is touched once per input element.  The first design
// lost about 2.7 us a launch to that floor: 64-bit divisions per element,
// scalar 4-byte accesses, bias re-read per element, a block (and four
// __syncthreads reductions) per 64-column score row, and 32 blocks for
// ResNet-18's final pool.  This design:
//
// * `elementwise_kernel` (no pool, no row reduction): a 2-D grid of
//   column groups x row tiles.  A thread owns V = 4 columns (16-byte
//   int4 / float4 accesses when N % 4 == 0 and the pointers are aligned;
//   V = 1 otherwise) and walks `rpt` rows, with its bias in registers,
//   the slice scale read once per row and 32-bit indices inside a row.
// * `pool_kernel` (max / avg pool): a thread per (output pixel, V
//   channels; V = 1 where 4 would leave the card idle), block sizes
//   picked so the blocks fill the card; pixel
//   coordinates from 32-bit divisions once per output, none in the window
//   loop, and the window summed a-major then b as the plain version does.
// * `rows_warp_kernel` (layer norm, softmax; N <= 1024): one warp per row,
//   8 rows a block, the row in registers (lane L holds columns L + 32k:
//   coalesced 4-byte accesses across the warp) and shuffle-only
//   reductions.  The sums follow the first design's block reduction
//   addition for addition (`row_sum`), so every mode returns what that
//   design returned, bit for bit: another order is as close to the plain
//   version but rounds elsewhere, and the int8 quantizations downstream
//   amplify such ulps into vit_tiny's end-to-end gap to the CPU path.
// * `seqmean_kernel` (seq-mean; N <= 1024, a sequence's rows within
//   200 KB): one block per sequence; its token rows are dealt over 8
//   warps into shared memory, then each column is summed over the tokens
//   in order, as the first design did.
// * `rows_kernel` (N > 1024, or a longer sequence): one block per row, the
//   row in shared memory (the first design's path; `fb_epilogue_rows_smem`
//   sizes it).
//
// Arithmetic is written with explicit round-to-nearest intrinsics so nvcc
// contracts nothing the plain PyTorch version does not: the kernel equals
// the plain version bit for bit wherever the order of a sum is the same
// (none, relu, residual, post_scale, gelu, max and avg pool).
//
// A leading slice axis (attention's per-(batch, head) scores and
// context, what `jax.vmap` over the Pallas call computes) runs in the
// same launch: y is (S * slice_rows, N) and row r dequantizes with its
// slice's scale, scale[r / slice_rows].  The 2-D call has one slice.
// Where the slices are (batch, head) pairs of attention's context, the
// kernel can store them with the heads merged (`heads` > 0, no pool):
// slice s = b * heads + h's row m goes to out[b, m, h * N : (h + 1) * N]
// of (B, slice_rows, heads * N), what the reference's `merge_heads`
// after the vmapped epilogue computes (src/repro/program/execute.py:135).
// A null bias adds nothing: fma(y, scale, +0) rounds as y * scale does.
//
// A tap (pre-norm transformer blocks, x = x + f(LN(x))): with a non-null
// `tap`, a layer norm, no pool and no heads, the row's value before the
// layer norm (the residual sum) is stored to tap, shaped as y, by the
// same threads in the same pass: `rows_warp_tap_kernel` (N <= 1024) and
// `rows_tap_kernel` (longer rows) are the row kernels' bodies
// instantiated with the store, and calls without a tap launch the row
// kernels as they were, with the same code.

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
  const float* scale;   // (S, 1, 1) on the device: no host round trip
  const float* bias;
  const float* res;     // null: no residual
  const float* gamma;
  const float* beta;
  float* out;
  int M, N;
  int slice_rows;       // rows per scale (M for one slice)
  int act;
  float post_scale;     // 0: off
  int heads;            // > 0: slices stored with the heads merged
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))), left to right
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(kGeluC, __fadd_rn(x, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

// The scale of input row `row`.  With one slice (the 2-D call) every row
// reads scale[0] and no division is spent.
__device__ __forceinline__ float row_scale(const Chain& p, long long row) {
  return p.slice_rows == p.M ? *p.scale : p.scale[row / p.slice_rows];
}

// Element offset of output row r's first column: r * N, or with `heads`
// the head-merged place of slice s = b * heads + h's row m.
__device__ __forceinline__ size_t out_row(const Chain& p, long long r) {
  if (!p.heads) return (size_t)r * p.N;
  const long long s = r / p.slice_rows, m = r - s * p.slice_rows;
  const long long b = s / p.heads, h = s - b * p.heads;
  return ((size_t)(b * p.slice_rows + m) * p.heads + h) * p.N;
}

// The chain up to the activation, on one value.
__device__ __forceinline__ float chain1(const Chain& p, int32_t y,
                                        float scale, float bias, float res) {
  float v = __fmaf_rn(__int2float_rn(y), scale, bias);
  if (p.res) v = __fadd_rn(v, res);
  if (p.post_scale != 0.0f) v = __fmul_rn(v, p.post_scale);
  if (p.act == ACT_RELU) v = fmaxf(v, 0.0f);
  else if (p.act == ACT_GELU) v = gelu_tanh(v);
  return v;
}

__device__ __forceinline__ float chain(const Chain& p, long long idx, int col,
                                       float scale) {
  return chain1(p, p.y[idx], scale, p.bias ? p.bias[col] : 0.0f,
                p.res ? p.res[idx] : 0.0f);
}

// V consecutive values at element offset `off` (V = 4: one 16-byte access)
template <int V>
__device__ __forceinline__ void load_y(const int32_t* y, size_t off,
                                       int32_t* v) {
  if constexpr (V == 4) {
    const int4 q = *reinterpret_cast<const int4*>(y + off);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = y[off + j];
  }
}

template <int V>
__device__ __forceinline__ void load_f(const float* x, size_t off, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(x + off);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = x[off + j];
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* x, size_t off, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(x + off) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[off + j] = v[j];
  }
}

// The chain on V values of row r at column c.
template <int V>
__device__ __forceinline__ void chain_v(const Chain& p, size_t off,
                                        float scale, const float* bias,
                                        float* out) {
  int32_t y[V];
  float res[V];
  load_y<V>(p.y, off, y);
  if (p.res) load_f<V>(p.res, off, res);
#pragma unroll
  for (int j = 0; j < V; ++j)
    out[j] = chain1(p, y[j], scale, bias[j], p.res ? res[j] : 0.0f);
}

// blockDim (bx, by): thread x owns column group blockIdx.x * bx + x, and
// rows blockIdx.y * by * rpt + y + k * by for k < rpt (grid-stride in y).
template <int V>
__global__ void elementwise_kernel(Chain p, int rpt) {
  const int G = p.N / V;
  const int cg = blockIdx.x * blockDim.x + threadIdx.x;
  if (cg >= G) return;
  const int c = cg * V;
  float bias[V] = {};
  if (p.bias) load_f<V>(p.bias, c, bias);
  const bool one_slice = p.slice_rows == p.M;
  const float scale0 = *p.scale;
  const int tile = blockDim.y * rpt;
  for (long long r0 = (long long)blockIdx.y * tile; r0 < p.M;
       r0 += (long long)gridDim.y * tile)
    for (int k = 0; k < rpt; ++k) {
      const long long r = r0 + threadIdx.y + (long long)k * blockDim.y;
      if (r >= p.M) break;
      const float scale = one_slice ? scale0 : p.scale[r / p.slice_rows];
      float v[V];
      chain_v<V>(p, (size_t)r * p.N + c, scale, bias, v);
      store_f<V>(p.out, out_row(p, r) + c, v);
    }
}

// blockDim (bx, by): thread x owns column group blockIdx.x * bx + x, and
// output pixels blockIdx.y * by + y, grid-stride in y.
template <int V>
__global__ void pool_kernel(Chain p, int pool, int window, int img_hw,
                            int pixels) {
  const int G = p.N / V;
  const int cg = blockIdx.x * blockDim.x + threadIdx.x;
  if (cg >= G) return;
  const int c = cg * V;
  float bias[V] = {};
  if (p.bias) load_f<V>(p.bias, c, bias);
  const int oh = img_hw / window;
  const float inv = 1.0f / (float)(window * window);
  for (int o = blockIdx.y * blockDim.y + threadIdx.y; o < pixels;
       o += gridDim.y * blockDim.y) {
    const int ox = o % oh, t = o / oh;
    const int oy = t % oh, img = t / oh;
    const size_t base = (size_t)img * img_hw * img_hw +
                        (size_t)(oy * window) * img_hw + ox * window;
    const float scale = row_scale(p, (long long)base);   // one slice an image
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = pool == POOL_MAX ? -CUDART_INF_F : 0.0f;
    for (int a = 0; a < window; ++a) {
      const size_t row_a = (base + (size_t)a * img_hw) * p.N + c;
#pragma unroll 4
      for (int b = 0; b < window; ++b) {
        float v[V];
        chain_v<V>(p, row_a + (size_t)b * p.N, scale, bias, v);
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = pool == POOL_MAX ? fmaxf(acc[j], v[j])
                                    : __fadd_rn(acc[j], v[j]);
      }
    }
    if (pool != POOL_MAX)
      for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(acc[j], inv);
    store_f<V>(p.out, (size_t)o * p.N + c, acc);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The first design's block sum, in one warp: that design gave a row W
// warps (64, 128 or 256 threads by N), thread tid summed columns tid,
// tid + 32W, ... in order, each warp reduced its threads by the xor
// tree of warp_sum, and the W warp sums were added in warp order.  Lane
// L holds column L + 32k in x[k], so thread L + 32w's columns are
// chunks w, w + W, ...: the same additions in the same order, and the
// same result bit for bit.
template <int NV, int W>
__device__ __forceinline__ float row_sum(const float* x, int lane, int N) {
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    float part = 0.0f;
#pragma unroll
    for (int k = w; k < NV; k += W)
      if (lane + 32 * k < N) part = __fadd_rn(part, x[k]);
    total += warp_sum(part);
  }
  return total;
}

// Row r of the chain into registers (lane L: columns L + 32k, coalesced
// 4-byte accesses across the warp), then the layer norm (if any) with
// the first design's sums.
// With TAP the chain's values are stored to `tap` before the layer norm.
template <int NV, int W, bool TAP = false>
__device__ __forceinline__ void warp_row(const Chain& p, long long r,
                                         int lane, int norm, float* x,
                                         float* tap = nullptr) {
  const int N = p.N;
  const float scale = row_scale(p, r);
  const size_t row = (size_t)r * N;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = lane + 32 * k;
    x[k] = c < N ? chain(p, (long long)(row + c), c, scale) : 0.0f;
  }
  if constexpr (TAP) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c < N) tap[row + c] = x[k];
    }
  }
  if (!norm) return;
  const float mean = __fdiv_rn(row_sum<NV, W>(x, lane, N), (float)N);
  float d2[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float d = __fsub_rn(x[k], mean);
    d2[k] = __fmul_rn(d, d);
  }
  const float var = __fdiv_rn(row_sum<NV, W>(d2, lane, N), (float)N);
  const float den = __fsqrt_rn(__fadd_rn(var, kLnEps));
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = lane + 32 * k;
    if (c < N)
      x[k] = __fadd_rn(
          __fmul_rn(__fdiv_rn(__fsub_rn(x[k], mean), den), p.gamma[c]),
          p.beta[c]);
  }
}

// One warp per row (layer norm and / or softmax), blockDim.x / 32 rows a
// block; with TAP the row before the layer norm to `tap`.
template <int NV, int W, bool TAP>
__device__ __forceinline__ void rows_warp(const Chain& p, int norm,
                                          int softmax, float* tap) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  if (r >= p.M) return;
  const int N = p.N;
  float x[NV];
  warp_row<NV, W, TAP>(p, r, lane, norm, x, tap);
  if (softmax) {
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (lane + 32 * k < N) m = fmaxf(m, x[k]);
    m = warp_max(m);
#pragma unroll
    for (int k = 0; k < NV; ++k)
      x[k] = lane + 32 * k < N ? expf(__fsub_rn(x[k], m)) : 0.0f;
    const float s = row_sum<NV, W>(x, lane, N);
#pragma unroll
    for (int k = 0; k < NV; ++k) x[k] = __fdiv_rn(x[k], s);
  }
  const size_t row = out_row(p, r);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = lane + 32 * k;
    if (c < N) p.out[row + c] = x[k];
  }
}

template <int NV, int W>
__global__ void rows_warp_kernel(Chain p, int norm, int softmax) {
  rows_warp<NV, W, false>(p, norm, softmax, nullptr);
}

template <int NV, int W>
__global__ void rows_warp_tap_kernel(Chain p, int norm, int softmax,
                                     float* tap) {
  rows_warp<NV, W, true>(p, norm, softmax, tap);
}

// One block per sequence of `group` token rows: warp w computes rows w,
// w + warps, ... into shared memory, then each column is summed over
// the tokens in order (the first design's sum).
template <int NV, int W>
__global__ void seqmean_kernel(Chain p, int group, int norm) {
  extern __shared__ float rows[];          // [group][N]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32, N = p.N;
  const long long o = blockIdx.x;
  for (int t = warp; t < group; t += warps) {
    float x[NV];
    warp_row<NV, W>(p, o * group + t, lane, norm, x);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c < N) rows[t * N + c] = x[k];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < group; ++t) s = __fadd_rn(s, rows[t * N + c]);
    p.out[o * N + c] = __fdiv_rn(s, (float)group);
  }
}

// Block-wide reductions; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();                       // red[] free from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int k = 0; k < (int)(blockDim.x / 32); ++k) s += red[k];
  return s;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int k = 0; k < (int)(blockDim.x / 32); ++k) m = fmaxf(m, red[k]);
  return m;
}

// Rows longer than 1024: one block per output row; `group` input rows per
// output row (the sequence length for seq-mean, else 1).  Each thread
// owns columns tid, tid + blockDim.x, ... of the shared row, so only the
// reductions synchronise.  With TAP (group 1) the row before its layer
// norm to `tap`.
template <bool TAP>
__device__ __forceinline__ void rows_block(const Chain& p, int group,
                                           int norm, int softmax,
                                           int seqmean, float* tap) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  float* row = smem;
  float* acc = smem + p.N;
  const int N = p.N;
  const long long o = blockIdx.x;
  if (seqmean)
    for (int c = threadIdx.x; c < N; c += blockDim.x) acc[c] = 0.0f;
  for (int t = 0; t < group; ++t) {
    const long long r = o * group + t;
    const float scale = row_scale(p, r);
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      row[c] = chain(p, r * N + c, c, scale);
      if constexpr (TAP) tap[r * N + c] = row[c];
    }
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
        p.out[out_row(p, r) + c] = row[c];
    }
  }
  if (seqmean)
    for (int c = threadIdx.x; c < N; c += blockDim.x)
      p.out[o * N + c] = __fdiv_rn(acc[c], (float)group);
}

__global__ void rows_kernel(Chain p, int group, int norm, int softmax,
                            int seqmean) {
  rows_block<false>(p, group, norm, softmax, seqmean, nullptr);
}

__global__ void rows_tap_kernel(Chain p, int norm, int softmax, float* tap) {
  rows_block<true>(p, 1, norm, softmax, 0, tap);
}

constexpr int kThreads = 256;
constexpr int kRowWarps = 8;             // rows a block, seq-mean's warps
constexpr int kWarpRowMax = 1024;        // longest row a warp holds
constexpr int kSeqSmemMax = 200 * 1024;  // seq-mean's token rows, at most
constexpr long long kFill = 2 * 132;     // blocks that fill the H100

// (bx, by) for `groups` column groups: bx covers the groups (up to
// `threads`), by the rest of the block.
dim3 block_2d(int groups, int threads) {
  const int bx = groups < threads ? groups : threads;
  return dim3(bx, threads / bx > 0 ? threads / bx : 1);
}

unsigned clamp_y(long long blocks) {
  return (unsigned)(blocks < 1 ? 1 : (blocks > 65535 ? 65535 : blocks));
}

template <int V>
int launch_elementwise(const Chain& p, cudaStream_t s) {
  const int G = p.N / V;
  const dim3 block = block_2d(G, kThreads);
  const long long gx = (G + block.x - 1) / block.x;
  int rpt = 8;                 // rows a thread, while the blocks fill the card
  while (rpt > 1 &&
         gx * ((p.M + (long long)block.y * rpt - 1) / (block.y * rpt)) < kFill)
    rpt /= 2;
  const long long gy = (p.M + (long long)block.y * rpt - 1) / (block.y * rpt);
  elementwise_kernel<V><<<dim3((unsigned)gx, clamp_y(gy)), block, 0, s>>>(
      p, rpt);
  return (int)cudaGetLastError();
}

template <int V>
int launch_pool(const Chain& p, int pool, int window, int img_hw,
                cudaStream_t s) {
  const int G = p.N / V;
  const int oh = img_hw / window;
  const long long pixels = (long long)(p.M / (img_hw * img_hw)) * oh * oh;
  if (pixels > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // threads a block: as many as keep kFill blocks, from 32 to 256
  int threads = kThreads;
  while (threads > 32 && (long long)G * pixels / threads < kFill) threads /= 2;
  const dim3 block = block_2d(G, threads);
  const long long gx = (G + block.x - 1) / block.x;
  const long long gy = (pixels + block.y - 1) / block.y;
  pool_kernel<V><<<dim3((unsigned)gx, clamp_y(gy)), block, 0, s>>>(
      p, pool, window, img_hw, (int)pixels);
  return (int)cudaGetLastError();
}

template <int NV, int W>
int launch_rows(const Chain& p, int norm, int softmax, int seqmean,
                int window, float* tap, cudaStream_t s) {
  if (tap) {
    const long long blocks = ((long long)p.M + kRowWarps - 1) / kRowWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rows_warp_tap_kernel<NV, W><<<(unsigned)blocks, kRowWarps * 32, 0, s>>>(
        p, norm, softmax, tap);
  } else if (seqmean) {
    const int smem = window * p.N * (int)sizeof(float);
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          seqmean_kernel<NV, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSeqSmemMax);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    seqmean_kernel<NV, W><<<p.M / window, kRowWarps * 32, smem, s>>>(
        p, window, norm);
  } else {
    const long long blocks = ((long long)p.M + kRowWarps - 1) / kRowWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rows_warp_kernel<NV, W><<<(unsigned)blocks, kRowWarps * 32, 0, s>>>(
        p, norm, softmax);
  }
  return (int)cudaGetLastError();
}

// NV = 32-column chunks a lane holds; W = the first design's warps for N
// (64, 128 or 256 threads: N < 65, N < 256, else).
int dispatch_rows(const Chain& p, int norm, int softmax, int seqmean,
                  int window, float* tap, cudaStream_t s) {
  const int N = p.N;
  if (N <= 32)
    return launch_rows<1, 2>(p, norm, softmax, seqmean, window, tap, s);
  if (N <= 64)
    return launch_rows<2, 2>(p, norm, softmax, seqmean, window, tap, s);
  if (N <= 128)
    return launch_rows<4, 4>(p, norm, softmax, seqmean, window, tap, s);
  if (N < 256)
    return launch_rows<8, 4>(p, norm, softmax, seqmean, window, tap, s);
  if (N <= 256)
    return launch_rows<8, 8>(p, norm, softmax, seqmean, window, tap, s);
  if (N <= 512)
    return launch_rows<16, 8>(p, norm, softmax, seqmean, window, tap, s);
  return launch_rows<32, 8>(p, norm, softmax, seqmean, window, tap, s);
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the block-per-row path needs for N
// columns (the warp-per-row path needs none beyond seq-mean's token rows,
// which take the block-per-row path where they exceed kSeqSmemMax).
int fb_epilogue_rows_smem(int N, int seqmean) {
  return (int)(sizeof(float) * (size_t)N * (seqmean ? 2 : 1));
}

// pool: 0 none, 1 max, 2 avg, 3 seqmean.  bias / res / gamma / beta may be
// null.  M counts the rows of all slices; each slice of slice_rows rows
// has its own scale, and no pool window or sequence crosses a slice.
// heads > 0 (no pool; the slice count a multiple of it): out is (S /
// heads, slice_rows, heads * N), the heads merged.  tap, non-null (a
// layer norm, no pool, no heads): the rows before the norm, (M, N).
int fb_epilogue(const void* y, const void* scale, const void* bias,
                const void* res, const void* gamma, const void* beta,
                void* out, void* tap, int M, int N, int slice_rows, int act,
                float post_scale, int norm, int pool, int window, int img_hw,
                int softmax, int heads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (heads < 0 || (heads > 0 && (pool != POOL_NONE ||
                                  (M / slice_rows) % heads != 0)))
    return (int)cudaErrorInvalidValue;
  if (tap && (pool != POOL_NONE || heads > 0 || !norm))
    return (int)cudaErrorInvalidValue;
  Chain p{(const int32_t*)y, (const float*)scale, (const float*)bias,
          (const float*)res,  (const float*)gamma, (const float*)beta,
          (float*)out,        M,                   N,
          slice_rows,         act,                 post_scale,
          heads};
  // 16-byte accesses where every row starts on 16 bytes
  const bool vec = N % 4 == 0 && aligned16(y) && aligned16(bias) &&
                   aligned16(res) && aligned16(gamma) && aligned16(beta) &&
                   aligned16(out);
  if (pool == POOL_MAX || pool == POOL_AVG) {
    // 4 channels a thread only where that still fills the card: a pool
    // with few outputs (ResNet-18's last, 16 pixels a batch) runs one
    // channel a thread, four times the threads and a quarter of the
    // dependent chain each
    const long long outputs =
        (long long)(M / (img_hw * img_hw)) * (img_hw / window) *
        (img_hw / window) * N;
    return vec && outputs / 4 >= kFill * kThreads
               ? launch_pool<4>(p, pool, window, img_hw, s)
               : launch_pool<1>(p, pool, window, img_hw, s);
  }
  if (norm || softmax || pool == POOL_SEQMEAN) {
    const int seqmean = pool == POOL_SEQMEAN;
    float* t = (float*)tap;
    if (N <= kWarpRowMax &&
        (!seqmean || (long long)window * N * sizeof(float) <= kSeqSmemMax))
      return dispatch_rows(p, norm, softmax, seqmean, window, t, s);
    const int group = seqmean ? window : 1;
    const int smem = fb_epilogue_rows_smem(N, seqmean);
    if (smem > 48 * 1024) {
      const void* kernel = t ? (const void*)rows_tap_kernel
                             : (const void*)rows_kernel;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int row_threads = N >= 256 ? 256 : (N > 64 ? 128 : 64);
    if (t)
      rows_tap_kernel<<<M, row_threads, smem, s>>>(p, norm, softmax, t);
    else
      rows_kernel<<<M / group, row_threads, smem, s>>>(p, group, norm,
                                                       softmax, seqmean);
    return (int)cudaGetLastError();
  }
  return vec ? launch_elementwise<4>(p, s) : launch_elementwise<1>(p, s);
}

const char* fb_epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
