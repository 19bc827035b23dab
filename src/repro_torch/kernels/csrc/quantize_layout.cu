// Quantize a program stage's left operand straight into crossbar_gemm's
// kernel layout, for Hopper: float32 stage input -> (int8 (R, Kk), amax).
//
// Replaces no Pallas kernel.  Under `jax.jit` XLA fuses the JAX
// executor's chain into one pass over each stage's input: `im2col`
// (src/repro/program/execute.py:148), `quantize_symmetric` (:160,
// src/repro/core/crossbar.py:204-209) and the zero pad to full mounts
// (:164).  Run as PyTorch ops, the same chain was about ten passes over a
// float32 patch matrix of up to 9x the input; this file is its fusion.
//
// What it computes, per call (one C entry, one memset and two kernels):
//
//   amax  = max |x| over exactly the elements the reference's patch
//           matrix holds (conv: the pixels some patch reads; a 1x1
//           stride-2 conv reads only even rows and columns, and the
//           largest |x| may sit on an odd one); the zero pad of a conv
//           cannot raise a maximum of |x| and is skipped;
//   scale = max(amax, 1e-8) * f32(1/qmax)   (quantize_scale's expression)
//   x8    = clamp(rint(x / scale), -qmax-1, qmax), x / scale a correctly
//           rounded division (__fdiv_rn: the reference's true division,
//           not a multiply by 1/scale), rint rounding half to even as
//           torch.round and jnp.round do;
//
// written into the kernel layout that `crossbar_gemm` takes: source
// column j of K goes to column j on the exact branch (Kk = up32(K)), to
// (j / rows) * R32 + j % rows on the sliced branch (Kk = chunks * R32,
// R32 = up32(rows)); every other column is 0.  Both results are bit for
// bit the plain version's (`quantize_layout_ref`).
//
// Two gather modes, the same arithmetic:
//   conv:    x NHWC (any strides) read through (k, stride, pad): row
//            (n, oh, ow), column (c, kh, kw), the patch order of
//            conv_general_dilated_patches that pack_weight matches;
//   strided: x an (A, B, R, k) view (any strides): the fc flatten, the
//            sequence stages' tokens, attention's per-(batch, head) left
//            operands (the Q view out of the fused projection is
//            permuted, and is read as it lies).  One amax per (a, b)
//            slice, or one for the whole view.
//
// Design (correct first): pass 1 reduces |x| block by block (warp
// shuffles, then shared memory) and meets the other blocks through one
// atomicMax on the int bits per block: non-negative floats order as
// their bits do, so the result is exact and independent of order.  The
// amax buffer is zeroed by a memset on the same stream first.  Pass 2
// gives each thread 16 consecutive output columns of one row: it reads
// amax, forms the scale, gathers, quantizes and stores one 16-byte word.
// Nothing is allocated here and nothing synchronizes, so a CUDA graph
// captures the call.
//
// What bounds it on the H100: bytes.  It reads the covered input once
// per pass and writes the int8 operand once; the bound counts one read
// and one write (some 41 us per ResNet-18 batch-16 forward at 3.35 TB/s).
// This design runs about 11x that: the conv gather reads 4-byte words C
// apart across a warp's lanes (one sector a lane) and quantizes each
// element once per tap.  Two shared-memory designs of pass 2 (whole
// operand rows built in shared memory; a quantized input window per run
// of output pixels) were slower on the card, at batch 1 by launching too
// few blocks.  The stores are whole 16-byte words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 16;                 // output columns (bytes) a thread
constexpr int UNROLL = 4;             // pass 1's loads in flight a thread
constexpr int ELEMS_PER_BLOCK = THREADS * UNROLL;   // pass 1, per block
constexpr int MAX_BLOCKS = 2048;      // pass 1's blocks over all slices
// elements of x, and threads of pass 2, are indexed in 32 bits
constexpr long long INDEX_LIMIT = 1LL << 31;

struct Layout {
  int kc;        // source columns (the operand's K before padding)
  int kk;        // columns of the kernel layout
  int rows;      // ADC chunk height (sliced branch)
  int r32;       // the chunk's height in the layout, up32(rows)
  int exact;     // 1: exact branch, columns as they are
};

struct Quant {
  const float* amax;
  int qmax;
  float inv_qmax;
};

// Element offsets into x stay below 2^31 (the wrapper checks), so strides
// and offsets are 32-bit.
struct Conv {
  const float* x;
  int sn, sh, sw, sc;           // element strides of NHWC
  int N, H, W, C, k, stride, pad, OH, OW;
};

struct Strided {
  const float* x;
  int sa, sb, sr, sk;           // element strides of (A, B, R, k)
  int A, B, R, per_slice;
};

// Walks a thread's V consecutive output columns from o0: `j` is the
// source column of the current one where `valid()`.  On the sliced
// branch column o sits `within` its chunk of r32; past `rows` it is the
// chunk's zero gap, and j waits there at the next chunk's first column.
struct Cols {
  int j, within;
  __device__ __forceinline__ Cols(int o0, const Layout& L) {
    const int chunk = L.exact ? 0 : o0 / L.r32;
    within = L.exact ? 0 : o0 - chunk * L.r32;
    j = L.exact ? o0 : chunk * L.rows + min(within, L.rows);
  }
  __device__ __forceinline__ bool valid(const Layout& L) const {
    return j < L.kc && (L.exact || within < L.rows);
  }
  // advance one output column; true where the source column moved on
  __device__ __forceinline__ bool next(const Layout& L) {
    if (L.exact) { ++j; return true; }
    const bool moved = within < L.rows;
    j += moved;
    if (++within == L.r32) within = 0;
    return moved;
  }
};

// The scale and its correctly rounded reciprocal.
struct Scale {
  float s, inv;
  __device__ __forceinline__ Scale(const Quant& q, int slice) {
    s = __fmul_rn(fmaxf(q.amax[slice], 1e-8f), q.inv_qmax);
    inv = __frcp_rn(s);
  }
};

// clamp(rint(v / s), -qmax-1, qmax) with v / s the correctly rounded
// quotient, as the reference computes it.  The true division is some 20
// instructions; what decides the result is only which integer the
// quotient rounds to.  qt = v * rn(1/s) is within 3 * 2^-24 |v/s| of the
// exact v/s, and the correctly rounded quotient within 2^-24 |v/s|, so
// the two lie within 2^-22 |qt| of each other and round (half to even) to
// the same integer unless a half-integer lies that close to qt.  Where qt
// is within 2^-20 |qt| of one (a 4x margin; about one element in 10^4,
// and exact ties), the true division decides.  |qt| is at most about
// qmax, so floorf's subtraction below is exact.
__device__ __forceinline__ int8_t quantize(float v, const Scale& sc,
                                          int qmax) {
  const float qt = __fmul_rn(v, sc.inv);
  const float off_half = fabsf(qt - floorf(qt) - 0.5f);
  int r = off_half > fabsf(qt) * 0x1p-20f
              ? __float2int_rn(qt)
              : __float2int_rn(__fdiv_rn(v, sc.s));   // rint, half to even
  r = min(max(r, -qmax - 1), qmax);
  return static_cast<int8_t>(r);
}

// True iff input row (or column) t is read by some window: some output
// o in [0, n_out) and tap d in [0, k) with o * stride - pad + d == t.
__device__ __forceinline__ bool covered(int t, int k, int stride, int pad,
                                        int n_out) {
  const int u = t + pad;                 // >= 0
  const int lo = u - k + 1 <= 0 ? 0 : (u - k + stride) / stride;
  const int hi = min(n_out - 1, u / stride);
  return lo <= hi;
}

// Block-wide max of non-negative v, folded into *dst by one atomicMax.
__device__ __forceinline__ void block_max_to(float v, float* dst) {
  __shared__ float warp_max[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(dst), __float_as_int(v));
  }
}

// ---- pass 1: amax ------------------------------------------------------

// x's elements (fewer than 2^31, the C entry checks) in NHWC order, 32-bit
// index arithmetic; a pixel no window reads is skipped
__global__ void __launch_bounds__(THREADS)
amax_conv_kernel(Conv g, float* amax) {
  const unsigned total = (unsigned)g.N * g.H * g.W * g.C;
  float m = 0.0f;
  for (unsigned base = blockIdx.x * THREADS * UNROLL + threadIdx.x;
       base < total; base += gridDim.x * THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {      // independent loads in flight
      const unsigned i = base + u * THREADS;
      const unsigned pix = i / g.C, c = i - pix * g.C;
      const unsigned nh = pix / g.W, w = pix - nh * g.W;
      const unsigned n = nh / g.H, h = nh - n * g.H;
      v[u] = i < total && covered(h, g.k, g.stride, g.pad, g.OH) &&
                     covered(w, g.k, g.stride, g.pad, g.OW)
                 ? fabsf(g.x[n * g.sn + h * g.sh + w * g.sw + c * g.sc])
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = fmaxf(m, v[u]);
  }
  block_max_to(m, amax);
}

// gridDim.y = A * B slices; blockIdx.x walks one slice's R * k elements
__global__ void __launch_bounds__(THREADS)
amax_strided_kernel(Strided g, int kc, float* amax) {
  const int slice = blockIdx.y;
  const int a = slice / g.B, b = slice - (slice / g.B) * g.B;
  const float* x = g.x + a * g.sa + b * g.sb;
  const unsigned total = (unsigned)g.R * kc;     // < 2^31, checked
  float m = 0.0f;
  for (unsigned base = blockIdx.x * THREADS * UNROLL + threadIdx.x;
       base < total; base += gridDim.x * THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = base + u * THREADS, r = i / kc, j = i - r * kc;
      v[u] = i < total ? fabsf(x[r * g.sr + j * g.sk]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = fmaxf(m, v[u]);
  }
  block_max_to(m, amax + (g.per_slice ? slice : 0));
}

// ---- pass 2: quantize into the layout ----------------------------------

__device__ __forceinline__ void store16(int8_t* dst, const int8_t (&v)[V]) {
  uint4 word;
  uint32_t* w = reinterpret_cast<uint32_t*>(&word);
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    w[i] = (uint32_t)(uint8_t)v[4 * i] |
           ((uint32_t)(uint8_t)v[4 * i + 1] << 8) |
           ((uint32_t)(uint8_t)v[4 * i + 2] << 16) |
           ((uint32_t)(uint8_t)v[4 * i + 3] << 24);
  *reinterpret_cast<uint4*>(dst) = word;
}

// A thread per 16 output columns of one patch row (fewer than 2^31
// threads, the C entry checks); the column's (c, kh, kw) is decoded once
// and stepped after.
__global__ void __launch_bounds__(THREADS)
quantize_conv_kernel(Conv g, Layout L, Quant q, int8_t* out) {
  const unsigned groups = L.kk / V;
  const unsigned total = (unsigned)g.N * g.OH * g.OW * groups;
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const unsigned row = t / groups;
  const int o0 = (int)(t - row * groups) * V;
  const unsigned pix = g.OH * g.OW;
  const unsigned n = row / pix, rem = row - n * pix;
  const int oh = rem / g.OW, ow = rem - oh * g.OW;
  const int h0 = oh * g.stride - g.pad, w0 = ow * g.stride - g.pad;
  const Scale scale(q, 0);
  const float* x = g.x + n * g.sn;
  Cols col(o0, L);
  const int kk2 = g.k * g.k;
  int c = col.j / kk2;
  int kh = (col.j - c * kk2) / g.k;
  int kw = col.j - c * kk2 - kh * g.k;
  int8_t v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    int8_t r = 0;
    const int h = h0 + kh, w = w0 + kw;
    if (col.valid(L) && h >= 0 && h < g.H && w >= 0 && w < g.W)
      r = quantize(x[h * g.sh + w * g.sw + c * g.sc], scale, q.qmax);
    v[i] = r;
    if (col.next(L) && ++kw == g.k) {
      kw = 0;
      if (++kh == g.k) { kh = 0; ++c; }
    }
  }
  store16(out + (size_t)row * L.kk + o0, v);
}

__global__ void __launch_bounds__(THREADS)
quantize_strided_kernel(Strided g, Layout L, Quant q, int8_t* out) {
  const unsigned groups = L.kk / V;
  const unsigned total = (unsigned)g.A * g.B * g.R * groups;
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const unsigned row = t / groups;              // over all slices
  const int o0 = (int)(t - row * groups) * V;
  const unsigned slice = row / g.R, r = row - slice * g.R;
  const unsigned a = slice / g.B, b = slice - a * g.B;
  const Scale scale(q, g.per_slice ? slice : 0);
  const float* x = g.x + a * g.sa + b * g.sb + r * g.sr;
  Cols col(o0, L);
  int8_t v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = col.valid(L) ? quantize(x[col.j * g.sk], scale, q.qmax)
                        : (int8_t)0;
    col.next(L);
  }
  store16(out + (size_t)row * L.kk + o0, v);
}

int blocks_for(long long work, long long per_block, long long cap) {
  long long b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

bool layout_ok(const Layout& L, const void* out) {
  return L.kk > 0 && L.kk % V == 0 && L.kc <= L.kk &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
         (L.exact || (L.rows > 0 && L.r32 % 32 == 0 && L.r32 >= L.rows));
}

}  // namespace

extern "C" {

// x NHWC float32 with element strides (sn, sh, sw, sc), every element's
// offset below 2^31; out (N*OH*OW, kk) int8, 16-byte aligned; amax one
// float32.  Returns cudaGetLastError().
int quantize_layout_conv(const void* x, void* out, void* amax, int N, int H,
                         int W, int C, int sn, int sh, int sw, int sc,
                         int k, int stride,
                         int pad, int OH, int OW, int kc, int kk, int rows,
                         int r32, int exact, int qmax, float inv_qmax,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L{kc, kk, rows, r32, exact};
  if (!layout_ok(L, out) || kc != C * k * k) return (int)cudaErrorInvalidValue;
  const Conv g{(const float*)x, sn, sh, sw, sc, N, H, W, C, k, stride, pad,
               OH, OW};
  const Quant q{(const float*)amax, qmax, inv_qmax};
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const long long elems = (long long)N * H * W * C;
  const long long threads = (long long)N * OH * OW * (kk / V);
  if (elems >= INDEX_LIMIT || threads >= INDEX_LIMIT)
    return (int)cudaErrorInvalidValue;
  amax_conv_kernel<<<blocks_for(elems, ELEMS_PER_BLOCK, MAX_BLOCKS), THREADS,
                     0, s>>>(g, (float*)amax);
  quantize_conv_kernel<<<blocks_for(threads, THREADS, INDEX_LIMIT), THREADS,
                         0, s>>>(g, L, q, (int8_t*)out);
  return (int)cudaGetLastError();
}

// x an (A, B, R, kc) float32 view with element strides (sa, sb, sr, sk),
// every element's offset below 2^31; out (A*B*R, kk) int8, 16-byte
// aligned; amax A*B floats (per_slice) or one.  Returns
// cudaGetLastError().
int quantize_layout_strided(const void* x, void* out, void* amax, int A,
                            int B, int R, int kc, int sa, int sb, int sr,
                            int sk, int per_slice,
                            int kk, int rows, int r32, int exact, int qmax,
                            float inv_qmax, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L{kc, kk, rows, r32, exact};
  const int slices = A * B;
  if (!layout_ok(L, out) || slices > 65535) return (int)cudaErrorInvalidValue;
  const Strided g{(const float*)x, sa, sb, sr, sk, A, B, R, per_slice};
  const Quant q{(const float*)amax, qmax, inv_qmax};
  cudaError_t err = cudaMemsetAsync(
      amax, 0, sizeof(float) * (per_slice ? slices : 1), s);
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)slices * R * (kk / V);
  if ((long long)R * kc >= INDEX_LIMIT || threads >= INDEX_LIMIT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid1(blocks_for((long long)R * kc, ELEMS_PER_BLOCK,
                              MAX_BLOCKS / slices > 1 ? MAX_BLOCKS / slices
                                                      : 1),
                   slices);
  amax_strided_kernel<<<grid1, THREADS, 0, s>>>(g, kc, (float*)amax);
  quantize_strided_kernel<<<blocks_for(threads, THREADS, INDEX_LIMIT),
                            THREADS, 0, s>>>(g, L, q, (int8_t*)out);
  return (int)cudaGetLastError();
}

const char* quantize_layout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
