// Flash attention for Hopper: online-softmax attention, paper Eq. 1.
//
// Replaces the Pallas kernel `flash_attention` (`_attn_kernel`) of
// src/repro/kernels/flash_attention.py.  q (B, Sq, H, hd), k and v
// (B, Sk, H, hd) -> out (B, Sq, H, hd), float or bf16, read and written
// in that layout (no transposes).  Per query row, over the key tiles it
// can see:
//
//   s = (q * sm_scale) . k           masked keys -> -1e30
//   m' = max(m, max s);  alpha = exp(m - m');  p = exp(s - m')
//   l = l * alpha + sum p;  acc = acc * alpha + p @ v;  m = m'
//   out = acc / max(l, 1e-30), cast to q's type
//
// with m starting at -1e30, as the JAX kernel does (so exp(-1e30 - m)
// is 0 once a row has seen a real key, and a masked prefix seen before
// that is wiped by the next alpha).  Keys past Sk (a ragged last tile)
// are left out of the max and get p = 0 outright.  The key range of a block is cut as JAX cuts its
// k-blocks: up to the block's last query under a causal mask, from its
// first query minus the window under a sliding window.
//
// Layout: one block of 4 warps per (b*h, 16-query tile); each warp owns
// 4 query rows.  The block stages the scaled queries and 32-key tiles of
// K and V in shared memory as float (bf16 converted on load; K rows
// padded by one word so the 32 lanes read 32 banks).  For scores, lane j
// takes key j of the tile and computes its dot product with each of the
// warp's 4 rows; the row max and sum are warp shuffles.  For p @ v, lane
// j owns dims j, j+32, ... (up to hd = 128) and each key's p comes from
// its lane by shuffle.  Running max, sum and the accumulator stay in
// registers.
//
// What bounds it on the H100: at the shapes it runs (vit_tiny's 64
// tokens of hd 64; 256-512 tokens in the tests) the 4*S^2*hd float
// operations per (b, h), on the CUDA cores from shared memory: each score
// reads a K and a Q word per product.  Tensor-core tiles (wgmma on bf16)
// and a K/V ring fed by TMA are the later steps.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_io.cuh"

namespace {

constexpr int HD_MAX = 128;
constexpr int WARPS = 4;
constexpr int ROWS = 4;                   // query rows per warp
constexpr int BQ = WARPS * ROWS;          // query rows per block
constexpr int BKEY = 32;                  // keys per tile: one per lane
constexpr int DPL = HD_MAX / 32;          // dims per lane in p @ v
constexpr float kMasked = -1e30f;

using float_io::from_f32;
using float_io::to_f32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
            int Sk, int hd, float sm_scale, int causal, int window,
            int q_tiles) {
  __shared__ float Qs[BQ][HD_MAX];
  __shared__ float Ks[BKEY][HD_MAX + 1];
  __shared__ float Vs[BKEY][HD_MAX];
  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = qt * BQ;
  const size_t row_stride = (size_t)H * hd;      // between sequence positions
  const T* qb = q + ((size_t)b * Sq * H + h) * hd;
  const T* kb = k + ((size_t)b * Sk * H + h) * hd;
  const T* vb = v + ((size_t)b * Sk * H + h) * hd;

  for (int e = tid; e < BQ * hd; e += WARPS * 32) {
    const int r = e / hd, d = e % hd;
    Qs[r][d] = q0 + r < Sq
                   ? __fmul_rn(to_f32(qb[(q0 + r) * row_stride + d]), sm_scale)
                   : 0.0f;
  }

  // the keys this block's queries can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) / BKEY * BKEY : 0;

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = lo; k0 < hi; k0 += BKEY) {
    __syncthreads();                              // the last tile is read
    for (int e = tid; e < BKEY * hd; e += WARPS * 32) {
      const int r = e / hd, d = e % hd;
      const bool in = k0 + r < Sk;
      Ks[r][d] = in ? to_f32(kb[(k0 + r) * row_stride + d]) : 0.0f;
      Vs[r][d] = in ? to_f32(vb[(k0 + r) * row_stride + d]) : 0.0f;
    }
    __syncthreads();
    const int key = k0 + lane;
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float kd = Ks[lane][d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        s[i] = fmaf(Qs[warp * ROWS + i][d], kd, s[i]);
    }
    float p[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + warp * ROWS + i;
      bool seen = true;
      if (causal) seen = seen && key <= qpos;
      if (window > 0) seen = seen && key > qpos - window;
      // a key past Sk (ragged last tile) is no key: it must not lift the
      // max (its zero score would) and its p is 0, not exp(-1e30 - m)
      const float si = seen && key < Sk ? s[i] : kMasked;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float alpha = expf(m[i] - m_new);
      p[i] = key < Sk ? expf(si - m_new) : 0.0f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
    }
    for (int jj = 0; jj < BKEY; ++jj) {
      float vd[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        vd[j] = d < hd ? Vs[jj][d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], jj);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(pj, vd[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + warp * ROWS + i;
    if (qpos >= Sq) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)b * Sq * H + h) * hd + qpos * row_stride;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) o[d] = from_f32<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int hd, float sm_scale, int causal,
           int window, cudaStream_t s) {
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const long long blocks = (long long)B * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attn_kernel<T><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Sq, Sk, hd, sm_scale,
      causal, window, q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, H, hd), out like q; dtype 0 float,
// 1 bf16; hd <= 128.  window 0: none.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int H, int hd, float sm_scale,
                    int causal, int window, int dtype, void* stream) {
  if (hd < 1 || hd > HD_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, hd, sm_scale,
                                 causal, window, s);
  return launch<float>(q, k, v, out, B, Sq, Sk, H, hd, sm_scale, causal,
                       window, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
