// Flash attention for Hopper: online-softmax attention, paper Eq. 1, on
// the tensor cores, with a key split where the blocks would leave SMs idle.
//
// Replaces the Pallas kernel `flash_attention` (`_attn_kernel`) of
// src/repro/kernels/flash_attention.py.  q (B, Sq, H, hd), k and v
// (B, Sk, H, hd) -> out (B, Sq, H, hd), float or bf16, read and written
// in that layout (no transposes).  Per query row, over the key tiles it
// can see:
//
//   s = (q . k) * sm_scale           masked keys -> -1e30
//   m' = max(m, max s);  alpha = exp(m - m');  p = exp(s - m')
//   l = l * alpha + sum p;  acc = acc * alpha + p @ v;  m = m'
//   out = acc / max(l, 1e-30), cast to q's type
//
// with m starting at -1e30, as the JAX kernel does (so exp(-1e30 - m)
// is 0 once a row has seen a real key, and a masked prefix seen before
// that is wiped by the next alpha).  Keys past Sk (a ragged last tile)
// are left out of the max and get p = 0 outright.  The key range of a
// block is cut as JAX cuts its k-blocks: up to the block's last query
// under a causal mask, from its first query minus the window under a
// sliding window.
//
// What bounds it on the H100.  At the shapes it runs (the attention
// path's (1, T, 4, 16), vit_tiny's (16, 64, 3, 64), (1, 512, 4, 64) in
// the benches) the 4*Sq*Sk*hd operations per (b, h) are a few hundred
// MFLOP at most: microseconds on the tensor cores.  What held the first
// design back was everything around them: scores on the CUDA cores at
// one shared-memory load per FMA, p @ v lanes idle at small head dims,
// copies not overlapped with compute, 40 KB of shared memory at every
// head dim, and too few blocks (128 4-warp blocks at (1, 512, 4, 64)).
// So the kernel is latency-bound, and the design cuts the latency:
//
// * The products on the tensor cores with mma.sync.  Each warp owns 16
//   query rows; scores are m16n8 tiles, p stays in registers and feeds
//   the second product as its A operand (the score tile's accumulator
//   layout is the A layout for bf16; for tf32 the 8 keys of a tile are
//   permuted, and V's rows are read in the same permuted order).
//   - bf16: m16n8k16 bf16 for both products, f32 accumulation; p goes to
//     bf16 only for p @ v.  Held to the bf16 cases' 2e-2.
//   - float32 must meet its cases' 1e-4, also where scores near -1000
//     make the softmax ill-conditioned (tests/test_torch_cuda.py's
//     `negative` case: there a 1e-4 change of a score moves the output by
//     3e-4).  So the scores are a register-tiled FMA chain over d in
//     order on q * sm_scale, the first design's rounding (and the plain
//     version's, whose product sums in the same order): each thread
//     holds its 32 scores of the m16n8 layout and reads 16 bytes of
//     shared memory per 8 FMAs.  3xTF32 scores (each operand split into
//     a tf32 high part and the tf32 rounding of the rest, three m16n8k8
//     products) came within 1e-6 of the plain version on random inputs
//     but 3e-4 off on the negative case, so they are not used.  p @ v
//     runs in 3xTF32 on m16n8k8, each tile's products summed in fresh
//     accumulators and added in round-to-nearest (the tensor cores' own
//     accumulation of a long sum rounds coarser than float32 FMAs); the
//     measured errors are in PERF.md.
// * The head dim is a template parameter (16, 32, 64, 128; the smallest
//   that fits hd): shared memory and the fragments are sized to it.
// * A two-deep K/V ring fed by 16-byte cp.async (zero-filled past Sk):
//   tile t+1 is in flight while tile t is multiplied.  Rows that are not
//   16-byte aligned (hd * sizeof(T) % 16 != 0) load synchronously.
// * A key split where B*H*q_tiles blocks would leave SMs idle: block z
//   takes the z-th contiguous share of the key tiles its queries can
//   see and writes its (m, l, acc) to scratch; `merge_kernel` combines
//   the shares in a fixed order, so the output is the same from run to
//   run.  The split count depends on the shape only
//   (flash_attention.py:key_splits); the shares (key_share below) are
//   mirrored by flash_attention.py:key_ranges.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_io.cuh"

namespace {

constexpr float kMasked = -1e30f;

using float_io::from_f32;

template <typename T, int HD>
struct Cfg {
  static constexpr int BK = HD >= 128 ? 32 : 64;            // keys a tile
  // shared row stride in elements: rows 16-byte aligned, fragment reads
  // on 32 distinct banks
  static constexpr int LDS = HD + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int CHUNK = 16 / sizeof(T);              // per cp.async
};

// -- the key tiles a block's queries can see, and the block's share ---------

struct Range {
  int lo, hi;      // keys [lo, hi) of the block's share, tile aligned at lo
  int count;       // shares of this q tile (blocks with z >= count exit)
};

__device__ __forceinline__ Range key_share(int q0, int bq, int Sq, int Sk,
                                           int bk, int causal, int window,
                                           int splits, int z) {
  const int q_last = min(q0 + bq, Sq) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) / bk * bk : 0;
  const int t_lo = lo / bk;
  const int n = hi > lo ? (hi - lo + bk - 1) / bk : 0;
  Range r;
  r.count = n > 0 ? min(splits, n) : 1;
  if (n <= 0) {
    r.lo = r.hi = lo;
    return r;
  }
  r.lo = (t_lo + (int)((long long)z * n / r.count)) * bk;
  r.hi = min(hi, (t_lo + (int)((long long)(z + 1) * n / r.count)) * bk);
  return r;
}

// -- mma.sync helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the small products first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, rows) of a (rows, LDS) shared tile from sequence positions
// pos0.. of one (b, h): rows past `valid` (and dims past hd) are zero
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows,
                                          int valid, size_t row_stride,
                                          int hd, bool vec) {
  using C = Cfg<T, HD>;
  const int nthr = blockDim.x;
  if (vec) {
    const int per_row = hd / C::CHUNK;
    for (int e = threadIdx.x; e < rows * per_row; e += nthr) {
      const int r = e / per_row, c = (e % per_row) * C::CHUNK;
      const bool in = r < valid;
      cp_async16(dst + r * C::LDS + c, in ? src + r * row_stride + c : src,
                 in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * hd; e += nthr) {
      const int r = e / hd, d = e % hd;
      dst[r * C::LDS + d] = r < valid ? src[r * row_stride + d]
                                      : from_f32<T>(0.0f);
    }
  }
}

// Scores of the warp's 16 rows against the BK keys of a tile: s[nt][e]
// holds row g (e < 2) or g + 8, key nt*8 + 2t + (e & 1), the layout of
// an m16n8 accumulator.  float32: a register-tiled FMA chain over d in
// order on the pre-scaled queries, the first design's (and the plain
// version's) rounding; each thread reads 16 bytes of shared memory per
// 8 FMAs.
template <int HD>
__device__ __forceinline__ void scores(float (*s)[4], const float* Q,
                                       const float* K, int g, int t) {
  constexpr int BK = Cfg<float, HD>::BK, LDS = Cfg<float, HD>::LDS;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll 4
  for (int d0 = 0; d0 < HD; d0 += 4) {
    const float4 qa = *reinterpret_cast<const float4*>(Q + g * LDS + d0);
    const float4 qb =
        *reinterpret_cast<const float4*>(Q + (g + 8) * LDS + d0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float* kr = K + (nt * 8 + 2 * t) * LDS + d0;
      const float4 ka = *reinterpret_cast<const float4*>(kr);
      const float4 kb = *reinterpret_cast<const float4*>(kr + LDS);
      const float qv[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                              {qb.x, qb.y, qb.z, qb.w}};
      const float kv[2][4] = {{ka.x, ka.y, ka.z, ka.w},
                              {kb.x, kb.y, kb.z, kb.w}};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[nt][e] = __fmaf_rn(qv[e >> 1][j], kv[e & 1][j], s[nt][e]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void scores(float (*s)[4], const __nv_bfloat16* Q,
                                       const __nv_bfloat16* K, int g, int t) {
  constexpr int BK = Cfg<__nv_bfloat16, HD>::BK;
  constexpr int LDS = Cfg<__nv_bfloat16, HD>::LDS;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 16) {
    uint32_t a[4];
    a[0] = lds32(Q + g * LDS + k0 + 2 * t);
    a[1] = lds32(Q + (g + 8) * LDS + k0 + 2 * t);
    a[2] = lds32(Q + g * LDS + k0 + 2 * t + 8);
    a[3] = lds32(Q + (g + 8) * LDS + k0 + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const __nv_bfloat16* kr = K + (nt * 8 + g) * LDS + k0 + 2 * t;
      const uint32_t b[2] = {lds32(kr), lds32(kr + 8)};
      mma_bf16(s[nt], a, b);
    }
  }
}

// acc[dn][e] (row g / g + 8, dim dn*8 + 2t + (e & 1)) += p @ V.
template <int HD>
__device__ __forceinline__ void pv(float (*acc)[4], const float (*p)[4],
                                   const float* V, int g, int t, int lane) {
  constexpr int BK = Cfg<float, HD>::BK, LDS = Cfg<float, HD>::LDS;
  // the tile's products in fresh accumulators, added to acc in
  // round-to-nearest once per tile
  float part[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[dn][e] = 0.0f;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    // A's column t is key 2t of the tile, column t + 4 key 2t + 1: the
    // keys this thread holds.  V's rows are read in the same order.
    uint32_t ah[4], al[4];
    split_tf32(p[nt][0], ah[0], al[0]);
    split_tf32(p[nt][2], ah[1], al[1]);
    split_tf32(p[nt][1], ah[2], al[2]);
    split_tf32(p[nt][3], ah[3], al[3]);
    const float* v0 = V + (nt * 8 + 2 * t) * LDS + g;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      uint32_t bh[2], bl[2];
      split_tf32(v0[dn * 8], bh[0], bl[0]);
      split_tf32(v0[LDS + dn * 8], bh[1], bl[1]);
      mma_3xtf32(part[dn], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = __fadd_rn(acc[dn][e], part[dn][e]);
}

template <int HD>
__device__ __forceinline__ void pv(float (*acc)[4], const float (*p)[4],
                                   const __nv_bfloat16* V, int g, int t,
                                   int lane) {
  constexpr int BK = Cfg<__nv_bfloat16, HD>::BK;
  constexpr int LDS = Cfg<__nv_bfloat16, HD>::LDS;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    // the score tiles 2j and 2j+1 are the A fragment of keys 16j..16j+15
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    // lanes 0-15 point at keys 16j + (lane & 15); .trans hands each
    // thread the (key 2t, 2t+1; dim g) pairs of B
    const unsigned row = (unsigned)__cvta_generic_to_shared(
        V + (16 * j + (lane & 15)) * LDS);
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      uint32_t b[2];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(b[0]), "=r"(b[1])
          : "r"(row + dn * 16));
      mma_bf16(acc[dn], a, b);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part_acc;   // (splits, B*H, Sq, hd) when splits > 1
  float* part_ml;    // (splits, B*H, Sq, 2)
  int H, Sq, Sk, hd, bq, causal, window, splits, vec;
  float sm_scale;
};

template <typename T, int HD>
__global__ void attn_kernel(Args a) {
  using C = Cfg<T, HD>;
  constexpr int BK = C::BK, LDS = C::LDS, NT = BK / 8, DN = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + a.bq * LDS;                 // [2][BK][LDS]
  T* Vs = Ks + 2 * BK * LDS;               // [2][BK][LDS]

  const int qt = blockIdx.x, bh = blockIdx.y, z = blockIdx.z;
  const int q0 = qt * a.bq;
  const Range r = key_share(q0, a.bq, a.Sq, a.Sk, BK, a.causal, a.window,
                            a.splits, z);
  if (z >= r.count) return;                // the whole block
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const size_t row_stride = (size_t)a.H * a.hd;
  const T* qb = (const T*)a.q + ((size_t)b * a.Sq * a.H + h) * a.hd;
  const T* kb = (const T*)a.k + ((size_t)b * a.Sk * a.H + h) * a.hd;
  const T* vb = (const T*)a.v + ((size_t)b * a.Sk * a.H + h) * a.hd;

  if (a.hd < HD) {        // dims hd..HD enter the products: zero them once
    for (int e = tid; e < (a.bq + 4 * BK) * LDS; e += blockDim.x)
      Qs[e] = from_f32<T>(0.0f);
    __syncthreads();
  }
  const int n_tiles = (r.hi - r.lo + BK - 1) / BK;
  load_rows<T, HD>(Qs, qb + (size_t)q0 * row_stride, a.bq, a.Sq - q0,
                   row_stride, a.hd, a.vec);
  if (n_tiles > 0) {
    load_rows<T, HD>(Ks, kb + (size_t)r.lo * row_stride, BK, a.Sk - r.lo,
                     row_stride, a.hd, a.vec);
    load_rows<T, HD>(Vs, vb + (size_t)r.lo * row_stride, BK, a.Sk - r.lo,
                     row_stride, a.hd, a.vec);
  }
  cp_commit();

  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;
  const int row0 = warp * 16;
  const int qpos[2] = {q0 + row0 + g, q0 + row0 + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = r.lo + it * BK;
    if (it + 1 < n_tiles) {
      const int k1 = k0 + BK, buf = (it + 1) & 1;
      load_rows<T, HD>(Ks + buf * BK * LDS, kb + (size_t)k1 * row_stride, BK,
                       a.Sk - k1, row_stride, a.hd, a.vec);
      load_rows<T, HD>(Vs + buf * BK * LDS, vb + (size_t)k1 * row_stride, BK,
                       a.Sk - k1, row_stride, a.hd, a.vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if constexpr (sizeof(T) == 4) {
      if (it == 0) {          // the queries have landed: q * sm_scale
        for (int e = tid; e < a.bq * LDS; e += blockDim.x)
          Qs[e] = __fmul_rn(Qs[e], a.sm_scale);
        __syncthreads();
      }
    }
    const T* Kt = Ks + (it & 1) * BK * LDS;
    const T* Vt = Vs + (it & 1) * BK * LDS;
    float s[NT][4];
    scores<HD>(s, Qs + row0 * LDS, Kt, g, t);

    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1), i = e >> 1;
        bool seen = true;
        if (a.causal) seen = seen && key <= qpos[i];
        if (a.window > 0) seen = seen && key > qpos[i] - a.window;
        // a key past Sk is no key: it must not lift the max
        const float si = sizeof(T) == 4 ? s[nt][e] : s[nt][e] * a.sm_scale;
        s[nt][e] = seen && key < a.Sk ? si : kMasked;
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1), i = e >> 1;
        const float p = key < a.Sk ? expf(s[nt][e] - m[i]) : 0.0f;
        s[nt][e] = p;
        l[i] += p;           // this thread's share; the quad sums at the end
      }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    pv<HD>(acc, s, Vt, g, t, lane);
    __syncthreads();                     // the buffer is free to refill
  }

  const size_t BH = gridDim.y;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (qpos[i] >= a.Sq) continue;
    if (a.splits > 1) {
      const size_t row = ((size_t)z * BH + bh) * a.Sq + qpos[i];
      float* o = a.part_acc + row * a.hd;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = dn * 8 + 2 * t + c;
          if (d < a.hd) o[d] = acc[dn][2 * i + c];
        }
      if (t == 0) {
        a.part_ml[2 * row] = m[i];
        a.part_ml[2 * row + 1] = li;
      }
    } else {
      const float inv_l = 1.0f / fmaxf(li, 1e-30f);
      T* o = (T*)a.out + ((size_t)b * a.Sq + qpos[i]) * row_stride +
             (size_t)h * a.hd;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = dn * 8 + 2 * t + c;
          if (d < a.hd) o[d] = from_f32<T>(acc[dn][2 * i + c] * inv_l);
        }
    }
  }
}

// One thread per output element: the shares of its row, in order.
template <typename T>
__global__ void merge_kernel(Args a, int BH, int bk) {
  const long long total = (long long)BH * a.Sq * a.hd;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % a.hd);
  const long long rowi = i / a.hd;               // bh * Sq + qpos
  const int qpos = (int)(rowi % a.Sq), bh = (int)(rowi / a.Sq);
  const int q0 = qpos / a.bq * a.bq;
  const int count = key_share(q0, a.bq, a.Sq, a.Sk, bk, a.causal, a.window,
                              a.splits, 0).count;
  const size_t plane = (size_t)BH * a.Sq;
  float m = kMasked;
  for (int z = 0; z < count; ++z)
    m = fmaxf(m, a.part_ml[2 * (z * plane + rowi)]);
  float l = 0.0f, acc = 0.0f;
  for (int z = 0; z < count; ++z) {
    const size_t row = z * plane + rowi;
    // rounded as flash_attention_split_ref rounds (no FMA contraction)
    const float w = expf(a.part_ml[2 * row] - m);
    l = __fadd_rn(l, __fmul_rn(a.part_ml[2 * row + 1], w));
    acc = __fadd_rn(acc, __fmul_rn(a.part_acc[row * a.hd + d], w));
  }
  const int b = bh / a.H, h = bh % a.H;
  ((T*)a.out)[(((size_t)b * a.Sq + qpos) * a.H + h) * a.hd + d] =
      from_f32<T>(acc * (1.0f / fmaxf(l, 1e-30f)));
}

template <typename T, int HD>
int launch(Args a, int B, cudaStream_t s) {
  using C = Cfg<T, HD>;
  const int warps = a.bq / 16;
  const int smem = (a.bq + 4 * C::BK) * C::LDS * (int)sizeof(T);
  static bool attr_set = false;      // once, for the largest block (bq 64)
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (64 + 4 * C::BK) * C::LDS * (int)sizeof(T));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int q_tiles = (a.Sq + a.bq - 1) / a.bq;
  const long long bh = (long long)B * a.H;
  if (bh > 65535 || a.splits > 65535) return (int)cudaErrorInvalidConfiguration;
  attn_kernel<T, HD><<<dim3(q_tiles, (unsigned)bh, a.splits), warps * 32,
                       smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long long total = bh * a.Sq * a.hd;
  merge_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      a, (int)bh, C::BK);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(Args a, int B, cudaStream_t s) {
  if (a.hd <= 16) return launch<T, 16>(a, B, s);
  if (a.hd <= 32) return launch<T, 32>(a, B, s);
  if (a.hd <= 64) return launch<T, 64>(a, B, s);
  return launch<T, 128>(a, B, s);
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, H, hd), out like q; dtype 0 float,
// 1 bf16; hd <= 128.  window 0: none.  bq: query rows a block (16, 32,
// 48 or 64).  splits > 1: the key split, with part_acc (splits, B*H,
// Sq, hd) and part_ml (splits, B*H, Sq, 2) float scratch.  vec: rows and
// pointers are 16-byte aligned (cp.async); else rows load synchronously.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    void* part_acc, void* part_ml, int B, int Sq, int Sk,
                    int H, int hd, float sm_scale, int causal, int window,
                    int bq, int splits, int vec, int dtype, void* stream) {
  if (hd < 1 || hd > 128 || bq < 16 || bq > 64 || bq % 16 || splits < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q,  k,      v,      out,    (float*)part_acc, (float*)part_ml,
         H,  Sq,     Sk,     hd,     bq,               causal,
         window, splits, vec, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, s);
  return dispatch<float>(a, B, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
