// A tensor-core GEMM tile for float32 and bf16, shared by
// fused_gemm_epilogue.cu and packed_gemm.cu.
//
//   acc += x[m0:m_end, kbeg:kend] @ w[kbeg:kend, n0:n0 + BN]
//
// x row-major (., K), w row-major (K, N): the JAX layouts at the public
// functions, kept.  128 threads, 4 warps laid 2 x 2 over the BM x BN
// block tile (1 x 4 for 16-row tiles); each warp owns MI x NI m16n8
// accumulator tiles (8 warps a block measured faster in bf16 and slower
// in float32: PERF.md, PR 10).  Rows at or past m_end, columns at or past
// N and k at or past K load as zeros, so ragged edges need no padding by
// the caller.
//
// * The products run on the tensor cores with mma.sync:
//   - bf16: m16n8k16 bf16 with float32 accumulation.  The products are
//     exact in float32, so only the summation order differs from the
//     plain version.
//   - float32: 3xTF32.  Each operand is split into a TF32 high part and
//     the rest (split_tf32), and three m16n8k8 products (the small ones
//     first) are issued; each k-tile's products go to fresh
//     accumulators that are added to the running sum in round-to-nearest,
//     since the tensor cores' own accumulation of a long sum rounds
//     coarser than float32 adds.  One TF32 pass keeps about three decimal
//     digits of each operand, short of the 1e-4 the float32 callers are
//     held to.
// * A STAGES-deep ring of k-tiles (128 bytes of each row) in dynamic
//   shared memory, fed by 16-byte cp.async (zero-filled past the edges)
//   where rows are 16-byte aligned (K, resp. N, a multiple of 4 floats or
//   8 bf16, and the base aligned); elsewhere by synchronous masked loads
//   into the same ring.  One barrier per k-tile.  A block's first k-tile
//   lands 1.2-1.8 us after it starts on the H100 (PERF.md, PR 10), so
//   the ring keeps 3 in flight; deeper rings bought nothing at the
//   callers' shapes and cost blocks per SM at 2048^3.
// * Row pitches padded so that every fragment read is free of bank
//   conflicts: A's pitch BK + 16 bytes' worth (TF32 reads 32-bit words
//   (g, t): pitch / 4 odd; bf16 ldmatrix rows: pitch / 16 bytes odd), B's
//   BN + 8 (TF32 words (t, g): pitch / 8 odd; bf16 ldmatrix.trans rows:
//   pitch / 16 bytes odd).
//
// mma_tf32, mma_bf16 and cp_async16 are copies of flash_attention.cu's,
// which keeps its own (and its cvt-based split).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_io.cuh"

namespace mma_gemm {

constexpr int THREADS = 128;
constexpr int STAGES = 4;

using float_io::from_f32;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int BK = 32;        // a k-tile is 128 bytes of each row
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int BK = 64;
};

template <typename T, int BM, int BN>
struct Tile {
  static constexpr int BK = Elem<T>::BK;
  static constexpr int CH = 16 / sizeof(T);       // elements per cp.async
  static constexpr int LDA = BK + CH;             // 36 floats / 72 bf16
  static constexpr int LDB = BN + 8;
  static constexpr int LDC = BN + 8;              // the float tile in smem
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int STAGE_ELEMS = BM * LDA + BK * LDB;
  // the ring; the float tile (BM, LDC) of acc_to_smem reuses it
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static_assert(BM * LDC * 4 <= SMEM_BYTES, "tile does not fit the ring");
  static_assert(MI >= 1 && NI >= 1 && WM % 16 == 0 && WN % 8 == 0,
                "tile too small for its warps");
};

// -- fragment helpers ---------------------------------------------------------

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (half up, in
// integer arithmetic), lo = x - hi exactly, which the tensor cores read
// as TF32 by dropping its low 13 bits (|lo| <= 2^-11 |x| and lo has at
// most 12 significant bits, so 1 is lost: 2^-22 |x|).  Two
// cvt.rna.tf32.f32 per operand, as flash_attention.cu has it, made the
// 2048^3 float32 call 0.42 ms against 0.34 (PERF.md, PR 10).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// mma: register-only, so not volatile: the compiler may interleave
// independent products (volatile asm keeps program order, and each
// dependent product then waits out the last one's latency)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
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

// -- one k-tile into a ring stage ---------------------------------------------

// A rows [m0, m_end) x k [k0, k0 + BK) into As (BM, LDA); B k rows
// [k0, k0 + BK) x columns [n0, n0 + BN) into Bs (BK, LDB).
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_stage(T* As, T* Bs,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w, int m0,
                                           int m_end, int n0, int N, int K,
                                           int k0, bool vec_a, bool vec_b) {
  using C = Tile<T, BM, BN>;
  constexpr int BK = C::BK, CH = C::CH;
  const int tid = threadIdx.x;
  if (vec_a) {
    constexpr int PER_ROW = BK / CH, CHUNKS = BM * PER_ROW;
#pragma unroll
    for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (CHUNKS % THREADS != 0 && e >= CHUNKS) break;
      const int r = e / PER_ROW, c = (e % PER_ROW) * CH;
      const int m = m0 + r, k = k0 + c;
      const bool in = m < m_end && k < K;
      cp_async16(As + r * C::LDA + c, in ? x + (size_t)m * K + k : x, in);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      As[r * C::LDA + c] = m < m_end && k < K ? x[(size_t)m * K + k]
                                              : from_f32<T>(0.0f);
    }
  }
  if (vec_b) {
    constexpr int PER_ROW = BN / CH, CHUNKS = BK * PER_ROW;
#pragma unroll
    for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (CHUNKS % THREADS != 0 && e >= CHUNKS) break;
      const int r = e / PER_ROW, c = (e % PER_ROW) * CH;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < K && n < N;
      cp_async16(Bs + r * C::LDB + c, in ? w + (size_t)k * N + n : w, in);
    }
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r * C::LDB + c] = k < K && n < N ? w[(size_t)k * N + n]
                                          : from_f32<T>(0.0f);
    }
  }
}

// -- the products of one staged k-tile ----------------------------------------

// acc[mi][ni][e]: row wm0 + 16 mi + g (+ 8 for e >= 2), column
// wn0 + 8 ni + 2t + (e & 1) of the block tile; g = lane / 4, t = lane % 4.
template <int BM, int BN>
__device__ __forceinline__ void compute_stage(
    float (&acc)[Tile<float, BM, BN>::MI][Tile<float, BM, BN>::NI][4],
    const float* As, const float* Bs, int wm0, int wn0, int lane) {
  using C = Tile<float, BM, BN>;
  constexpr int MI = C::MI, NI = C::NI, LDA = C::LDA, LDB = C::LDB;
  const int g = lane >> 2, t = lane & 3;
  float part[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < C::BK; kk += 8) {
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* a = As + (wm0 + 16 * mi + g) * LDA + kk + t;
      split_tf32(a[0], ah[mi][0], al[mi][0]);
      split_tf32(a[8 * LDA], ah[mi][1], al[mi][1]);
      split_tf32(a[4], ah[mi][2], al[mi][2]);
      split_tf32(a[8 * LDA + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* b = Bs + (kk + t) * LDB + wn0 + 8 * ni + g;
      split_tf32(b[0], bh[ni][0], bl[ni][0]);
      split_tf32(b[4 * LDB], bh[ni][1], bl[ni][1]);
    }
    // 3xTF32, the small products first, each pass over every tile so
    // that consecutive products are independent
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(part[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(part[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(part[mi][ni], ah[mi], bh[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
}

template <int BM, int BN>
__device__ __forceinline__ void compute_stage(
    float (&acc)[Tile<__nv_bfloat16, BM, BN>::MI]
                [Tile<__nv_bfloat16, BM, BN>::NI][4],
    const __nv_bfloat16* As, const __nv_bfloat16* Bs, int wm0, int wn0,
    int lane) {
  using C = Tile<__nv_bfloat16, BM, BN>;
  constexpr int MI = C::MI, NI = C::NI, LDA = C::LDA, LDB = C::LDB;
#pragma unroll
  for (int kk = 0; kk < C::BK; kk += 16) {
    // lanes 0-15 point at rows 0-15, columns kk..; lanes 16-31 at the
    // same rows, columns kk + 8..: the four 8x8 matrices of A's fragment
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(a[mi], As + (wm0 + 16 * mi + (lane & 15)) * LDA + kk +
                             (lane >> 4) * 8);
    // lanes 0-15 point at k rows kk..kk+15; .trans hands each thread the
    // (k 2t, 2t+1; column g) pairs of B
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      ldmatrix_x2_trans(b[ni], Bs + (kk + (lane & 15)) * LDB + wn0 + 8 * ni);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// -- the tile ---------------------------------------------------------------

// acc += x[m0:m_end, kbeg:kend] @ w[kbeg:kend, n0:n0 + BN], through the
// ring in `smem` (STAGES * STAGE_ELEMS elements, 16-byte aligned).
// kend - kbeg is a multiple of BK except where kend == K.  The caller
// syncs before reusing `smem`.
template <typename T, int BM, int BN>
__device__ __forceinline__ void gemm_tile(
    float (&acc)[Tile<T, BM, BN>::MI][Tile<T, BM, BN>::NI][4],
    const T* __restrict__ x, const T* __restrict__ w, int m0, int m_end,
    int n0, int N, int K, int kbeg, int kend, bool vec_a, bool vec_b,
    T* smem) {
  using C = Tile<T, BM, BN>;
  constexpr int BK = C::BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * C::WN;
  const int nt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) {
      T* st = smem + s * C::STAGE_ELEMS;
      load_stage<T, BM, BN>(st, st + BM * C::LDA, x, w, m0, m_end, n0, N, K,
                            kbeg + s * BK, vec_a, vec_b);
    }
    cp_commit();
  }
  for (int it = 0; it < nt; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();            // tile `it` landed; tile it-1's stage free
    const int nx = it + STAGES - 1;
    if (nx < nt) {
      T* st = smem + (nx % STAGES) * C::STAGE_ELEMS;
      load_stage<T, BM, BN>(st, st + BM * C::LDA, x, w, m0, m_end, n0, N, K,
                            kbeg + nx * BK, vec_a, vec_b);
    }
    cp_commit();
    const T* st = smem + (it % STAGES) * C::STAGE_ELEMS;
    compute_stage<BM, BN>(acc, st, st + BM * C::LDA, wm0, wn0, lane);
  }
  cp_wait<0>();
}

// The block's accumulators into the float tile `c` (BM, LDC) in shared
// memory, so that the epilogue reads whole rows.  Float2 stores: rows g
// of a half warp land on banks 8g + 2t, free of conflicts.
template <int BM, int BN>
__device__ __forceinline__ void acc_to_smem(
    const float (&acc)[Tile<float, BM, BN>::MI][Tile<float, BM, BN>::NI][4],
    float* c) {
  using C = Tile<float, BM, BN>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * C::WN;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            c + (wm0 + 16 * mi + g + 8 * h) * C::LDC + wn0 + 8 * ni + 2 * t) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

// Stores four consecutive outputs y[0..3] of row `m` at columns n..n+3
// (those < N) of the row-major (., N) array `out`: 16 or 8 bytes at once
// where N is a multiple of 4, one by one elsewhere.
template <typename T>
__device__ __forceinline__ void store4(T* out, int m, int n, int N,
                                      const float (&y)[4]) {
  T* o = out + (size_t)m * N + n;
  if (N % 4 == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) o[j] = from_f32<T>(y[j]);
  }
}

// Whether rows of `elems_per_row` elements of T starting at `p` can be
// copied 16 bytes at a time.
template <typename T>
inline bool rows_vec16(const void* p, long long elems_per_row) {
  return elems_per_row % (16 / sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mma_gemm
