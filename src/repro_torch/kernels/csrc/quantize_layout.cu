// Quantize a program stage's left operand straight into crossbar_gemm's
// kernel layout, for Hopper: float32 stage input -> (int8 (R, Kk), amax)
// and, for a weight-mounted stage, the requant factor beside them.
//
// Replaces no Pallas kernel.  Under `jax.jit` XLA fuses the JAX
// executor's chain into one pass over each stage's input: `im2col`
// (src/repro/program/execute.py:148), `quantize_symmetric` (:160,
// src/repro/core/crossbar.py:204-209), the zero pad to full mounts (:164)
// and the requant product `xs * quantize_scale(w_amax)` (:170-171); in a
// dynamic (attention) stage, per (batch, head) slice under `jax.vmap`,
// the right operand's `plane_pack` (:117) and the left operand's
// quantize, pad and scale product `ascale * ws` (:113-127).  A dynamic
// stage makes two calls: the right operand (its K-major view, at the
// weight width) first, then the left one, which reads the right one's
// per-slice amax as w_amax.
//
// What it computes, per call:
//
//   amax    = max |x| over exactly the elements the reference's patch
//             matrix holds (conv: the pixels some patch reads; a 1x1
//             stride-2 conv reads only even rows and columns, and the
//             largest |x| may sit on an odd one); the zero pad of a conv
//             cannot raise a maximum of |x| and is skipped;
//   scale   = max(amax, 1e-8) * f32(1/qmax)   (quantize_scale's form)
//   x8      = clamp(rint(x / scale), -qmax-1, qmax), x / scale a correctly
//             rounded division, rint half to even (torch.round, jnp.round);
//   requant = (max(amax, 1e-8) * max(w_amax, 1e-8)) * f32(f32(1/qx) *
//             f32(1/qw)), where the caller passes w_amax: dequant_scale's
//             form, which XLA makes of the static stage's product; per
//             slice (a dynamic stage, w_amax one a slice) the plain
//             product (max(amax, 1e-8) * f32(1/qx)) * (max(w_amax, 1e-8)
//             * f32(1/qw)), which XLA keeps under jax.vmap (:127);
//
// x8 laid out as `crossbar_gemm` takes it: source column j of K goes to
// column j on the exact branch (Kk = up32(K)), to (j / rows) * R32 +
// j % rows on the sliced branch (Kk = chunks * R32, R32 = up32(rows));
// every other column is 0.  The (C, kh, kw) column order and that chunk
// map decide which columns an ADC read sums together: they stay as the
// reference has them.  Every output is bit for bit the plain version's
// (`quantize_layout_ref`).
//
// Two kinds of operand:
//   conv, k > 1: x NHWC (any strides) read through (k, stride, pad): row
//            (n, oh, ow), column (c, kh, kw), the patch order of
//            conv_general_dilated_patches that pack_weight matches.  Each
//            input element is read by up to k*k patches;
//   rows:    no element repeats: an (A, B, R, kc) view (the fc flatten,
//            the sequence stages' tokens, attention's per-(batch, head)
//            operands, read as they lie: the Q and K heads permuted, V's
//            transposed heads with a stride of 3D along k) or a 1x1 conv,
//            whose rows are pixels.  One amax per (a, b) slice, or one in
//            all.
//
// What bounds it on the H100: bytes.  The covered input is read once as
// float32 and the int8 operand written once (the bound: some 41 us per
// ResNet-18 batch-16 forward at 3.35 TB/s).  What held the first design
// (PR 20) at 11x that was latency and index arithmetic, not bandwidth.
// The design, for that card:
//
// * Each covered element is quantized once.  On the multi-pass conv path
//   a pass quantizes the covered input into an int8 NHWC image (16-byte
//   float4 loads, one quantize() an element); the patch rows are then
//   built from the image by byte moves only, as the plain version
//   quantizes and then unfolds.  The image is scratch the wrapper takes
//   from torch's allocator (1 MB for ResNet-18's largest stages at b16).
// * The gather is coalesced: a block stages the input window that a tile
//   of output pixels reads (one run of the image a window row, 16 bytes a
//   load where C allows) into shared memory, then writes whole 16-byte
//   words of consecutive output columns, consecutive threads on
//   consecutive words of a row.  A per-call table maps each output column
//   to its byte in the window, or to none: the K padding to full mounts
//   (416 of 992 columns in ResNet-18's s0 stages) and the sliced layout's
//   chunk gaps are stored as zero words without a column walk.  Where a
//   thread gathers from global memory (the rows path), it issues all its
//   loads, predicated, before it uses any.
// * Little index arithmetic: a contiguous input whose every pixel some
//   window reads (every conv of the four nets) is walked flat, element i
//   at x + i and at image + i, four a load; a window row is one run; the
//   table is built eight entries a word with one decode.  (Seven integer
//   divisions an item made one block's amax of 8K elements take 4.3 us.)
// * No memset and no atomics: the amax pass leaves one partial maximum a
//   block in scratch (every block writes its slot, zero where it saw no
//   element, so a graph replay never reads a stale one); the next pass
//   reduces the partials itself and writes amax and requant.  The passes
//   after the first are programmatic dependent launches: they start while
//   the pass before them runs, issue what does not depend on it (x's
//   loads, the table) and wait in `dependency_wait`.
// * No amax pass where the caller holds the partials already (`given`):
//   a program's stage input was written one kernel earlier by the
//   fb_epilogue of the stage before, which leaves one partial max |v| a
//   block over all it stored (csrc/fb_epilogue.cu).  Where the call's one
//   amax covers every element of x (rows, or a conv whose windows read
//   every pixel), the quantize or image pass reduces those.  Such a pass
//   issues x's loads before its `dependency_wait`, so it is launched as
//   an ordinary kernel, after the epilogue that writes x has finished.
// * A call whose covered input is small is one launch of thread-block
//   clusters (up to 8 blocks, the portable size): the blocks of a cluster
//   reduce a share each of |x|, exchange their maxima through distributed
//   shared memory, then quantize and write.  Every cluster reduces the
//   whole (small, L2-resident) input, so that no cluster waits on
//   another; a per-slice call gives each slice a cluster of its own.
//   While the cluster barrier completes, a block builds its table and
//   issues its first loads.  The one-launch conv path quantizes its
//   window into shared memory as it stages it.  Which calls are small,
//   the wrapper decides from measurements (`plan`, ONE_LAUNCH_MAX).
//
// Kernels per call: one launch (small); amax partials + quantize into the
// layout (rows); amax partials + image + gather (conv, k > 1); with the
// partials given, quantize alone (rows) or image + gather (conv, k > 1).
// The wrapper (`kernels/quantize_layout.py`, `plan`) picks the path and
// says how many kernels a call launches.  Nothing here allocates or
// synchronizes, so a CUDA graph captures every path.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "partial_maxima.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int V = 16;                 // output columns (bytes) a word
constexpr int UNROLL = 4;             // loads in flight a thread in a walk
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int MAX_PARTS = 1024;       // partial maxima a slice
constexpr int MAX_GIVEN =             // partial maxima a caller may hold
    partial_maxima::kMaxGiven;        // (fb_epilogue's, at most)
constexpr int MAX_BLOCKS = 2048;      // blocks of a grid-stride pass
constexpr int STAGE_BYTES = 32 * 1024;    // a tile's window, preferably
constexpr int WINDOW_LIMIT = 65535;       // table entries are 16 bits
constexpr int SMEM_LIMIT = 200 * 1024;    // dynamic shared memory a block
constexpr unsigned NO_COL = 0xFFFFu;      // a table entry: a zero column
// elements of x, words of the output and the image are indexed in 32 bits
constexpr long long INDEX_LIMIT = 1LL << 31;

struct Layout {
  int kc;        // source columns (the operand's K before padding)
  int kk;        // columns of the kernel layout
  int rows;      // ADC chunk height (sliced branch)
  int r32;       // the chunk's height in the layout, up32(rows)
  int exact;     // 1: exact branch, columns as they are
};

// Where the amax and the requant factor go, and the quantizer's constants.
struct Result {
  float* amax;           // one, or one a slice
  float* requant;        // null, or the requant factor: (1, 1), or one a
                         // slice where `plain`
  const float* w_amax;   // with requant: the mounted weight's amax (plain:
                         // the right operand's, one a slice)
  float req_c;           // f32(f32(1/qx) * f32(1/qw)); plain: f32(1/qw)
  int qmax;
  float inv_qmax;
  int plain;             // 1: the per-slice plain product of the scales
};

// An NHWC conv input.  Element offsets into x stay below 2^31 (the wrapper
// checks), so strides and offsets are 32-bit.
struct Conv {
  const float* x;
  int sn, sh, sw, sc;           // element strides of NHWC
  int N, H, W, C, k, stride, pad, OH, OW;
  int vec;    // 1: float4 loads of 4 channels (sc 1, C and the other
              // strides multiples of 4, x 16-byte aligned)
  int cont;   // 1: x is contiguous NHWC (a pixel row is one run)
  int flat;   // 1: cont, and every pixel is covered: the walks over x are
              // flat, element i at x + i and at image + i
  int walk4;  // 1: the walks take 4 elements a load (flat: the element
              // count a multiple of 4 and x aligned; else vec)
};

// The operand's rows where no element repeats: an (A, B, R, kc) view, or
// the pixels of a 1x1 conv (row (n, oh, ow), column c).
struct Rows {
  const float* x;
  int conv;                         // 1: rows are a 1x1 conv's pixels
  int sa, sb, sr, sk;               // view: strides; conv: sn, sh, sw, sc
  int A, B, R;                      // view: R rows a slice
  int H, W, stride, pad, OH, OW;    // conv: geometry
  int kc;
  int vec;    // 1: float4 loads along a row (sk 1, kc and the row
              // strides multiples of 4, x 16-byte aligned)
  int flat;   // 1: a view whose row r (over all slices) is x + r * kc

  // element offset of row `row` (over all slices), or -1 for a row of a
  // conv's zero pad
  __device__ __forceinline__ int base(unsigned row) const {
    if (flat) return (int)(row * kc);
    if (conv) {
      const unsigned pix = (unsigned)OH * OW;
      const unsigned n = row / pix, rem = row - n * pix;
      const int oh = rem / OW, ow = rem - oh * OW;
      const int h = oh * stride - pad, w = ow * stride - pad;
      if (h < 0 || h >= H || w < 0 || w >= W) return -1;
      return (int)(n * sa + h * sb + w * sr);
    }
    const unsigned slice = row / R, r = row - slice * R;
    const unsigned a = slice / B, b = slice - a * B;
    return (int)(a * sa + b * sb + r * sr);
  }
};

// A conv's output pixels in tiles of tr x tw, and the input window a tile
// reads, staged in shared memory with row pitch rp.
struct Tile {
  int tr, tw;      // output rows and columns a tile
  int th, tn;      // tiles along OH and along OW
  int rp;          // the window's row pitch in bytes (a multiple of 16)
  int count;       // N * th * tn
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
  __device__ __forceinline__ Scale(float amax, float inv_qmax) {
    s = __fmul_rn(fmaxf(amax, 1e-8f), inv_qmax);
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
// qmax, so floorf's subtraction below is exact.  This arithmetic is the
// reference's: it moves between passes, it is never rewritten (and the
// build has no fast-math flag).
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

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide max of v, returned to every thread.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_m[WARPS];
  v = warp_max(v);
  __syncthreads();                       // warp_m is free again
  if ((threadIdx.x & 31) == 0) warp_m[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = warp_m[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) m = fmaxf(m, warp_m[i]);
  return m;
}

// A cluster-wide max in two halves, so that a block does independent
// work while the others arrive: `cluster_post` puts the block's max in its
// own shared memory and arrives at a cluster barrier; `cluster_gather`
// waits for it (every block started, every slot written), warp 0 reads
// the others' slots through distributed shared memory, and a relaxed
// arrival says this block is done reading; `cluster_done` waits for the
// others before the block exits (its slot must outlive their reads).
__device__ __forceinline__ void cluster_post(float block_m, float* slot) {
  if (threadIdx.x == 0) *slot = block_m;
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ float cluster_gather(float* slot,
                                                cg::cluster_group& cluster) {
  __shared__ float m_all;
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (threadIdx.x < 32) {
    float m = threadIdx.x < cluster.num_blocks()
                  ? *cluster.map_shared_rank(slot, threadIdx.x)
                  : 0.0f;
    m = warp_max(m);
    if (threadIdx.x == 0) m_all = m;
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  return m_all;
}

__device__ __forceinline__ void cluster_done() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The amax, and the requant factor where asked (one thread): the static
// stage's reassociated form, or per slice the plain product of the two
// quantize scales (each product rounded on its own: no contraction).  A
// kernel calls it after every wait on the kernel before it, so the right
// operand's call has written w_amax.
__device__ __forceinline__ void write_result(const Result& res, int slot,
                                             float amax) {
  res.amax[slot] = amax;
  if (!res.requant) return;
  if (res.plain)
    res.requant[slot] =
        __fmul_rn(__fmul_rn(fmaxf(amax, 1e-8f), res.inv_qmax),
                  __fmul_rn(fmaxf(res.w_amax[slot], 1e-8f), res.req_c));
  else
    res.requant[0] = __fmul_rn(
        __fmul_rn(fmaxf(amax, 1e-8f), fmaxf(res.w_amax[0], 1e-8f)),
        res.req_c);
}

// Max of the `n` partial maxima at p, returned to every thread.
__device__ __forceinline__ float reduce_partials(const float* p, int n) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, p[i]);
  return block_max(m);
}

template <int VW>
__device__ __forceinline__ void load_f(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

// The column table: entry o is output column o's byte in a pixel's window
// (kh * rp + kw * C + c), or NO_COL where no source column lands.  Entries
// o0 .. o0 + 7 make one 16-byte word: one decode of o0, then a step a
// column (no division past the first).
__device__ __forceinline__ uint4 table_word(const Conv& g, const Layout& L,
                                            int rp, int o0) {
  Cols col(o0, L);
  const int kk2 = g.k * g.k;
  int c = col.j / kk2;
  const int t = col.j - c * kk2;
  int kh = t / g.k, kw = t - kh * g.k;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t e =
        col.valid(L) ? (uint32_t)(kh * rp + kw * g.C + c) : NO_COL;
    w[i >> 1] |= e << (16 * (i & 1));
    if (col.next(L) && ++kw == g.k) {
      kw = 0;
      if (++kh == g.k) { kh = 0; ++c; }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The table's words first, first + step, ... (shared or global memory).
__device__ __forceinline__ void build_table(unsigned short* table,
                                            const Conv& g, const Layout& L,
                                            int rp, int first, int step) {
  for (int i = first; i < L.kk / 8; i += step)
    reinterpret_cast<uint4*>(table)[i] = table_word(g, L, rp, 8 * i);
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it runs; `dependency_wait` holds it until that kernel has
// finished and its writes are visible, `dependents_may_start` lets the
// next one start.  Both are no-ops for a kernel launched without it.
__device__ __forceinline__ void dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void dependents_may_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---- walks over the covered input -----------------------------------------

// Item i of a walk over a conv input in NHWC order, VW channels an item:
// its pixel (n, h, w), first channel c, and whether some window reads it.
template <int VW>
struct ConvItem {
  unsigned n, h, w, c;
  bool ok;
  __device__ __forceinline__ ConvItem(const Conv& g, unsigned i) {
    const unsigned per = g.C / VW;
    const unsigned pix = i / per;
    c = (i - pix * per) * VW;
    const unsigned nh = pix / g.W;
    w = pix - nh * g.W;
    n = nh / g.H;
    h = nh - n * g.H;
    ok = covered(h, g.k, g.stride, g.pad, g.OH) &&
         covered(w, g.k, g.stride, g.pad, g.OW);
  }
  __device__ __forceinline__ int offset(const Conv& g) const {
    return (int)(n * g.sn + h * g.sh + w * g.sw + c * g.sc);
  }
  __device__ __forceinline__ unsigned image(const Conv& g) const {
    return ((n * g.H + h) * g.W + w) * g.C + c;
  }
};

// Items of a walk over a conv input: a flat walk's items are VW elements
// whatever C is; another walk's VW channels of a pixel (C a multiple of
// VW), its pixel decoded and tested for coverage (`ConvItem`).
template <int VW>
__device__ __forceinline__ unsigned conv_items(const Conv& g) {
  return g.flat ? (unsigned)g.N * g.H * g.W * g.C / VW
                : (unsigned)g.N * g.H * g.W * (g.C / VW);
}

// This thread's max |x| over the covered elements of part `part` of
// `parts` (items b + u * THREADS, UNROLL loads in flight).
template <int VW>
__device__ float conv_abs_max(const Conv& g, unsigned part, unsigned parts) {
  const unsigned items = conv_items<VW>(g);
  float m = 0.0f;
  for (unsigned b = part * THREADS * UNROLL + threadIdx.x; b < items;
       b += parts * THREADS * UNROLL) {
    float v[UNROLL][VW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < VW; ++e) v[u][e] = 0.0f;
      const unsigned i = b + u * THREADS;
      if (i < items && g.flat) {         // item i at x + i * VW
        load_f<VW>(g.x + i * VW, v[u]);
      } else if (i < items) {
        const ConvItem<VW> it(g, i);
        if (it.ok) load_f<VW>(g.x + it.offset(g), v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VW; ++e) m = fmaxf(m, fabsf(v[u][e]));
  }
  return m;
}

// A batch of the image pass: UNROLL items b + u * THREADS of a walk over
// the covered input, loaded (`ok` where covered), and where each goes in
// the int8 NHWC image.
template <int VW>
struct ImageBatch {
  float v[UNROLL][VW];
  bool ok[UNROLL];
  unsigned dst[UNROLL];

  __device__ __forceinline__ void load(const Conv& g, unsigned items,
                                       unsigned b) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = b + u * THREADS;
      ok[u] = false;
      dst[u] = 0;
      if (i < items && g.flat) {         // item i at x + i * VW
        ok[u] = true;
        dst[u] = i * VW;
        load_f<VW>(g.x + i * VW, v[u]);
      } else if (i < items) {
        const ConvItem<VW> it(g, i);
        ok[u] = it.ok;
        dst[u] = it.image(g);
        if (it.ok) load_f<VW>(g.x + it.offset(g), v[u]);
      }
    }
  }

  __device__ __forceinline__ void store(const Scale& sc, int qmax,
                                        int8_t* img) const {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      if constexpr (VW == 4) {
        *reinterpret_cast<uint32_t*>(img + dst[u]) =
            pack4(quantize(v[u][0], sc, qmax), quantize(v[u][1], sc, qmax),
                  quantize(v[u][2], sc, qmax), quantize(v[u][3], sc, qmax));
      } else {
        img[dst[u]] = quantize(v[u][0], sc, qmax);
      }
    }
  }
};

// The image pass: the block's first batch of x is loaded before the amax
// is reduced from the partials (the loads do not wait on it), then the
// covered input is quantized into the int8 NHWC image (pixels no window
// reads are left unwritten: no patch reads them).  Block 0 writes amax
// and requant; the grid writes the column table meanwhile.
template <int VW>
__device__ void image_pass(const Conv& g, const Layout& L, int rp,
                           const Result& res, const float* partials,
                           int parts, int8_t* img, unsigned short* table) {
  const unsigned items = conv_items<VW>(g);
  const unsigned step = gridDim.x * THREADS * UNROLL;
  unsigned b = blockIdx.x * THREADS * UNROLL + threadIdx.x;
  ImageBatch<VW> batch;
  batch.load(g, items, b);
  build_table(table, g, L, rp, blockIdx.x * THREADS + threadIdx.x,
              gridDim.x * THREADS);
  dependency_wait();                   // the partials are written
  dependents_may_start();
  const float amax = reduce_partials(partials, parts);
  if (blockIdx.x == 0 && threadIdx.x == 0) write_result(res, 0, amax);
  const Scale sc(amax, res.inv_qmax);
  batch.store(sc, res.qmax, img);
  for (b += step; b < items; b += step) {
    batch.load(g, items, b);
    batch.store(sc, res.qmax, img);
  }
}

// This thread's max |x| over rows [row0, row0 + nrows) of a rows operand,
// part `part` of `parts`.
template <int VW>
__device__ float rows_abs_max(const Rows& g, unsigned row0, unsigned nrows,
                              unsigned part, unsigned parts) {
  const unsigned per = g.kc / VW, items = nrows * per;
  float m = 0.0f;
  for (unsigned b = part * THREADS * UNROLL + threadIdx.x; b < items;
       b += parts * THREADS * UNROLL) {
    float v[UNROLL][VW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < VW; ++e) v[u][e] = 0.0f;
      const unsigned i = b + u * THREADS;
      if (i < items && g.flat) {         // row0's run, item i on
        load_f<VW>(g.x + row0 * g.kc + i * VW, v[u]);
      } else if (i < items) {
        const unsigned r = i / per, j = (i - r * per) * VW;
        const int base = g.base(row0 + r);
        if (base >= 0) load_f<VW>(g.x + base + (int)j * g.sk, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VW; ++e) m = fmaxf(m, fabsf(v[u][e]));
  }
  return m;
}

// ---- the rows path: quantize straight into the layout ---------------------

// Output word (row, o0 .. o0 + 15): `load` issues every load before any
// is used (it needs no scale, so a kernel may issue it before the amax is
// known), `store` quantizes and stores one 16-byte word.  A word with no
// source column (the K padding, a chunk gap, a row of the zero pad) is
// stored as zeros.
struct RowWord {
  float v[V];
  bool any;
  int8_t* dst;

  __device__ __forceinline__ void load(const Rows& g, const Layout& L,
                                       unsigned row, int o0, int8_t* out) {
    const int base = g.base(row);
    dst = out + (size_t)row * L.kk + o0;
    any = false;
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
    if (base < 0) return;
    if (g.vec && L.exact) {            // columns o0.. are source columns
      any = o0 < L.kc;
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (o0 + i < L.kc)
          q = *reinterpret_cast<const float4*>(g.x + base + o0 + i);
        v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
      }
    } else {
      int src[V];
      bool ok[V];
      Cols col(o0, L);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ok[i] = col.valid(L);
        src[i] = col.j;
        any |= ok[i];
        col.next(L);
      }
#pragma unroll
      for (int i = 0; i < V; ++i)      // all 16 loads in flight
        if (ok[i]) v[i] = g.x[base + src[i] * g.sk];
    }
  }

  __device__ __forceinline__ void store(const Scale& sc, int qmax) const {
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (any) {                         // quantize(0) is 0: gaps stay zero
      int8_t q[V];
#pragma unroll
      for (int i = 0; i < V; ++i) q[i] = quantize(v[i], sc, qmax);
      word.x = pack4(q[0], q[1], q[2], q[3]);
      word.y = pack4(q[4], q[5], q[6], q[7]);
      word.z = pack4(q[8], q[9], q[10], q[11]);
      word.w = pack4(q[12], q[13], q[14], q[15]);
    }
    *reinterpret_cast<uint4*>(dst) = word;
  }
};

// ---- the conv path: tiles of output pixels from a staged window ----------

struct TileAt {
  int n, oh0, ow0, nr, nc, h0, w0, srows, scols;
  __device__ __forceinline__ TileAt(const Conv& g, const Tile& T, int t) {
    const int per = T.th * T.tn;
    n = t / per;
    const int r = t - n * per, ti = r / T.tn, tj = r - ti * T.tn;
    oh0 = ti * T.tr;
    ow0 = tj * T.tw;
    nr = min(T.tr, g.OH - oh0);
    nc = min(T.tw, g.OW - ow0);
    h0 = oh0 * g.stride - g.pad;
    w0 = ow0 * g.stride - g.pad;
    srows = (nr - 1) * g.stride + g.k;
    scols = (nc - 1) * g.stride + g.k;
  }
};

// A staged window row is one run of x (or of the image): pixels w0 ..
// w0 + scols - 1 of input row h, C channels each; the pixels inside the
// image are the elements [lo, hi) of the run, the others are zero pad.
struct WindowRow {
  int lo, hi, per;   // in-image element range of a run; VB-chunks a run
  __device__ __forceinline__ WindowRow(const Conv& g, const TileAt& a,
                                       int vb) {
    lo = max(0, -a.w0) * g.C;
    hi = min(a.scols, g.W - a.w0) * g.C;
    per = a.scols * g.C / vb;
  }
};

// The tile's window from the int8 image (contiguous NHWC), VB bytes a load
// (C a multiple of VB), zeros outside the image; UNROLL loads in flight.
template <int VB>
__device__ void stage_image(int8_t* st, const int8_t* img, const Conv& g,
                            int rp, const TileAt& a) {
  using Chunk = typename std::conditional<
      VB == 16, uint4, typename std::conditional<VB == 4, uint32_t,
                                                 int8_t>::type>::type;
  const WindowRow wr(g, a, VB);
  const int items = a.srows * wr.per;
  const int8_t* run0 =
      img + ((long long)(a.n * g.H + a.h0) * g.W + a.w0) * g.C;
  for (int e0 = threadIdx.x; e0 < items; e0 += THREADS * UNROLL) {
    Chunk v[UNROLL];
    int dst[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      v[u] = Chunk{};
      dst[u] = -1;
      if (e < items) {
        const int r = e / wr.per, j = (e - r * wr.per) * VB;
        const int h = a.h0 + r;
        dst[u] = r * rp + j;
        if (h >= 0 && h < g.H && j >= wr.lo && j < wr.hi)
          v[u] = *reinterpret_cast<const Chunk*>(
              run0 + (long long)r * g.W * g.C + j);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (dst[u] >= 0) *reinterpret_cast<Chunk*>(st + dst[u]) = v[u];
  }
}

// A batch of the tile's window read from x itself (the one-launch path):
// UNROLL items e0 + u * THREADS of VW channels, `load` needing no scale
// (a kernel may issue it before the amax is known), `store` quantizing
// them into the staged window.  A contiguous x is read run by run, any
// other through its strides.
template <int VW>
struct WindowBatch {
  float v[UNROLL][VW];
  int dst[UNROLL];

  __device__ __forceinline__ void load(const Conv& g, const TileAt& a,
                                       const WindowRow& wr, int rp, int e0) {
    const int items = a.srows * wr.per;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * THREADS;
#pragma unroll
      for (int i = 0; i < VW; ++i) v[u][i] = 0.0f;
      dst[u] = -1;
      if (e < items) {
        const int r = e / wr.per, j = (e - r * wr.per) * VW;
        const int h = a.h0 + r;
        dst[u] = r * rp + j;
        if (h >= 0 && h < g.H && j >= wr.lo && j < wr.hi) {
          if (g.cont) {
            load_f<VW>(g.x + ((a.n * g.H + h) * g.W + a.w0) * g.C + j, v[u]);
          } else {
            const int q = j / g.C, c = j - q * g.C;
            load_f<VW>(g.x + a.n * g.sn + h * g.sh + (a.w0 + q) * g.sw +
                           c * g.sc, v[u]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Scale& sc, int qmax,
                                        int8_t* st) const {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (dst[u] < 0) continue;
      if constexpr (VW == 4) {
        *reinterpret_cast<uint32_t*>(st + dst[u]) =
            pack4(quantize(v[u][0], sc, qmax), quantize(v[u][1], sc, qmax),
                  quantize(v[u][2], sc, qmax), quantize(v[u][3], sc, qmax));
      } else {
        st[dst[u]] = quantize(v[u][0], sc, qmax);
      }
    }
  }
};

// Every output word of the tile: thread t takes words t, t + THREADS, ...
// of the tile's rows in order, so consecutive threads store consecutive
// words of a row.  Per word: its 16 table entries (two 16-byte shared
// loads), 16 byte loads from the window, one 16-byte store; a word whose
// columns are all padding is a zero store.
__device__ void write_tile(const int8_t* st, const unsigned short* table,
                           const Conv& g, const Layout& L, int rp,
                           const TileAt& a, int8_t* out) {
  const int G = L.kk / V, total = a.nr * a.nc * G;
  const int dq = THREADS / G, dg = THREADS - dq * G;
  int pix = threadIdx.x / G, gi = threadIdx.x - pix * G;
  int dh = pix / a.nc, dw = pix - dh * a.nc;
  const uint4* tab = reinterpret_cast<const uint4*>(table);
  for (int wd = threadIdx.x; wd < total; wd += THREADS) {
    const uint4 t0 = tab[2 * gi], t1 = tab[2 * gi + 1];
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if ((t0.x & t0.y & t0.z & t0.w & t1.x & t1.y & t1.z & t1.w) !=
        0xFFFFFFFFu) {
      const uint32_t e[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      const uint8_t* win = reinterpret_cast<const uint8_t*>(st) +
                           dh * g.stride * rp + dw * g.stride * g.C;
      uint32_t b[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const unsigned off = (e[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
        b[i] = off == NO_COL ? 0u : (uint32_t)win[off];
      }
      word.x = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
      word.y = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
      word.z = b[8] | (b[9] << 8) | (b[10] << 16) | (b[11] << 24);
      word.w = b[12] | (b[13] << 8) | (b[14] << 16) | (b[15] << 24);
    }
    const size_t row =
        ((size_t)a.n * g.OH + a.oh0 + dh) * g.OW + a.ow0 + dw;
    *reinterpret_cast<uint4*>(out + row * L.kk + gi * V) = word;
    gi += dg;                          // the next word: THREADS further on
    int dp = dq;
    if (gi >= G) { gi -= G; ++dp; }
    dw += dp;
    if (dw >= a.nc) {
      const int carry = dw / a.nc;
      dh += carry;
      dw -= carry * a.nc;
    }
  }
}

// ---- kernels: the one-launch path ----------------------------------------

// Clusters of `cluster` blocks; each cluster reduces the whole covered
// input (a share a block), then the grid's blocks share the tiles.  While
// the cluster's maxima meet, a block builds its column table and issues
// the loads of its first tile's window.
template <int VW>
__device__ __forceinline__ void one_conv(const Conv& g, const Layout& L,
                                         const Tile& T, const Result& res,
                                         int8_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float slot;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), size = cluster.num_blocks();
  const float m = block_max(g.walk4 ? conv_abs_max<4>(g, rank, size)
                                    : conv_abs_max<1>(g, rank, size));
  if (size > 1) cluster_post(m, &slot);
  unsigned short* table = reinterpret_cast<unsigned short*>(smem);
  int8_t* st = reinterpret_cast<int8_t*>(smem + 2 * L.kk);
  build_table(table, g, L, T.rp, threadIdx.x, THREADS);
  const int t0 = blockIdx.x;
  WindowBatch<VW> batch;
  if (t0 < T.count) {
    const TileAt a(g, T, t0);
    batch.load(g, a, WindowRow(g, a, VW), T.rp, threadIdx.x);
  }
  const float amax = size > 1 ? cluster_gather(&slot, cluster) : m;
  if (blockIdx.x == 0 && threadIdx.x == 0) write_result(res, 0, amax);
  const Scale sc(amax, res.inv_qmax);
  for (int t = t0; t < T.count; t += gridDim.x) {
    const TileAt a(g, T, t);
    const WindowRow wr(g, a, VW);
    int e0 = threadIdx.x;
    if (t != t0) batch.load(g, a, wr, T.rp, e0);
    for (;;) {
      batch.store(sc, res.qmax, st);
      e0 += THREADS * UNROLL;
      if (e0 >= a.srows * wr.per) break;
      batch.load(g, a, wr, T.rp, e0);
    }
    __syncthreads();
    write_tile(st, table, g, L, T.rp, a, out);
    __syncthreads();
  }
  if (size > 1) cluster_done();
}

__global__ void __launch_bounds__(THREADS)
one_conv_kernel(Conv g, Layout L, Tile T, Result res, int8_t* out) {
  if (g.vec)
    one_conv<4>(g, L, T, res, out);
  else
    one_conv<1>(g, L, T, res, out);
}

// Clusters of `cluster` blocks.  per_slice: cluster q is slice q (rows
// [q * rows_per, ...)), its amax that slice's; otherwise every cluster
// reduces all rows and the grid's blocks share the words.  A thread's
// first word is loaded while the cluster's maxima meet.
__global__ void __launch_bounds__(THREADS)
one_rows_kernel(Rows g, Layout L, Result res, int per_slice,
                unsigned rows_per, int8_t* out) {
  __shared__ float slot;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), size = cluster.num_blocks();
  const unsigned q = blockIdx.x / size;
  const unsigned slice = per_slice ? q : 0u, row0 = slice * rows_per;
  const float m =
      block_max(g.vec ? rows_abs_max<4>(g, row0, rows_per, rank, size)
                      : rows_abs_max<1>(g, row0, rows_per, rank, size));
  if (size > 1) cluster_post(m, &slot);
  const unsigned G = L.kk / V, words = rows_per * G;
  const unsigned first = (per_slice ? rank : blockIdx.x) * THREADS +
                         threadIdx.x;
  const unsigned step = (per_slice ? size : gridDim.x) * THREADS;
  RowWord word;
  if (first < words) {
    const unsigned r = first / G;
    word.load(g, L, row0 + r, (int)(first - r * G) * V, out);
  }
  const float amax = size > 1 ? cluster_gather(&slot, cluster) : m;
  if (rank == 0 && threadIdx.x == 0 && (per_slice || q == 0))
    write_result(res, slice, amax);
  const Scale sc(amax, res.inv_qmax);
  for (unsigned w = first; w < words; w += step) {
    if (w != first) {
      const unsigned r = w / G;
      word.load(g, L, row0 + r, (int)(w - r * G) * V, out);
    }
    word.store(sc, res.qmax);
  }
  if (size > 1) cluster_done();
}

// ---- kernels: the multi-pass path -----------------------------------------

// One partial maximum a block: partials[blockIdx.x].
__global__ void __launch_bounds__(THREADS)
partials_conv_kernel(Conv g, float* partials) {
  dependents_may_start();
  const float m = g.walk4 ? conv_abs_max<4>(g, blockIdx.x, gridDim.x)
                          : conv_abs_max<1>(g, blockIdx.x, gridDim.x);
  const float b = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
}

// gridDim.y slices of rows_per rows; partials[y * gridDim.x + x].
__global__ void __launch_bounds__(THREADS)
partials_rows_kernel(Rows g, unsigned rows_per, float* partials) {
  dependents_may_start();
  const unsigned row0 = blockIdx.y * rows_per;
  const float m = g.vec
                      ? rows_abs_max<4>(g, row0, rows_per, blockIdx.x,
                                        gridDim.x)
                      : rows_abs_max<1>(g, row0, rows_per, blockIdx.x,
                                        gridDim.x);
  const float b = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = b;
}

// The amax from the partials, then the covered input into the int8 image;
// block 0 writes amax and requant, the grid writes the column table.
__global__ void __launch_bounds__(THREADS)
image_kernel(Conv g, Layout L, int rp, Result res, const float* partials,
             int parts, int8_t* img, unsigned short* table) {
  if (g.walk4)
    image_pass<4>(g, L, rp, res, partials, parts, img, table);
  else
    image_pass<1>(g, L, rp, res, partials, parts, img, table);
}

// The patch rows from the int8 image: byte moves only.
__global__ void __launch_bounds__(THREADS)
gather_kernel(Conv g, Layout L, Tile T, const int8_t* img,
              const unsigned short* table_g, int8_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* table = reinterpret_cast<unsigned short*>(smem);
  int8_t* st = reinterpret_cast<int8_t*>(smem + 2 * L.kk);
  dependency_wait();                   // the image and the table are written
  for (int i = threadIdx.x; i < L.kk / 8; i += THREADS)
    reinterpret_cast<uint4*>(table)[i] =
        reinterpret_cast<const uint4*>(table_g)[i];
  __syncthreads();
  const int vb = g.C % 16 == 0 ? 16 : g.C % 4 == 0 ? 4 : 1;
  for (int t = blockIdx.x; t < T.count; t += gridDim.x) {
    const TileAt a(g, T, t);
    if (vb == 16)
      stage_image<16>(st, img, g, T.rp, a);
    else if (vb == 4)
      stage_image<4>(st, img, g, T.rp, a);
    else
      stage_image<1>(st, img, g, T.rp, a);
    __syncthreads();
    write_tile(st, table, g, L, T.rp, a, out);
    __syncthreads();
  }
}

// The slice's amax from its partials, then its words quantized straight
// into the layout; block (0, y) writes slice y's amax (and requant).
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(Rows g, Layout L, Result res, const float* partials,
                     int parts, unsigned rows_per, int8_t* out) {
  const unsigned slice = blockIdx.y;
  const unsigned G = L.kk / V, words = rows_per * G, row0 = slice * rows_per;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  RowWord word;                        // x is ready: its loads go first
  if (first < words) {
    const unsigned r = first / G;
    word.load(g, L, row0 + r, (int)(first - r * G) * V, out);
  }
  dependency_wait();                   // the partials are written
  const float amax = reduce_partials(partials + slice * parts, parts);
  if (blockIdx.x == 0 && threadIdx.x == 0) write_result(res, slice, amax);
  const Scale sc(amax, res.inv_qmax);
  for (unsigned w = first; w < words; w += gridDim.x * THREADS) {
    if (w != first) {
      const unsigned r = w / G;
      word.load(g, L, row0 + r, (int)(w - r * G) * V, out);
    }
    word.store(sc, res.qmax);
  }
}

// ---- host side -----------------------------------------------------------

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Every input row (or column) of n is read by some window.
bool all_covered(int n, int k, int stride, int pad, int n_out) {
  for (int t = 0; t < n; ++t) {
    const int u = t + pad;
    const int lo = u - k + 1 <= 0 ? 0 : (u - k + stride) / stride;
    const int hi = n_out - 1 < u / stride ? n_out - 1 : u / stride;
    if (lo > hi) return false;
  }
  return true;
}

// The staged window of a tr x tw tile: its bytes, and its row pitch (a
// multiple of 16; rows 128 bytes apart would share banks, so such a
// pitch takes 16 more).
int window_bytes(const Conv& g, int tr, int tw, int* rp) {
  const int sr = (tr - 1) * g.stride + g.k, sw = (tw - 1) * g.stride + g.k;
  int p = (sw * g.C + 15) / 16 * 16;
  if (p % 128 == 0) p += 16;
  *rp = p;
  return sr * p;
}

// Tiles for a grid of about `target` blocks: a whole output row of each
// image, narrowed until there are `target` tiles or the window fits
// STAGE_BYTES, then taller while both still hold.  False where even a
// single pixel's window does not fit the 16-bit table.
bool choose_tile(const Conv& g, int target, Tile* T) {
  auto count = [&](int tr, int tw) {
    return (long long)g.N * ((g.OH + tr - 1) / tr) * ((g.OW + tw - 1) / tw);
  };
  int tr = 1, tw = g.OW, rp = 0;
  while (tw > 1 && (count(tr, tw) < target ||
                    window_bytes(g, tr, tw, &rp) > STAGE_BYTES))
    tw = (tw + 1) / 2;
  while (tr * 2 <= g.OH && count(tr * 2, tw) >= target &&
         window_bytes(g, tr * 2, tw, &rp) <= STAGE_BYTES)
    tr *= 2;
  if (window_bytes(g, tr, tw, &rp) > WINDOW_LIMIT) return false;
  const long long n = count(tr, tw);
  if (n >= INDEX_LIMIT) return false;
  *T = Tile{tr, tw, (g.OH + tr - 1) / tr, (g.OW + tw - 1) / tw, rp, (int)n};
  return true;
}

// Blocks of `cluster` along x, through cudaLaunchKernelEx.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int cluster, size_t smem, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// A launch that may start while the kernel before it on the stream runs
// (programmatic dependent launch; the kernel waits in dependency_wait).
struct DependentLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  DependentLaunch(dim3 grid, size_t smem, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

bool cluster_ok(int clusters, int cluster) {
  return cluster >= 1 && cluster <= MAX_CLUSTER && clusters >= 1 &&
         (long long)clusters * cluster < INDEX_LIMIT;
}

// The rows path: one launch (`blocks` clusters of `cluster`, or a cluster
// a slice), or `blocks` partial maxima a slice and the quantize pass, or
// (given, one slice) the quantize pass over `blocks` partials the caller
// holds.
int run_rows(const Rows& g, const Layout& L, const Result& res, int8_t* out,
             float* partials, int given, unsigned slices, int per_slice,
             unsigned rows_per, int one_launch, int blocks, int cluster,
             cudaStream_t s) {
  const long long words = (long long)rows_per * (L.kk / V);
  if ((long long)rows_per * g.kc >= INDEX_LIMIT || words >= INDEX_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (one_launch) {
    const int clusters = per_slice ? (int)slices : blocks;
    if (given || !cluster_ok(clusters, cluster))
      return (int)cudaErrorInvalidValue;
    ClusterLaunch cl(clusters * cluster, cluster, 0, s);
    const cudaError_t e = cudaLaunchKernelEx(&cl.cfg, one_rows_kernel, g, L,
                                             res, per_slice, rows_per, out);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const unsigned ys = per_slice ? slices : 1u;
  if (blocks < 1 || blocks > (given ? MAX_GIVEN : MAX_PARTS) || ys > 65535u ||
      partials == nullptr || (given && ys != 1u))
    return (int)cudaErrorInvalidValue;
  const int cap = MAX_BLOCKS / (int)ys > 1 ? MAX_BLOCKS / (int)ys : 1;
  const dim3 grid(blocks_for(words, THREADS, cap), ys);
  if (given) {                         // x's writer has finished
    quantize_rows_kernel<<<grid, THREADS, 0, s>>>(
        g, L, res, (const float*)partials, blocks, rows_per, out);
    return (int)cudaGetLastError();
  }
  partials_rows_kernel<<<dim3(blocks, ys), THREADS, 0, s>>>(g, rows_per,
                                                           partials);
  DependentLaunch q(grid, 0, s);
  const cudaError_t e =
      cudaLaunchKernelEx(&q.cfg, quantize_rows_kernel, g, L, res,
                         (const float*)partials, blocks, rows_per, out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_LIMIT);
}

}  // namespace

extern "C" {

// x NHWC float32 with element strides (sn, sh, sw, sc), every element's
// offset below 2^31; out (N*OH*OW, kk) int8, 16-byte aligned; amax one
// float32; requant null or one float32 (then w_amax one float32).
// one_launch: `blocks` clusters of `cluster` blocks; otherwise `blocks`
// partial maxima in `partials` (given: already there, max |x| over every
// element of x, whose every pixel some window reads), and for k > 1 the
// N*H*W*C-byte image and the kk-entry table as scratch.  Returns
// cudaGetLastError().
int quantize_layout_conv(const void* x, void* out, void* amax, void* requant,
                         const void* w_amax, float req_c, void* partials,
                         int given, void* image, void* table, int N, int H,
                         int W, int C, int sn, int sh, int sw, int sc, int k,
                         int stride, int pad, int OH, int OW, int kc, int kk,
                         int rows, int r32, int exact, int qmax,
                         float inv_qmax, int one_launch, int blocks,
                         int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L{kc, kk, rows, r32, exact};
  if (!layout_ok(L, out) || kc != C * k * k || (requant && !w_amax))
    return (int)cudaErrorInvalidValue;
  const long long elems = (long long)N * H * W * C;
  const long long words = (long long)N * OH * OW * (kk / V);
  if (elems >= INDEX_LIMIT || words >= INDEX_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Result res{(float*)amax, (float*)requant, (const float*)w_amax,
                   req_c, qmax, inv_qmax, 0};
  const bool vec = sc == 1 && C % 4 == 0 && sn % 4 == 0 && sh % 4 == 0 &&
                   sw % 4 == 0 && aligned16(x);
  if (k == 1) {                       // no tap repeats: rows are pixels
    const Rows g{(const float*)x, 1, sn, sh, sw, sc, 1, 1, N * OH * OW,
                 H, W, stride, pad, OH, OW, C, vec ? 1 : 0, 0};
    if (given && !(all_covered(H, 1, stride, pad, OH) &&
                   all_covered(W, 1, stride, pad, OW)))
      return (int)cudaErrorInvalidValue;
    return run_rows(g, L, res, (int8_t*)out, (float*)partials, given, 1u, 0,
                    (unsigned)(N * OH * OW), one_launch, blocks, cluster, s);
  }
  const bool every = all_covered(H, k, stride, pad, OH) &&
                     all_covered(W, k, stride, pad, OW);
  const bool cont = sc == 1 && sw == C && sh == W * C && sn == H * W * C;
  const bool flat = cont && every;
  const bool walk4 = flat ? elems % 4 == 0 && aligned16(x) : vec;
  const Conv g{(const float*)x, sn, sh, sw, sc, N, H, W, C, k, stride, pad,
               OH, OW, vec ? 1 : 0, cont ? 1 : 0, flat ? 1 : 0,
               walk4 ? 1 : 0};
  if (one_launch ? given || !cluster_ok(blocks, cluster)
                 : blocks < 1 || blocks > (given ? MAX_GIVEN : MAX_PARTS) ||
                       !partials || !image || !aligned16(table) ||
                       (given && !every))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (!one_launch) {
    const cudaError_t e = partial_maxima::sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
  }
  Tile T;      // one launch: a tile a block; the gather: 2 blocks a SM
  if (!choose_tile(g, one_launch ? blocks * cluster : 2 * sms, &T))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)kk + (size_t)T.rp * ((T.tr - 1) * stride + k);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (one_launch) {
    static const cudaError_t allowed = allow_smem(one_conv_kernel);
    if (allowed != cudaSuccess) return (int)allowed;
    ClusterLaunch cl(blocks * cluster, cluster, smem, s);
    const cudaError_t e = cudaLaunchKernelEx(&cl.cfg, one_conv_kernel, g, L,
                                             T, res, (int8_t*)out);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  static const cudaError_t allowed = allow_smem(gather_kernel);
  if (allowed != cudaSuccess) return (int)allowed;
  const long long items = elems / (walk4 ? 4 : 1);
  const dim3 image_grid(blocks_for(items, THREADS * UNROLL, MAX_BLOCKS));
  cudaError_t e;
  if (given) {                         // x's writer has finished
    image_kernel<<<image_grid, THREADS, 0, s>>>(
        g, L, T.rp, res, (const float*)partials, blocks, (int8_t*)image,
        (unsigned short*)table);
    e = cudaGetLastError();
  } else {
    partials_conv_kernel<<<blocks, THREADS, 0, s>>>(g, (float*)partials);
    DependentLaunch im(image_grid, 0, s);
    e = cudaLaunchKernelEx(&im.cfg, image_kernel, g, L, T.rp, res,
                           (const float*)partials, blocks, (int8_t*)image,
                           (unsigned short*)table);
  }
  if (e != cudaSuccess) return (int)e;
  DependentLaunch ga(dim3(blocks_for(T.count, 1, MAX_BLOCKS)), smem, s);
  e = cudaLaunchKernelEx(&ga.cfg, gather_kernel, g, L, T,
                         (const int8_t*)image, (const unsigned short*)table,
                         (int8_t*)out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// x an (A, B, R, kc) float32 view with element strides (sa, sb, sr, sk),
// every element's offset below 2^31; out (A*B*R, kk) int8, 16-byte
// aligned; amax A*B floats (per_slice) or one; requant null, or as for
// the conv entry, or per_slice A*B floats, the plain product with w_amax
// A*B floats and req_c f32(1/qw).  one_launch: a cluster of `cluster` a
// slice (per_slice) or `blocks` clusters; otherwise `blocks` partial
// maxima a slice in `partials` (given, one amax: already there, max |x|
// over every element of x).  Returns cudaGetLastError().
int quantize_layout_strided(const void* x, void* out, void* amax,
                            void* requant, const void* w_amax, float req_c,
                            void* partials, int given, int A, int B, int R,
                            int kc, int sa, int sb, int sr, int sk,
                            int per_slice, int kk, int rows, int r32,
                            int exact, int qmax, float inv_qmax,
                            int one_launch, int blocks, int cluster,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L{kc, kk, rows, r32, exact};
  const long long slices = (long long)A * B;
  if (!layout_ok(L, out) || slices > 65535 || (requant && !w_amax))
    return (int)cudaErrorInvalidValue;
  const Result res{(float*)amax, (float*)requant, (const float*)w_amax,
                   req_c, qmax, inv_qmax, per_slice && requant ? 1 : 0};
  const bool vec = sk == 1 && kc % 4 == 0 && sa % 4 == 0 && sb % 4 == 0 &&
                   sr % 4 == 0 && aligned16(x);
  const bool flat = sk == 1 && sr == kc && (B == 1 || sb == R * kc) &&
                    (A == 1 || sa == B * R * kc);
  const Rows g{(const float*)x, 0, sa, sb, sr, sk, A, B, R, 0, 0, 1, 0, 0, 0,
               kc, vec ? 1 : 0, flat ? 1 : 0};
  const unsigned rows_per = per_slice ? (unsigned)R : (unsigned)(slices * R);
  return run_rows(g, L, res, (int8_t*)out, (float*)partials, given,
                  (unsigned)slices, per_slice, rows_per, one_launch, blocks,
                  cluster, s);
}

const char* quantize_layout_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
