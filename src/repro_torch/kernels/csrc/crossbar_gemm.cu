// HURRY crossbar GEMM for Hopper: (M, K) int8 x (K, N) int8 -> (M, N) int32.
//
// Replaces the Pallas kernel `crossbar_gemm` of
// src/repro/kernels/crossbar_gemm.py (`_kernel_exact` and `_kernel_sliced`).
// Both branches live in this file; the Python wrapper
// (src/repro_torch/kernels/crossbar_gemm.py) picks one per call.  A leading
// slice axis, x (S, M, K) x w (S, K, N) -> y (S, M, N), runs in one launch
// (gridDim.z = S x the K split): the counterpart of `jax.vmap` over the
// Pallas call.  The 2-D call (S = 1) compiles without the slice offsets.
//
// Operand layout.  `wgmma` takes 8-bit operands only K-major from shared
// memory, and TMA wants 16-byte-aligned row strides, so both kernels
// take x as (S, M, Kk) and the weight transposed, wt (S, N, Kk), both
// row-major, with K zero-padded to the "kernel layout" Kk: to a multiple
// of 32 on the exact branch, and chunk by chunk (each `rows`-row chunk to
// R32 = roundup(rows, 32) rows, Kk = C * R32) on the sliced branch, so
// that no 32-byte k-step straddles an ADC chunk.  Zero rows add nothing
// to a product or to a bitline count, so both paddings are exact.  The
// packer builds wt once per stage (`PackedStage.wt`); the wrapper lays
// out a plain (K, N) weight itself.
//
// Exact branch (`crossbar_gemm_exact`): no ADC clip can fire, so the
// bit-sliced pipeline is a plain int8 GEMM and the chunk structure drops
// out (int32 addition is associative).  |y| <= Kk * 2^14 < 2^31 for Kk
// below 131072 (the program's K is at most 4940), so int32 cannot
// overflow.  Both operands are K-major in shared memory (128-byte
// swizzle), brought in by TMA (swizzled and zero-filled past M, N and Kk
// by the copy engine) into a ring of k-slabs with an mbarrier a slot, and
// multiplied by `wgmma.mma_async m64nNk32.s32.s8.s8` into int32
// accumulators in registers.  At the program's shapes K is short (27 to
// 4940) and the int32 output four times an input byte a column, so a
// call is bound by device memory: x (M x Kk), read once, and y (M x N x
// 4).  The weight (at most 2.4 MB) stays in the 50 MB L2.
//
// Two designs, chosen a call by `exact_plan` (kernels/crossbar_gemm.py)
// from the shape alone:
//
// * 64 x 64 tiles (`exact_kernel<true>`), one warpgroup a block, 66 KB of
//   shared memory, three blocks an SM: the slice axis (attention's 196 x
//   64 x 196 slices, whose x strip is read once anyway) and 2-D calls
//   whose tiles fill few SMs.  Where the tiles fill at most a quarter of
//   the SMs and K is long, K is split across blocks; the partial sums
//   meet in the zeroed output (one memset) through int32 atomic adds:
//   exact and deterministic, since integer addition is associative.
//   Launched as (M / 64, N / 64, S x splits) blocks, the M tile varying
//   fastest, the blocks in flight sit in one column of tiles and sweep
//   down M, so a 2-D call reads the whole of x once per 64 output
//   columns: ceil(N / 64) times from device memory once x outgrows L2
//   (a b1024 vit_s16 fc1: 24 passes over 77 MB).
// * Wide tiles (`exact_kernel<false>`), for 2-D calls that fill the card:
//   128 x bn tiles, bn in {64, 128, 192, 256}, so that one or a few
//   column tiles cover N; one persistent block an SM walks the tiles in
//   N-first order, so every column tile of an x strip runs while the
//   strip is in L2 and x leaves device memory once.  Warp-specialised: a
//   producer warp keeps up to 8 slabs in flight across tiles (192 KB of
//   ring), two consumer warpgroups take 64 rows each and hand a slot back
//   through its "empty" mbarrier as soon as its products are done, so one
//   slab's wgmma overlaps the next slab's wait and a tile's stores
//   overlap the next tile's loads.
//
// Unsplit tiles store column pairs as 8-byte words, so every warp store
// fills whole 32-byte sectors.  Where the int32 output outweighs x (N
// above ~K / 4), the wide tiles' stores set the pace: on an H100 a b1024
// vit_s16 fc1 takes the same time without its products and a quarter of
// it without its stores; 4-byte stores take twice as long, 16-byte ones
// no less.
//
// Sliced branch (`crossbar_gemm_sliced`): the paper-faithful ADC
// semantics.  For every (input bit i, weight bit j) the {0,1} bitline
// count of a chunk is clipped to [0, adc_max] before the shift-and-add,
// the MSB planes weighted -128.  As the Pallas kernel does, the 8 input
// bit planes are stacked along M and the 8 weight planes along N, and one
// s8 tensor-core product gives all 64 plane-pair counts of a tile: a block
// holds 8 output rows x 32 output columns, i.e. a 64 x 256 count tile
// (`wgmma m64n256k32`, 128 int32 counts a thread).  The bits are expanded
// in the copy stage: TMA brings the raw bytes of x and wt four slabs
// ahead into a ring of raw slots (mbarriers as above); each thread reads
// its 16-byte units back and writes their 8 {0,1} planes into
// double-buffered K-major plane tiles, so device memory sees each operand
// byte once per tile and no mask-packing pass exists.  At a chunk's last
// k-step the counts are clipped in registers and recombined with s_i *
// s_j into 8 running int32 sums a thread; the four warps' partial sums
// over their plane rows meet in shared memory at the end.  Chunks are
// independent until the final sum, so small-M stages spread their chunks
// over blocks (split-K by chunk, atomic int32 adds).  It is bound by the
// count products, 64 plane pairs of 2*M*N*K int8 operations at 1979 TOPS;
// shared memory carries the expanded planes twice (written once, read by
// the tensor cores), which with the per-slab barrier keeps the tensor
// cores well below that rate.

#include <cstdint>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;       // one warpgroup per block
constexpr int BK = 128;            // bytes of K per slab: one swizzle row
constexpr int SM_COUNT = 132;      // H100 SXM

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Generic-proxy writes to shared memory -> visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes, stored with the 128-byte swizzle (16-byte chunk c of row r at
// r * 128 + ((c ^ (r % 8)) * 16), tile base 1024-byte aligned): 8-row
// groups 1024 bytes apart (SBO), the leading offset unused.  Adding
// 32 * kk bytes to the start address selects the kk-th k32 step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// mbarrier: init (`count` arrivals expected), arrive, arrive with an
// expected byte count, and wait for a phase.  The wait traps after about
// 2^26 polls (seconds) instead of hanging the device if a copy never
// lands.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1 << 26)) __trap();
  }
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing its bytes on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma m64nNk32, s32 += s8 x s8, both operands K-major in shared memory;
// scale_d = 0 overwrites the accumulators instead of adding.  Thread t of
// the warpgroup holds d[r] at row 16 * (t / 32) + (t % 32) / 4 + 8 *
// ((r / 2) % 2), column 8 * (r / 4) + 2 * (t % 4) + r % 2.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n192(int (&d)[96], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}


// ---- exact branch -----------------------------------------------------------

// The 64 x 64 design (`exact_kernel<true>`): one warpgroup a block, the
// slice axis and the K split.
constexpr int EX_BM = 64;          // output rows per block (one wgmma M)
constexpr int EX_BN = 64;          // output columns per block
constexpr int EX_STAGES = 4;       // k-slabs in the ring, 3 in flight

constexpr int EX_SLAB_BYTES = (EX_BM + EX_BN) * BK;  // one slab, x + wt
constexpr int EX_SMEM = EX_STAGES * EX_SLAB_BYTES + 8 * EX_STAGES + 1024;

// The wide design (`exact_kernel<false>`): 128 x bn tiles, bn one of
// 64, 128, 192, 256; two consumer warpgroups of 64 rows and one producer
// warp, one persistent block an SM.
constexpr int WD_BM = 128;
constexpr int WD_CONSUMERS = 2 * THREADS;          // warps 0-7
constexpr int WD_THREADS = WD_CONSUMERS + 32;      // warp 8: the producer
constexpr int WD_MAX_STAGES = 8;
constexpr int WD_RING_BYTES = 192 * 1024;
constexpr int WD_SMEM = WD_RING_BYTES + 16 * WD_MAX_STAGES + 1024;

// Slots of the wide ring at tile width bn: as many slabs as fit.
__host__ __device__ constexpr int wide_stages(int bn) {
  return WD_RING_BYTES / ((WD_BM + bn) * BK) < WD_MAX_STAGES
             ? WD_RING_BYTES / ((WD_BM + bn) * BK)
             : WD_MAX_STAGES;
}

// The wgmma of a tile BN columns wide: m64nBNk32, accumulating.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db, 1);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, 1);
  else if constexpr (BN == 192) wgmma_n192(d, da, db, 1);
  else wgmma_n256(d, da, db, 1);
}

// A warpgroup's 64 x BN accumulators into y, warp w's 16 rows from `row`
// (the warpgroup's first row + 16 w).  Thread t holds columns 2 * (t %
// 4) + {0, 1} of each 8-column group: one 8-byte store a pair where N is
// even (full 32-byte sectors a warp), int32 atomic adds where a K split
// shares the tile.
template <int BN>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2],
                                           int32_t* y, int row, int n0,
                                           int M, int N, bool atomic) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < BN / 2; r += 2) {
    const int m = row + (lane >> 2) + 8 * ((r >> 1) & 1);
    const int n = n0 + 8 * (r >> 2) + 2 * (lane & 3);
    if (m >= M) continue;
    int32_t* out = y + (size_t)m * N + n;
    if (atomic) {
      if (n < N) atomicAdd(out, acc[r]);
      if (n + 1 < N) atomicAdd(out + 1, acc[r + 1]);
    } else if ((N & 1) == 0) {
      if (n < N) *reinterpret_cast<int2*>(out) = make_int2(acc[r],
                                                           acc[r + 1]);
    } else {
      if (n < N) out[0] = acc[r];
      if (n + 1 < N) out[1] = acc[r + 1];
    }
  }
}

// The 64 x 64 block (bx, by, bz): output rows bx * 64.., columns by *
// 64.., slice bz / splits, k-slabs [split * kps, split * kps + kps) with
// split = bz % splits.  Thread 0 keeps EX_STAGES slabs in flight; each
// slot has an mbarrier, and a slot is refilled once every warp's wgmma
// on it has completed.
__device__ __forceinline__ void tile64(const CUtensorMap* tx,
                                       const CUtensorMap* tw, int32_t* y,
                                       int M, int N, int Kk, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + EX_STAGES * EX_BM * BK;
  const uint32_t bar0 = a_base + EX_STAGES * EX_SLAB_BYTES;
  const int split = blockIdx.z % splits;
  const int slice = blockIdx.z / splits;       // 0 on a 2-D call
  y += (size_t)slice * M * N;
  const int m0 = blockIdx.x * EX_BM, n0 = blockIdx.y * EX_BN;
  const int nk = (Kk + BK - 1) / BK;
  const int kps = (nk + splits - 1) / splits;
  const int kt0 = split * kps;
  const int T = min(nk, kt0 + kps) - kt0;       // >= 1 (host's split)
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < EX_STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {                // slab t into slot t % STAGES
    const int st = t % EX_STAGES, k0 = (kt0 + t) * BK;
    const uint32_t bar = bar0 + 8 * st;
    mbar_expect_tx(bar, EX_SLAB_BYTES);
    tma_load_3d(a_base + st * EX_BM * BK, tx, bar, k0, m0, slice);
    tma_load_3d(b_base + st * EX_BN * BK, tw, bar, k0, n0, slice);
  };
  if (tid == 0)
    for (int t = 0; t < min(T, EX_STAGES); ++t) issue(t);

  int acc[EX_BN / 2];
#pragma unroll
  for (int r = 0; r < EX_BN / 2; ++r) acc[r] = 0;
  for (int t = 0; t < T; ++t) {
    const int st = t % EX_STAGES;
    mbar_wait(bar0 + 8 * st, (t / EX_STAGES) & 1);
    const uint32_t a_st = a_base + st * EX_BM * BK;
    const uint32_t b_st = b_base + st * EX_BN * BK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_n64(acc, sw128_desc(a_st + 32 * kk), sw128_desc(b_st + 32 * kk),
                1);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();                   // every warp is done with slot st
    if (tid == 0 && t + EX_STAGES < T) issue(t + EX_STAGES);
  }
  store_tile<EX_BN>(acc, y, m0 + 16 * (tid >> 5), n0, M, N, splits > 1);
}

// The wide blocks walk the 128 x BN tiles in N-first order: tile i is
// output rows (i / tiles_n) * 128.., columns (i % tiles_n) * BN.., and
// block b takes tiles b, b + gridDim.x, ...  The blocks in flight hold
// consecutive tiles, i.e. every column tile of a few x strips, so a
// strip leaves device memory once and its other reads hit L2.  Warp 8's
// lane 0 keeps the ring full across tiles: a slot is refilled once its
// "empty" mbarrier has seen all eight consumer warps release it.  Each
// consumer warpgroup multiplies its 64 rows of the slab, releases the
// slot of the slab before once that slab's wgmma has completed (so one
// slab's products overlap the wait for the next), and after the last
// slab of a tile stores its 64 x BN int32 while the producer already
// fetches the next tile.
template <int BN>
__device__ __forceinline__ void wide_tiles(const CUtensorMap* tx,
                                           const CUtensorMap* tw, int32_t* y,
                                           int M, int N, int Kk) {
  constexpr int STAGES = wide_stages(BN);
  constexpr int X_BYTES = WD_BM * BK, SLAB = (WD_BM + BN) * BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + WD_RING_BYTES;
  const uint32_t empty0 = full0 + 8 * WD_MAX_STAGES;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + WD_BM - 1) / WD_BM) * tiles_n;
  const int nk = (Kk + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, WD_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WD_CONSUMERS / 32) {         // the producer
    if ((tid & 31) != 0) return;
    int st = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * WD_BM, n0 = (tile % tiles_n) * BN;
      for (int t = 0; t < nk; ++t) {
        const uint32_t slot = ring + st * SLAB, bar = full0 + 8 * st;
        mbar_wait(empty0 + 8 * st, phase ^ 1);
        mbar_expect_tx(bar, SLAB);
        tma_load_3d(slot, tx, bar, t * BK, m0, 0);
        tma_load_3d(slot + X_BYTES, tw, bar, t * BK, n0, 0);
        if (++st == STAGES) st = 0, phase ^= 1;
      }
    }
    return;
  }

  const int wg = warp >> 2;                // consumer warpgroup: rows 64 wg..
  int st = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * WD_BM, n0 = (tile % tiles_n) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
    int prev = -1;                         // the slot of the slab before
    for (int t = 0; t < nk; ++t) {
      mbar_wait(full0 + 8 * st, phase);
      const uint32_t a_st = ring + st * SLAB + wg * (WD_BM / 2) * BK;
      const uint32_t b_st = ring + st * SLAB + X_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, sw128_desc(a_st + 32 * kk),
                     sw128_desc(b_st + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();                     // the slab before is multiplied
      if (prev >= 0 && (tid & 31) == 0) mbar_arrive(empty0 + 8 * prev);
      prev = st;
      if (++st == STAGES) st = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * prev);
    store_tile<BN>(acc, y, m0 + (WD_BM / 2) * wg + 16 * (warp & 3), n0, M, N,
                   false);
  }
}

// x (S, M, Kk), wt (S, N, Kk) -> y (S, M, N), read through the 3-D tensor
// maps tx (Kk, M, S) and tw (Kk, N, S), whose boxes are 128 bytes of K x
// the tile's rows (tx) and columns (tw), 128-byte swizzled (the wgmma
// layout) and zero-filled past M, N and Kk.  The two instantiations are
// the two designs (the file's header): `true` the 64 x 64 tiles (bn =
// 64) over S slices and `splits` blocks along K, `false` the persistent
// 128 x bn tiles of a 2-D call (splits = 1).
template <bool kTile64>
__global__ void __launch_bounds__(kTile64 ? THREADS : WD_THREADS,
                                  kTile64 ? 3 : 1)
exact_kernel(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             int32_t* __restrict__ y, int M, int N, int Kk, int bn,
             int splits) {
  if constexpr (kTile64) {
    tile64(&tx, &tw, y, M, N, Kk, splits);
  } else {
    switch (bn) {
      case 64: wide_tiles<64>(&tx, &tw, y, M, N, Kk); break;
      case 128: wide_tiles<128>(&tx, &tw, y, M, N, Kk); break;
      case 192: wide_tiles<192>(&tx, &tw, y, M, N, Kk); break;
      default: wide_tiles<256>(&tx, &tw, y, M, N, Kk); break;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a K-major int8 operand (S, rows, Kk): boxes of 128
// bytes of K x `box_rows` rows, zero-filled out of bounds.
int make_map(CUtensorMap* map, const void* base, int S, int rows, int Kk,
             int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)Kk, (cuuint64_t)rows,
                              (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)Kk, (cuuint64_t)rows * Kk};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One exact call under the plan the wrapper chose (`exact_plan` in
// kernels/crossbar_gemm.py, from the shape alone): bm = 64 takes the 64 x
// 64 tiles with `splits` blocks along K, bm = 128 the wide persistent
// tiles of width bn on a 2-D call.
int launch_exact(const int8_t* x, const int8_t* wt, int32_t* y, int S, int M,
                 int N, int Kk, int bm, int bn, int splits,
                 cudaStream_t stream) {
  const int nk = (Kk + BK - 1) / BK;
  const bool tile64 = bm == EX_BM;
  if (tile64) splits = min(splits, nk);
  if (tile64 ? bn != EX_BN || splits < 1
             : bm != WD_BM || S != 1 || splits != 1 ||
                   (bn != 64 && bn != 128 && bn != 192 && bn != 256))
    return (int)cudaErrorInvalidValue;
  const int kps = (nk + splits - 1) / splits;
  splits = (nk + kps - 1) / kps;                // no empty split
  if ((long long)S * splits > 65535 || (N + EX_BN - 1) / EX_BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(y, 0, sizeof(int32_t) * S * M * N,
                                    stream);
    if (e != cudaSuccess) return (int)e;
  }
  CUtensorMap tx, tw;
  int err = make_map(&tx, x, S, M, Kk, bm, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&tw, wt, S, N, Kk, bn, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  auto kernel = tile64 ? exact_kernel<true> : exact_kernel<false>;
  const int smem = tile64 ? EX_SMEM : WD_SMEM;
  static bool opted_in[2];            // the >48 KB opt-in, once a kernel
  if (!opted_in[tile64]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[tile64] = true;
  }
  if (tile64) {
    const dim3 grid((M + EX_BM - 1) / EX_BM, (N + EX_BN - 1) / EX_BN,
                    S * splits);
    kernel<<<grid, THREADS, smem, stream>>>(tx, tw, y, M, N, Kk, bn,
                                            splits);
  } else {
    const long long tiles =
        (long long)((M + WD_BM - 1) / WD_BM) * ((N + bn - 1) / bn);
    const int grid = (int)(tiles < SM_COUNT ? tiles : SM_COUNT);
    kernel<<<grid, WD_THREADS, smem, stream>>>(tx, tw, y, M, N, Kk, bn, 1);
  }
  return (int)cudaGetLastError();
}

// ---- sliced branch ----------------------------------------------------------

constexpr int SL_BM = 8;           // output rows per block: 8 planes -> 64
constexpr int SL_BN = 32;          // output columns per block: 8 planes -> 256
constexpr int SL_A = 8 * SL_BM;    // stacked rows of the count tile
constexpr int SL_B = 8 * SL_BN;    // stacked columns of the count tile
constexpr int SL_AHEAD = 4;        // raw slabs in flight ahead of expansion
constexpr int SL_RAW = SL_AHEAD + 1;              // raw ring slots
constexpr int SL_RAW_BYTES = (SL_BM + SL_BN) * BK;  // one raw slab
constexpr int SL_SMEM =
    2 * (SL_A + SL_B) * BK + SL_RAW * (SL_RAW_BYTES + 8) + 1024;

__device__ __forceinline__ int plane_weight(int i) {
  return i == 7 ? -128 : (1 << i);
}

// Bit planes of 16 raw bytes (operand row q, 16-byte chunk c) into a
// swizzled tile whose plane p occupies rows p * PLANE_ROWS ..: byte b of
// plane p is bit p of byte b, as 0 or 1.
template <int PLANE_ROWS>
__device__ __forceinline__ void expand16(uint32_t tile, uint4 v, int q,
                                         int c) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t o = tile + sw128_offset(p * PLANE_ROWS + q, c);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(o), "r"((v.x >> p) & 0x01010101u),
                    "r"((v.y >> p) & 0x01010101u),
                    "r"((v.z >> p) & 0x01010101u),
                    "r"((v.w >> p) & 0x01010101u) : "memory");
  }
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// x (S, M, Kk), wt (S, N, Kk) in the chunk-padded layout (C chunks of r32
// bytes) -> y (S, M, N), read through the 3-D tensor maps tx (Kk, M, S)
// and tw (Kk, N, S), whose boxes are 128 bytes of K x 8 rows (tx) and x
// 32 rows (tw), unswizzled, zero-filled past M, N and Kk.  Block (bx,
// by, bz): output rows bx * 8.., columns by * 32.., slice bz / splits,
// chunks [split * cps, + cps).  Thread 0 keeps SL_AHEAD raw slabs in
// flight in a ring of SL_RAW slots (one mbarrier each); every thread
// expands the same 16-byte units of each slab: B units t and t + 128
// (row u / 8, chunk u % 8) and, for t < 64, A unit t.  Bytes a slab
// reads past the block's last chunk (the next split's) feed no k-step.
template <bool kSlices>
__global__ void __launch_bounds__(THREADS)
sliced_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              int32_t* __restrict__ y, int M, int N, int Kk, int r32,
              int adc_max, int splits, int cps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + 2 * SL_A * BK;
  const uint32_t raw_base = b_base + 2 * SL_B * BK;
  const uint32_t bar0 = raw_base + SL_RAW * SL_RAW_BYTES;
  const int split = blockIdx.z % splits;
  const int slice = kSlices ? blockIdx.z / splits : 0;
  if (kSlices) y += (size_t)slice * M * N;
  const int m0 = blockIdx.x * SL_BM, n0 = blockIdx.y * SL_BN;
  const int C = Kk / r32;
  const int kbeg = split * cps * r32;
  const int kend = min(C, (split + 1) * cps) * r32;
  const int nslab = (kend - kbeg + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int qa = tid >> 3, qb0 = tid >> 3, qb1 = (tid + THREADS) >> 3;
  const int cu = tid & 7;                 // every unit of a thread: chunk cu
  // this thread's raw units in a ring slot: A row qa, B rows qb0, qb1
  const uint32_t ra = qa * BK + cu * 16;
  const uint32_t rb0 = (SL_BM + qb0) * BK + cu * 16;
  const uint32_t rb1 = (SL_BM + qb1) * BK + cu * 16;

  if (tid == 0) {
    for (int st = 0; st < SL_RAW; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {                // raw slab t into its slot
    if (tid != 0 || t >= nslab) return;
    const int st = t % SL_RAW, k0 = kbeg + t * BK;
    const uint32_t slot = raw_base + st * SL_RAW_BYTES, bar = bar0 + 8 * st;
    mbar_expect_tx(bar, SL_RAW_BYTES);
    tma_load_3d(slot, &tx, bar, k0, m0, slice);
    tma_load_3d(slot + SL_BM * BK, &tw, bar, k0, n0, slice);
  };
  auto expand = [&](int t) {               // raw slab t -> plane buffer
    const int st = t % SL_RAW;
    const uint32_t slot = raw_base + st * SL_RAW_BYTES;
    const int buf = t & 1;
    mbar_wait(bar0 + 8 * st, (t / SL_RAW) & 1);
    if (tid < 64)
      expand16<SL_BM>(a_base + buf * SL_A * BK, ld_shared16(slot + ra), qa,
                      cu);
    expand16<SL_BN>(b_base + buf * SL_B * BK, ld_shared16(slot + rb0), qb0,
                    cu);
    expand16<SL_BN>(b_base + buf * SL_B * BK, ld_shared16(slot + rb1), qb1,
                    cu);
  };

  int cnt[128];
#pragma unroll
  for (int r = 0; r < 128; ++r) cnt[r] = 0;
  int tot[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) tot[o] = 0;
  const int warp = tid >> 5, lane = tid & 31;
  const int si0 = plane_weight(2 * warp), si1 = plane_weight(2 * warp + 1);

  for (int t = 0; t <= SL_AHEAD; ++t) issue(t);
  expand(0);
  fence_proxy_async();
  __syncthreads();

  for (int t = 0; t < nslab; ++t) {
    const int buf = t & 1;
    const uint32_t a_st = a_base + buf * SL_A * BK;
    const uint32_t b_st = b_base + buf * SL_B * BK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const int kabs = kbeg + t * BK + 32 * kk;
      if (kabs < kend) {                   // uniform across the block
        const int pos = (kabs - kbeg) % r32;
        wgmma_n256(cnt, sw128_desc(a_st + 32 * kk),
                   sw128_desc(b_st + 32 * kk), pos == 0 ? 0 : 1);
        if (pos + 32 == r32) {             // a chunk's last step: the ADC
          wgmma_commit();
          wgmma_wait<0>();
          int part0[8], part1[8];
#pragma unroll
          for (int o = 0; o < 8; ++o) part0[o] = part1[o] = 0;
#pragma unroll
          for (int r = 0; r < 128; ++r) {
            const int c = min(cnt[r], adc_max);          // clip
            const int o = ((r >> 2) & 3) * 2 + (r & 1);
            const int sj = plane_weight(r >> 4);
            if ((r >> 1) & 1) part1[o] += sj * c;
            else part0[o] += sj * c;
          }
#pragma unroll
          for (int o = 0; o < 8; ++o)
            tot[o] += si0 * part0[o] + si1 * part1[o];
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
    if (t + 1 < nslab) expand(t + 1);     // the next slab's planes
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();                       // slab t's raw slot is read
    issue(t + 1 + SL_AHEAD);
  }

  // the four warps' sums over their plane rows i meet in shared memory
  int32_t* red = reinterpret_cast<int32_t*>(smem);   // [4][8][32]
  const int mm = lane >> 2;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int nn = 8 * (o >> 1) + 2 * (lane & 3) + (o & 1);
    red[(warp * SL_BM + mm) * SL_BN + nn] = tot[o];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < SL_BM * SL_BN / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    const int m = m0 + idx / SL_BN, n = n0 + idx % SL_BN;
    const int v = red[idx] + red[idx + SL_BM * SL_BN] +
                  red[idx + 2 * SL_BM * SL_BN] + red[idx + 3 * SL_BM * SL_BN];
    if (m < M && n < N) {
      if (splits > 1)
        atomicAdd(y + (size_t)m * N + n, v);
      else
        y[(size_t)m * N + n] = v;
    }
  }
}

// The chunk split of a sliced call: where the tiles fill fewer than all
// the SMs, enough blocks to fill them twice, at most one a chunk.
int sliced_splits(int S, int M, int N, int C) {
  const long long tiles =
      (long long)S * ((M + SL_BM - 1) / SL_BM) * ((N + SL_BN - 1) / SL_BN);
  if (tiles >= SM_COUNT) return 1;
  const int splits = (int)((2 * SM_COUNT + tiles - 1) / tiles);
  return max(1, min(splits, C));
}

}  // namespace

extern "C" {

// x (S, M, Kk), wt (S, N, Kk), y (S, M, N); S = 1 is the 2-D GEMM.
// Kk is a multiple of 32.  (bm, bn, splits) is the call's plan
// (`launch_exact`).
int crossbar_gemm_exact(const void* x, const void* wt, void* y, int S, int M,
                        int N, int Kk, int bm, int bn, int splits,
                        void* stream) {
  if (Kk % 32 != 0) return (int)cudaErrorInvalidValue;
  return launch_exact((const int8_t*)x, (const int8_t*)wt, (int32_t*)y, S, M,
                      N, Kk, bm, bn, splits, (cudaStream_t)stream);
}

// x (S, M, Kk), wt (S, N, Kk) in the chunk-padded layout: Kk = C * r32,
// r32 a multiple of 32.  splits <= 0 picks the chunk split from the shape.
int crossbar_gemm_sliced(const void* x, const void* wt, void* y, int S,
                         int M, int N, int Kk, int r32, int adc_max,
                         int splits, void* stream) {
  if (r32 % 32 != 0 || r32 == 0 || Kk % r32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int C = Kk / r32;
  if (splits <= 0) splits = sliced_splits(S, M, N, C);
  splits = min(splits, C);
  const int cps = (C + splits - 1) / splits;
  splits = (C + cps - 1) / cps;
  if ((long long)S * splits > 65535 || (N + SL_BN - 1) / SL_BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(y, 0, sizeof(int32_t) * S * M * N, s);
    if (e != cudaSuccess) return (int)e;
  }
  CUtensorMap tx, tw;
  int err = make_map(&tx, x, S, M, Kk, SL_BM, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = make_map(&tw, wt, S, N, Kk, SL_BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  auto kernel = S == 1 ? sliced_kernel<false> : sliced_kernel<true>;
  static bool opted_in[2];
  if (!opted_in[S == 1]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SL_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[S == 1] = true;
  }
  const dim3 grid((M + SL_BM - 1) / SL_BM, (N + SL_BN - 1) / SL_BN,
                  S * splits);
  kernel<<<grid, THREADS, SL_SMEM, s>>>(tx, tw, (int32_t*)y, M, N, Kk, r32,
                                        adc_max, splits, cps);
  return (int)cudaGetLastError();
}

// The split a sliced call of this shape takes (splits <= 0 above).
int crossbar_gemm_sliced_splits(int S, int M, int N, int C) {
  return sliced_splits(S, M, N, C);
}

const char* crossbar_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
