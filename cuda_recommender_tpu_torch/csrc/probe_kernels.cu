// Measurement probes for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (ops/build.py, ops/probe_kernels.py).
//
// They replace the Pallas TPU probes of the JAX package's measurement
// scripts (files under scripts/):
//   crtpu_stream_rmw            <- panel_floor.py rmw_call (P1) and the rmw
//                                  floor of panel_kernel_variants.py (P2)
//   crtpu_stream_read, weighted <- panel_floor.py read_call (P1)
//   crtpu_stream_read, NaN-skip <- the read floor of
//                                  panel_kernel_variants.py (P2)
//   crtpu_gather                <- probe_vmem_gather.py run, forms A, B, C
//                                  (P3)
// (P2's rounding variant of K1 lives with K1, in panel_kernels.cu.)
//
// Functions, over an (M, W) row-major bfloat16 panel R:
//   stream_rmw:  R <- bf16(R + 1) in place: one read and one write a cell,
//     no other work. The function is per cell, so both of the Pallas
//     control's grid orders compute it alike; the kernels walk the cells
//     flat.
//   stream_read: g[j] = sum_b w_b * sum_{i in block b} x[i, j] over the
//     512-row blocks b (the last one ragged). Weighted mode: w_b = u[512 b],
//     the u at the block's FIRST row (the Pallas body reads u_ref[0, 0]),
//     x = R. NaN-skip mode: w_b = 1, x = R with NaN read as 0.
// and, for a float32 table tab and an int32 index tile idx (rows, L):
//   gather A: out[r, l] = tab[idx[r, l], l]   tab (S, L)
//   gather B: out[r, l] = tab[idx[r, l]]      tab flat, S * L entries
//   gather C: out[r, :] = tab[idx[r, 0], :]   whole rows, one warp a row
// An index outside the table reads 0 (no fault; ops/probe_kernels.py's
// plain versions do the same).
//
// What bounds them on an H100: memory, all four. The streams move 2 + 2
// (rmw) or 2 (read) bytes a cell and do one add; the gathers read 4 index
// bytes and write 4 output bytes an element, plus random 4-byte reads of a
// table that the 50 MB L2 holds at the probes' shapes.
//
// The rmw walks the panel flat (its function is per cell, so rows need no
// alignment) in 16-byte vectors, 4 a thread loaded before any store. Up to
// 7 cells before the first 16-byte boundary and after the last one go one
// a thread of block 0.
//
// The read (stream_read_kernel, one template over the mode and the row
// path) gives each lane 8 consecutive cells of a row (one 16-byte vector),
// a warp 256 columns (248 on the shifted path), and a block of 8 warps one
// such column tile and a contiguous range of whole 512-row blocks; warp y
// sums the rows y, y + 8, ... of each 512-row block, 4 rows loaded before
// any is used. ops/probe_kernels.py::read_plan cuts each tile's
// ceil(M / 512) row blocks into ``ranges`` ranges of sizes within one,
// block b taking tile b mod tiles (neighbouring tiles dispatched side by
// side). Two row paths, a template parameter each, chosen by the wrapper:
//   * aligned (the panel starts on a 16-byte boundary and W % 8 == 0, so
//     every row does): each lane loads its vector straight. The grid is
//     sized to the card, not to the panel: tiles x ranges about the blocks
//     resident at once (the kernel's occupancy x the SMs), one wave;
//   * shifted (any other view): a lane's first cell lies kOff bytes past a
//     16-byte boundary, and kOff is the same for every row a warp reads
//     (8 rows are 16 W bytes), so a switch on the warp's offset picks one
//     of 8 instances of the row loop: the lane loads the aligned vector
//     that holds its first cell, takes the next one's first words from its
//     right-hand neighbour by shuffles (lane 31 owns no cells: it loads
//     the vector after lane 30's, so that no lane holds two vectors a row)
//     and shifts the pair into place by constants (no shuffle or shift at
//     offset 0). A vector is loaded only where it starts before the row's
//     end: an aligned vector that holds a cell of the panel lies inside
//     the panel's allocation (whose granules are multiples of 16 bytes). A
//     lane's cells past W or past its tile are masked once a tile, not a
//     cell. Neighbouring tiles share the cache lines at their boundary, so
//     a block takes about 4 row blocks, several waves: blocks dispatched
//     tile by tile then read the same rows at the same time, and the L2
//     serves the shared lines (one wave of long blocks, which drift apart,
//     ran 7% slower on the H100: PERF.md).
// NaN-skip mode zeroes a pair word's NaN halves before the unpack
// (zero_nan_pair): adding +0.0 to a sum that starts at +0.0 gives the bits
// skipping the cell does. Weighted mode sums each 512-row block apart and
// adds it times u at the block's first row. A block writes its range's
// column sums (its 8 warps' in warp order) to its row of ``gpart``; the
// last block of a tile to finish (a per-tile counter, __threadfence, no
// float atomics; the counter resets itself) adds the tile's rows of
// ``gpart`` in a fixed order: warp w the ranges w, w + 8, ... in order,
// then the 8 warps' sums in warp order (read_sum_order). The result is the
// same bits from one call to the next, whatever order the blocks run in.
// No TMA ring: bulk copies streamed at 86-88% of the bound on the H100,
// 16-byte loads with enough bytes in flight at 88-91% (PERF.md).
//
// Gathers A and B walk the index and the output as 16-byte streams over a
// grid-stride loop: a thread takes a step of 4 (L2 path) or 8 (shared
// memory) consecutive elements, with 16-byte index loads and 16-byte
// output stores, both marked evict-first, and all the step's table reads
// issued before any use; the index of the next steps is loaded before the
// table reads of this one. Where the output does not start on a 16-byte
// boundary, up to 3 head elements and the tail go one a thread; where the
// index's alignment differs from the output's, it is read 4 bytes at a
// time. The table's bytes choose between two paths
// (ops/probe_kernels.py::gather_plan):
//   * shared memory, where the table plus kSmemReserve bytes fits in a
//     block's opt-in shared memory (232,448 bytes on the H100; a 417 x 128
//     f32 table, 213,504 bytes, at the bench's rows tail): a block an SM
//     holds a copy, so that no element costs a random L2 or L1 read. Form
//     B (and form A on a view off a 16-byte boundary, or L not a multiple
//     of 32) copies the whole table by bulk asynchronous copies that
//     complete on an mbarrier: blocks run in clusters of 4, each reading a
//     quarter of the table from L2 and multicasting it to the cluster. A
//     block loads its first 8 steps' index before it waits. A copy in
//     every SM still moves 28 MB into the SMs at the rows tail, about as
//     many bytes as the index and output streams themselves, so this form
//     stays near 2x its bound (PERF.md). Form A
//     reads lane l from column l only: its blocks split the columns into
//     groups of 32 lanes, each block serving one group of every row and
//     copying only those columns (S x 128 bytes, a quarter of the bytes at
//     L = 128) with 16-byte loads. Form A's lane l lies in
//     bank l mod 32, so the 8 lanes of a step would put a warp's reads on 4
//     banks (8-way conflicts); each thread therefore walks its 8 lanes from
//     a rotation of (thread / 4) mod 8, which spreads a warp's reads over
//     all 32 banks. Form B's banks are random.
//   * L2, for larger tables (the cols tail's 3.84 MB, the probe's 4 MB): the
//     table is read through the read-only path (L1-allocating: a table that
//     fits in L1 is served from it) under an L2 evict-last policy, so that
//     the streamed index and output do not push it out of the L2. A random
//     table read still costs one 32-byte L2 sector: about 3 M of them at
//     the cols tail, which set the pace (one thread an element runs at the
//     same rate). The grid is kL2MinBlocks blocks of
//     kL2Threads an SM (the launch bounds' occupancy), with an L1-heavy
//     carve-out. Steps of 4 elements, not 8: twice the misses in flight a
//     thread ran slower at every shape the bench gives this path.
// Form C reads the table through the read-only cache (__ldg), one warp a
// row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kTileRows = 512;     // the Pallas probes' block height (BM)
constexpr int kVecElems = 8;       // bf16 cells in a 16-byte vector
constexpr int kVecUnroll = 4;      // vectors in flight a thread (rmw)
constexpr int kVecThreads = 256;   // the rmw's block
// stream_read (ops/probe_kernels.py mirrors these as READ_*): warps a
// block, a tile's columns on each row path (a warp's row: 32 lanes of 8
// cells; on the shifted path lane 31 only loads the vector after lane
// 30's), and rows a thread loads before it uses any
constexpr int kReadWarps = 8;
constexpr int kReadThreads = kReadWarps * 32;
constexpr int kReadTileCols = 32 * kVecElems;
constexpr int kShiftTileCols = kReadTileCols - kVecElems;
constexpr int kRowBatch = 4;
constexpr int kGatherThreads = 256;    // form C
// gathers A and B: elements a thread takes a step, threads a block, and
// steps of index a thread keeps in flight, on each path
constexpr int kL2Step = 4, kL2Threads = 128;
constexpr int kL2MinBlocks = 8;        // the L2 path's blocks an SM
constexpr int kSmemStep = 8;
constexpr int kTableThreads = 256, kTableDepth = 8;   // whole-table copies
constexpr int kTableCluster = 4;       // blocks that share one table copy
constexpr int kColsThreads = 512, kColsDepth = 4;     // column-group copies
constexpr int kColLanes = 32;          // lanes of a column group
// shared memory besides the table: the mbarrier and a zero (16 bytes, so
// that the table's copy starts on a 16-byte boundary), and 16 bytes for a
// table that does not start on one (the copy starts at the boundary below)
constexpr int kSmemReserve = 32;
constexpr int kSmemHead = 16;          // bytes before the table's copy
constexpr int kSmemZero = 2;           // the zero's float offset
constexpr int kMaxDevices = 64;        // devices whose attributes are cached

// bf16(x + 1) of the two bf16 cells packed in ``w`` (low half first).
__device__ __forceinline__ uint32_t add_one_bf16x2(uint32_t w) {
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fadd_rn(__uint_as_float(w << 16), 1.f),
                            __fadd_rn(__uint_as_float(w & 0xFFFF0000u), 1.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void add_one_bf16(__nv_bfloat16* p) {
  *p = __float2bfloat16_rn(__fadd_rn(__bfloat162float(*p), 1.f));
}

// ---- mbarriers (the gathers' table copies) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One poll of the mbarrier at ``bar``: whether its phase of ``parity`` has
// completed.
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// ---- the streams: see the file's head ----

// stream_rmw over the panel's n cells as one flat run: a block owns
// kVecThreads * kVecUnroll consecutive vectors of ``body``, each thread
// kVecUnroll of them (a warp's loads coalesced), all loaded before any
// store. Block 0 also does the ``head`` cells before ``body`` (up to the
// first 16-byte boundary) and the ``ntail`` cells after it, one a thread.
__global__ void __launch_bounds__(kVecThreads)
    stream_rmw_vec_kernel(__nv_bfloat16* R, int head, uint4* body,
                          long long nvec, __nv_bfloat16* tail, int ntail) {
  const long long v0 =
      static_cast<long long>(blockIdx.x) * kVecThreads * kVecUnroll +
      threadIdx.x;
  uint4 x[kVecUnroll];
#pragma unroll
  for (int k = 0; k < kVecUnroll; ++k) {
    const long long v = v0 + k * kVecThreads;
    if (v < nvec) x[k] = body[v];
  }
#pragma unroll
  for (int k = 0; k < kVecUnroll; ++k) {
    const long long v = v0 + k * kVecThreads;
    if (v < nvec)
      body[v] = make_uint4(add_one_bf16x2(x[k].x), add_one_bf16x2(x[k].y),
                           add_one_bf16x2(x[k].z), add_one_bf16x2(x[k].w));
  }
  if (blockIdx.x == 0) {
    if (static_cast<int>(threadIdx.x) < head) add_one_bf16(R + threadIdx.x);
    if (static_cast<int>(threadIdx.x) < ntail)
      add_one_bf16(tail + threadIdx.x);
  }
}

// The bf16 pair word ``w`` with each NaN half replaced by +0.0. A bf16 is
// NaN iff its bits without the sign exceed 0x7F80: in (w | 0x80008000) -
// 0x7F817F81 bit 15 (31) is set exactly where the low (high) half is NaN,
// with no borrow across the halves (the low half is at least 0x8000), and
// prmt's sign replication (selector nibbles 9 and B) spreads each of the
// two bits over its half.
__device__ __forceinline__ uint32_t zero_nan_pair(uint32_t w) {
  const uint32_t t = (w | 0x80008000u) - 0x7F817F81u;
  uint32_t nan;
  asm("prmt.b32 %0, %1, 0, 0xBB99;" : "=r"(nan) : "r"(t));
  return w & ~nan;
}

// The 8 cells of the pair words ``v`` added to ``s`` in cell order (NaN
// read as +0.0 in NaN-skip mode).
template <bool kNanSkip>
__device__ __forceinline__ void add_cells(const uint32_t (&v)[4],
                                          float (&s)[kVecElems]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t w = kNanSkip ? zero_nan_pair(v[j]) : v[j];
    s[2 * j] = __fadd_rn(s[2 * j], __uint_as_float(w << 16));
    s[2 * j + 1] = __fadd_rn(s[2 * j + 1], __uint_as_float(w & 0xFFFF0000u));
  }
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ``nrows`` rows of the lane's cells, 8 rows apart from ``cell`` (the
// lane's first cell of warp y's first row; the aligned path), added to
// ``s``, kRowBatch rows loaded before any is used. A row past the last
// adds zeros, which leaves the sums' bits as they are.
template <bool kNanSkip>
__device__ __forceinline__ void rows_aligned(const __nv_bfloat16* cell,
                                             long long W, int nrows,
                                             float (&s)[kVecElems]) {
  const long long step = kReadWarps * W;  // cells from a warp's row to its next
  for (int i = 0; i < nrows; i += kRowBatch) {
    uint4 x[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k)
      x[k] = i + k < nrows ? ldg16(cell + (i + k) * step)
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const uint32_t v[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
      add_cells<kNanSkip>(v, s);
    }
  }
}

// The same on the shifted path: the lane's first cell lies kOff bytes
// past the 16-byte boundary ``al`` (the same kOff for every row of the
// warp); each lane loads that aligned vector (where ``lo``: it starts
// before the row's end, the same in every row of the warp) and takes the
// first words of the next one from its right-hand neighbour (lane 31 owns
// no cells: it loads the vector after lane 30's). ``keep`` masks the
// lane's cells past W or past the tile (a pair word each).
template <bool kNanSkip, int kOff>
__device__ __forceinline__ void rows_shifted(const char* al, bool lo,
                                             long long W, int nrows,
                                             const uint32_t (&keep)[4],
                                             float (&s)[kVecElems]) {
  constexpr int kWord = kOff / 4;        // words the cells start in
  constexpr bool kHalf = kOff % 4 != 0;  // and a half word
  constexpr int kNext = kWord + kHalf;   // words wanted from the next vector
  const long long step = 2LL * kReadWarps * W;  // bytes to the warp's next row
  for (int i = 0; i < nrows; i += kRowBatch) {
    uint4 a[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k)
      a[k] = i + k < nrows && lo ? ldg16(al + (i + k) * step)
                                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      uint32_t w[8] = {a[k].x, a[k].y, a[k].z, a[k].w, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < kNext; ++j)
        w[4 + j] = __shfl_down_sync(0xffffffffu, w[j], 1);
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (kHalf ? __funnelshift_r(w[kWord + j], w[kWord + j + 1], 16)
                      : w[kWord + j]) &
               keep[j];
      add_cells<kNanSkip>(v, s);
    }
  }
}

// One 512-row block's rows [r0, r1) of the lane's cells, added to ``s``.
template <bool kNanSkip, bool kAligned, int kOff>
__device__ __forceinline__ void read_rows(const __nv_bfloat16* R, long long W,
                                          int c0, int r0, int r1,
                                          const uint32_t (&keep)[4],
                                          float (&s)[kVecElems]) {
  const int y = threadIdx.x / 32;
  const int nrows = (r1 - r0 - y + kReadWarps - 1) / kReadWarps;
  const __nv_bfloat16* row = R + static_cast<long long>(r0 + y) * W;
  if (kAligned) {
    if (c0 < W) rows_aligned<kNanSkip>(row + c0, W, nrows, s);
    return;
  }
  const char* al = reinterpret_cast<const char*>(row + c0) - kOff;
  // lane 31 owns no cells: at offset 0 nobody wants its vector
  const bool lo = al < reinterpret_cast<const char*>(row + W) &&
                  (kOff != 0 || (threadIdx.x & 31) != 31);
  rows_shifted<kNanSkip, kOff>(al, lo, W, nrows, keep, s);
}

// A block's range of 512-row blocks [b0, b1) of its lane cells from c0:
// NaN-skip sums every row into ``acc``; weighted sums each block apart and
// adds it times u at the block's first row.
template <bool kNanSkip, bool kAligned, int kOff>
__device__ __forceinline__ void read_range(const __nv_bfloat16* R,
                                           const float* __restrict__ u, int M,
                                           long long W, int c0, int b0,
                                           int b1, const uint32_t (&keep)[4],
                                           float (&acc)[kVecElems]) {
  for (int b = b0; b < b1; ++b) {
    const int r0 = b * kTileRows, r1 = min(M, r0 + kTileRows);
    if (kNanSkip) {
      read_rows<kNanSkip, kAligned, kOff>(R, W, c0, r0, r1, keep, acc);
      continue;
    }
    float s[kVecElems] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    read_rows<kNanSkip, kAligned, kOff>(R, W, c0, r0, r1, keep, s);
    const float wt = __ldg(u + r0);
#pragma unroll
    for (int e = 0; e < kVecElems; ++e)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(s[e], wt));
  }
}

// stream_read: see the file's head. Block b takes column tile b mod tiles
// (kTileCols columns) and range b / tiles of ``ranges`` over the
// ceil(M / 512) row blocks (range k: [k nb / ranges, (k + 1) nb /
// ranges)); ``gpart`` holds ranges x W floats, ``count`` a zero a tile
// (and is left so).
template <bool kNanSkip, bool kAligned>
__global__ void __launch_bounds__(kReadThreads)
    stream_read_kernel(const __nv_bfloat16* __restrict__ R,
                       const float* __restrict__ u, float* __restrict__ gpart,
                       unsigned* __restrict__ count, float* __restrict__ g,
                       int M, int W, int ranges) {
  constexpr int kTileCols = kAligned ? kReadTileCols : kShiftTileCols;
  __shared__ float sg[kReadWarps][kReadTileCols];
  __shared__ bool last_block;
  const int tiles = (W + kTileCols - 1) / kTileCols;
  const int tile = blockIdx.x % tiles, range = blockIdx.x / tiles;
  const long long nb = (M + kTileRows - 1) / kTileRows;
  const int b0 = static_cast<int>(range * nb / ranges);
  const int b1 = static_cast<int>((range + 1) * nb / ranges);
  const int t = threadIdx.x, y = t / 32, lane = t % 32;
  const int c0 = tile * kTileCols + lane * kVecElems;
  const int cend = min(W, (tile + 1) * kTileCols);  // past the tile's last
  // the lane's cells past the tile, masked a pair word at a time (shifted
  // path; lane 31's all)
  uint32_t keep[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = cend - c0 - 2 * j;  // the pair's cells left in the tile
    keep[j] = n >= 2 ? 0xFFFFFFFFu : n == 1 ? 0x0000FFFFu : 0u;
  }
  float acc[kVecElems] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (kAligned) {
    read_range<kNanSkip, true, 0>(R, u, M, W, c0, b0, b1, keep, acc);
  } else {
    // the warp's rows all start the same bytes past a 16-byte boundary
    const int off = static_cast<int>(
        (reinterpret_cast<uintptr_t>(R) + 2LL * y * W + 2LL * c0) & 15);
    switch (off) {
#define CRTPU_READ_OFF(o)                                                   \
  case o:                                                                   \
    read_range<kNanSkip, false, o>(R, u, M, W, c0, b0, b1, keep, acc);     \
    break;
      CRTPU_READ_OFF(0)
      CRTPU_READ_OFF(2)
      CRTPU_READ_OFF(4)
      CRTPU_READ_OFF(6)
      CRTPU_READ_OFF(8)
      CRTPU_READ_OFF(10)
      CRTPU_READ_OFF(12)
      CRTPU_READ_OFF(14)
#undef CRTPU_READ_OFF
    }
  }
  // the range's column sums: the 8 warps' in warp order
  float4* mine = reinterpret_cast<float4*>(&sg[y][lane * kVecElems]);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int c = tile * kTileCols + t;
  float p = 0.f;
#pragma unroll
  for (int k = 0; k < kReadWarps; ++k) p = __fadd_rn(p, sg[k][t]);
  if (t < kTileCols && c < W)
    gpart[static_cast<long long>(range) * W + c] = p;
  __threadfence();
  __syncthreads();
  if (t == 0) last_block = atomicAdd(count + tile, 1u) == ranges - 1u;
  __syncthreads();
  if (!last_block) return;
  // the tile's last block: warp y adds the ranges y, y + 8, ... in order,
  // lane l the columns l, l + 32, ..., then the warps' sums in warp order
  __threadfence();
  const int cl = tile * kTileCols + lane;  // the lane's first column
  float q[kVecElems] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = y; k < ranges; k += kReadWarps) {
    const float* row = gpart + static_cast<long long>(k) * W + cl;
#pragma unroll
    for (int e = 0; e < kVecElems; ++e)
      if (cl + 32 * e < cend) q[e] = __fadd_rn(q[e], __ldcg(row + 32 * e));
  }
#pragma unroll
  for (int e = 0; e < kVecElems; ++e) sg[y][lane + 32 * e] = q[e];
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kReadWarps; ++k) total = __fadd_rn(total, sg[k][t]);
  if (t < kTileCols && c < W) g[c] = total;
  if (t == 0) count[tile] = 0u;
}

// ---- gathers A (kMode 0) and B (1) ----

// The kStep index entries at p: 16-byte loads where p is 16-byte aligned
// (kVec), else 4-byte ones; streamed (evict-first, __ldcs).
template <int kStep, bool kVec>
__device__ __forceinline__ void load_step(const int32_t* p, int (&ix)[kStep]) {
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kStep / 4; ++k) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(p) + k);
      ix[4 * k] = a.x;
      ix[4 * k + 1] = a.y;
      ix[4 * k + 2] = a.z;
      ix[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kStep; ++j) ix[j] = __ldcs(p + j);
  }
}

// 16-byte stores at p (16-byte aligned), streamed (evict-first).
template <int kStep>
__device__ __forceinline__ void store_step(float* p, const float (&x)[kStep]) {
#pragma unroll
  for (int k = 0; k < kStep / 4; ++k)
    __stcs(reinterpret_cast<float4*>(p) + k,
           make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]));
}

// Element i of form kMode at lane l: its position in the flat table, and
// whether it lies inside it (0 <= i < S for A, 0 <= i < S * L for B).
template <int kMode>
__device__ __forceinline__ bool table_pos(long long i, int l, int L,
                                          long long n_tab, long long& at) {
  at = kMode == 0 ? i * L + l : i;
  return i >= 0 && (kMode == 0 ? i < n_tab : i < n_tab * L);
}

// a[k] <- a[(k + r) mod 8], in three stages of selects (no local memory).
template <typename T>
__device__ __forceinline__ void rotate8(T (&a)[kSmemStep], int r) {
#pragma unroll
  for (int s = 1; s < kSmemStep; s *= 2) {
    T b[kSmemStep];
#pragma unroll
    for (int k = 0; k < kSmemStep; ++k)
      b[k] = (r & s) ? a[(k + s) % kSmemStep] : a[k];
#pragma unroll
    for (int k = 0; k < kSmemStep; ++k) a[k] = b[k];
  }
}

__device__ __forceinline__ uint64_t l2_evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// A table read through the read-only path under the cache policy ``pol``.
// ``p`` must be a valid address: callers select a safe one rather than
// branch around the load.
__device__ __forceinline__ float ld_table(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

// ``bytes`` (a multiple of 16) from the 16-byte-aligned global ``src`` to
// the 16-byte-aligned shared ``dst`` of every block of the cluster in
// ``blocks`` (a bit mask of cluster ranks), by the bulk copy engine: one
// read, delivered to each block at the same offset, each completing
// ``bytes`` transactions on its own mbarrier at ``bar``.
__device__ __forceinline__ void bulk_multicast_g2s(uint32_t dst,
                                                   const void* src,
                                                   uint32_t bytes,
                                                   uint32_t bar,
                                                   uint16_t blocks) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(blocks)
      : "memory");
}

// Every thread of every block of the cluster arrives; the shared-memory
// writes before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Elements before the first step (``head``, up to 3) and after the last
// (``ntail``, up to kStep - 1): one a thread of block 0, thread t < head
// taking element t and the next ones the tail. The table is ``tab`` in
// global memory (L2 path) or the shared copy ``sf`` from float ``base`` on.
template <int kMode, int kStep, bool kShared>
__device__ __forceinline__ void gather_edges(
    const float* tab, const float* sf, int base, uint64_t pol,
    const int32_t* __restrict__ idx, float* __restrict__ out, int head,
    long long nvec, int ntail, int L, long long n_tab) {
  const int t = threadIdx.x;
  if (blockIdx.x != 0 || t >= head + ntail) return;
  const long long e = t < head ? t : head + nvec * kStep + (t - head);
  long long at;
  const bool ok = table_pos<kMode>(idx[e], static_cast<int>(e % L), L, n_tab,
                                   at);
  if (kShared)
    out[e] = sf[ok ? base + static_cast<int>(at) : kSmemZero];
  else
    out[e] = ok ? ld_table(tab + at, pol) : 0.f;
}

// The L2 path: see the file's head. ``nvec`` steps of kL2Step elements
// start at element ``head``; kVec: the index is 16-byte aligned there.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kL2Threads, kL2MinBlocks)
    gather_l2_kernel(const float* __restrict__ tab,
                     const int32_t* __restrict__ idx, float* __restrict__ out,
                     int head, long long nvec, int ntail, int L,
                     long long n_tab) {
  const uint64_t pol = l2_evict_last_policy();
  const long long stride = static_cast<long long>(gridDim.x) * kL2Threads;
  long long v = static_cast<long long>(blockIdx.x) * kL2Threads + threadIdx.x;
  const int32_t* ip = idx + head;
  int ix[kL2Step];
  if (v < nvec) load_step<kL2Step, kVec>(ip + v * kL2Step, ix);
  for (; v < nvec; v += stride) {
    int nx[kL2Step] = {};
    if (v + stride < nvec)
      load_step<kL2Step, kVec>(ip + (v + stride) * kL2Step, nx);
    const long long e0 = head + v * kL2Step;
    int l = kMode == 0 ? static_cast<int>(e0 % L) : 0;
    float x[kL2Step];
#pragma unroll
    for (int j = 0; j < kL2Step; ++j) {
      long long at;
      const bool ok = table_pos<kMode>(ix[j], l, L, n_tab, at);
      x[j] = ld_table(tab + (ok ? at : 0), pol);
      x[j] = ok ? x[j] : 0.f;
      if (kMode == 0) l = l + 1 == L ? 0 : l + 1;
    }
    store_step<kL2Step>(out + e0, x);
#pragma unroll
    for (int j = 0; j < kL2Step; ++j) ix[j] = nx[j];
  }
  gather_edges<kMode, kL2Step, false>(tab, nullptr, 0, pol, idx, out, head,
                                      nvec, ntail, L, n_tab);
}

// The shared-memory path with the whole table in each block (form B, and
// form A where ``gather_cols_kernel`` does not apply): see the file's head.
// Dynamic shared memory holds the mbarrier (bytes 0-7), a zero (float 2)
// and, from byte 16, the table's bytes from the 16-byte boundary at or
// below ``tab`` on. The blocks run in clusters of kTableCluster: each
// block reads a kTableCluster-th of the table from L2 and multicasts it to
// its cluster, so that the L2 serves each cluster's copy once.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kTableThreads, 1)
    gather_table_kernel(const float* __restrict__ tab,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out, int head, long long nvec,
                        int ntail, int L, long long n_tab) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  const uintptr_t ta = reinterpret_cast<uintptr_t>(tab);
  const uint32_t lead = static_cast<uint32_t>(ta & 15);
  const uint32_t bytes = static_cast<uint32_t>(
      (lead + static_cast<uint32_t>(n_tab * L) * 4u + 15u) & ~15u);
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    sf[kSmemZero] = 0.f;
    mbar_expect_tx(bar, bytes);
  }
  cluster_sync();  // every block's mbarrier is initialised
  if (threadIdx.x == 0) {
    const uint32_t per =
        (bytes / 16 + kTableCluster - 1) / kTableCluster * 16;
    const uint32_t b0 = cluster_rank() * per;
    if (b0 < bytes)
      bulk_multicast_g2s(bar + kSmemHead + b0,
                         reinterpret_cast<const char*>(ta - lead) + b0,
                         min(per, bytes - b0), bar,
                         (1u << kTableCluster) - 1);
  }
  const int base = static_cast<int>((kSmemHead + lead) / 4);  // tab[0]
  const int rot = (threadIdx.x >> 2) & (kSmemStep - 1);
  const long long stride = static_cast<long long>(gridDim.x) * kTableThreads;
  long long v = static_cast<long long>(blockIdx.x) * kTableThreads +
                threadIdx.x;
  // kTableDepth steps' index in flight while the table arrives
  const int32_t* ip = idx + head;
  int q[kTableDepth][kSmemStep];  // q[0] is the step in use
#pragma unroll
  for (int d = 0; d < kTableDepth; ++d)
    if (v + d * stride < nvec)
      load_step<kSmemStep, kVec>(ip + (v + d * stride) * kSmemStep, q[d]);
  mbar_wait(bar, 0);
  for (; v < nvec; v += stride) {
    int ix[kSmemStep];
#pragma unroll
    for (int j = 0; j < kSmemStep; ++j) ix[j] = q[0][j];
#pragma unroll
    for (int d = 0; d + 1 < kTableDepth; ++d)
#pragma unroll
      for (int j = 0; j < kSmemStep; ++j) q[d][j] = q[d + 1][j];
    const long long w = v + kTableDepth * stride;
    if (w < nvec)
      load_step<kSmemStep, kVec>(ip + w * kSmemStep, q[kTableDepth - 1]);
    const long long e0 = head + v * kSmemStep;
    int l = kMode == 0 ? static_cast<int>(e0 % L) : 0;
    int off[kSmemStep];
#pragma unroll
    for (int j = 0; j < kSmemStep; ++j) {
      long long at;
      const bool ok = table_pos<kMode>(ix[j], l, L, n_tab, at);
      off[j] = ok ? base + static_cast<int>(at) : kSmemZero;
      if (kMode == 0) l = l + 1 == L ? 0 : l + 1;
    }
    if (kMode == 0) rotate8(off, rot);
    float x[kSmemStep];
#pragma unroll
    for (int j = 0; j < kSmemStep; ++j) x[j] = sf[off[j]];
    if (kMode == 0) rotate8(x, (kSmemStep - rot) & (kSmemStep - 1));
    store_step<kSmemStep>(out + e0, x);
  }
  gather_edges<kMode, kSmemStep, true>(nullptr, sf, base, 0, idx, out, head,
                                       nvec, ntail, L, n_tab);
  cluster_sync();  // no block leaves while its multicasts are in flight
}

// Form A on the shared-memory path where the table, the index and the
// output start on 16-byte boundaries and L is a multiple of kColLanes: a
// lane reads only its own column, so block b serves the column group g = b
// mod (L / 32) of every index row and copies only those 32 columns of the
// table (S x 128 bytes: a quarter of the table at L = 128), with 16-byte
// loads by all its threads. A step is 8 lanes of one row; 4 steps cover a
// row's group, a warp 8 rows. The rotation of the file's head keeps a
// warp's shared reads on 32 banks.
__global__ void __launch_bounds__(kColsThreads, 1)
    gather_cols_kernel(const float* __restrict__ tab,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, long long rows, int L,
                       long long n_tab) {
  constexpr int kSteps = kColLanes / kSmemStep;  // steps a row's group
  extern __shared__ __align__(16) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  const int groups = L / kColLanes;
  const int g = blockIdx.x % groups;
  const long long per = gridDim.x / groups;  // blocks of this group
  if (threadIdx.x == 0) sf[kSmemZero] = 0.f;
  float4* cols = reinterpret_cast<float4*>(smem + kSmemHead);
  for (long long k = threadIdx.x; k < n_tab * (kColLanes / 4);
       k += kColsThreads) {
    const long long i = k / (kColLanes / 4);
    cols[k] = __ldg(reinterpret_cast<const float4*>(tab + i * L +
                                                    g * kColLanes) +
                    k % (kColLanes / 4));
  }
  // step w: row w / kSteps, lanes g * 32 + 8 * (w mod kSteps) on
  const long long nvec = rows * kSteps;
  const long long stride = per * kColsThreads;
  long long v = (blockIdx.x / groups) * kColsThreads + threadIdx.x;
  const int32_t* gidx = idx + g * kColLanes;
  // kColsDepth steps' index a thread in flight: q[0] is the step in use
  int q[kColsDepth][kSmemStep];
#pragma unroll
  for (int d = 0; d < kColsDepth; ++d) {
    const long long w = v + d * stride;
    if (w < nvec)
      load_step<kSmemStep, true>(
          gidx + (w / kSteps) * L + (w % kSteps) * kSmemStep, q[d]);
  }
  __syncthreads();  // the columns are in shared memory
  const int base = kSmemHead / 4;
  const int rot = (threadIdx.x >> 2) & (kSmemStep - 1);
  for (; v < nvec; v += stride) {
    int ix[kSmemStep];
#pragma unroll
    for (int j = 0; j < kSmemStep; ++j) ix[j] = q[0][j];
#pragma unroll
    for (int d = 0; d + 1 < kColsDepth; ++d)
#pragma unroll
      for (int j = 0; j < kSmemStep; ++j) q[d][j] = q[d + 1][j];
    const long long w = v + kColsDepth * stride;
    if (w < nvec)
      load_step<kSmemStep, true>(
          gidx + (w / kSteps) * L + (w % kSteps) * kSmemStep,
          q[kColsDepth - 1]);
    const int s8 = static_cast<int>(v % kSteps) * kSmemStep;
    int off[kSmemStep];
#pragma unroll
    for (int j = 0; j < kSmemStep; ++j) {
      const int i = ix[j];
      off[j] = i >= 0 && i < n_tab ? base + i * kColLanes + s8 + j
                                   : kSmemZero;
    }
    rotate8(off, rot);
    float x[kSmemStep];
#pragma unroll
    for (int j = 0; j < kSmemStep; ++j) x[j] = sf[off[j]];
    rotate8(x, (kSmemStep - rot) & (kSmemStep - 1));
    store_step<kSmemStep>(
        out + (v / kSteps) * L + g * kColLanes + s8, x);
  }
}

// Gather form C: one warp a row copies table row idx[r, 0].
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows_kernel(const float* __restrict__ tab,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, long long rows, int L,
                       long long n_tab) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x) /
      32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warp leaves together
  const long long i = idx[r * L];
  const bool ok = i >= 0 && i < n_tab;
  float* dst = out + r * L;
  const float* src = tab + (ok ? i : 0) * L;
  for (int l = lane; l < L; l += 32) dst[l] = ok ? __ldg(src + l) : 0.f;
}

}  // namespace

// Each entry point launches on ``stream`` and returns cudaGetLastError():
// a refused launch (bad configuration) never runs and is reported only here.
extern "C" {

// The largest dynamic shared memory a block may opt in to, and the SMs, of
// ``device``.
int crtpu_gather_limits(int device, int* smem_optin, int* sms) {
  cudaError_t err = cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}

// R <- bf16(R + 1) over the (M, W) panel R, in place.
int crtpu_stream_rmw(void* R, int M, int W, void* stream) {
  if (M <= 0 || W <= 0) return cudaErrorInvalidValue;
  __nv_bfloat16* Rb = static_cast<__nv_bfloat16*>(R);
  const long long n = static_cast<long long>(M) * W;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(R);
  const int head = static_cast<int>(
      n < 8 ? n : static_cast<long long>((16 - (addr & 15)) & 15) / 2);
  const long long nvec = (n - head) / kVecElems;
  const int ntail = static_cast<int>(n - head - nvec * kVecElems);
  const long long per_block = static_cast<long long>(kVecThreads) * kVecUnroll;
  const long long blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  stream_rmw_vec_kernel<<<static_cast<unsigned>(blocks), kVecThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Rb, head, reinterpret_cast<uint4*>(Rb + head), nvec,
      Rb + head + nvec * kVecElems, ntail);
  return static_cast<int>(cudaGetLastError());
}

// The resident blocks an SM of the stream_read instance (NaN-skip or
// weighted, aligned or shifted row path) on the current device, into
// ``blocks``: what ops/probe_kernels.py::read_plan sizes the grid by.
int crtpu_stream_read_blocks(int nan_skip, int aligned, int* blocks) {
  const auto k = nan_skip ? (aligned ? stream_read_kernel<true, true>
                                     : stream_read_kernel<true, false>)
                          : (aligned ? stream_read_kernel<false, true>
                                     : stream_read_kernel<false, false>);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k,
                                                    kReadThreads, 0));
}

// ``u`` null selects the NaN-skip mode (unweighted), else the weighted one.
// ``aligned``: the aligned row path (R on a 16-byte boundary and W a
// multiple of 8, else cudaErrorInvalidValue), else the shifted one;
// ``ranges`` (1 to ceil(M / 512)) row ranges a column tile (256 columns
// on the aligned path, 248 on the shifted one), a block each
// (ops/probe_kernels.py::read_plan). ``gpart`` holds ranges x W floats;
// ``count`` an unsigned zero a tile, which the kernel leaves zero.
int crtpu_stream_read(const void* R, const void* u, void* gpart, void* count,
                      void* g, int M, int W, int aligned, int ranges,
                      void* stream) {
  if (M <= 0 || W <= 0) return cudaErrorInvalidValue;
  const long long nb = (M + kTileRows - 1) / kTileRows;
  const int cols = aligned ? kReadTileCols : kShiftTileCols;
  const long long tiles = (W + cols - 1) / cols;
  if (ranges < 1 || ranges > nb || tiles * ranges > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  if (aligned && ((reinterpret_cast<uintptr_t>(R) & 15) || W % kVecElems))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* Rb = static_cast<const __nv_bfloat16*>(R);
  const auto* uf = static_cast<const float*>(u);
  auto* gp = static_cast<float*>(gpart);
  auto* cnt = static_cast<unsigned*>(count);
  auto* gf = static_cast<float*>(g);
  const unsigned grid = static_cast<unsigned>(tiles * ranges);
  if (u == nullptr) {
    if (aligned)
      stream_read_kernel<true, true><<<grid, kReadThreads, 0, s>>>(
          Rb, uf, gp, cnt, gf, M, W, ranges);
    else
      stream_read_kernel<true, false><<<grid, kReadThreads, 0, s>>>(
          Rb, uf, gp, cnt, gf, M, W, ranges);
  } else {
    if (aligned)
      stream_read_kernel<false, true><<<grid, kReadThreads, 0, s>>>(
          Rb, uf, gp, cnt, gf, M, W, ranges);
    else
      stream_read_kernel<false, false><<<grid, kReadThreads, 0, s>>>(
          Rb, uf, gp, cnt, gf, M, W, ranges);
  }
  return static_cast<int>(cudaGetLastError());
}

// ``mode`` 0, 1, 2: forms A, B, C; ``n_tab`` the table's rows S; ``path``
// 0: the L2 path (and form C), 1: the shared-memory path (forms A and B;
// cudaErrorInvalidValue where the table plus kSmemReserve bytes exceeds
// the device's opt-in shared memory). ops/probe_kernels.py::gather_plan
// mirrors the choice of kernel, the split and the grids.
int crtpu_gather(const void* tab, const void* idx, void* out, long long rows,
                 int L, long long n_tab, int mode, int path, void* stream) {
  if (rows <= 0 || L <= 0 || n_tab <= 0 || mode < 0 || mode > 2 ||
      path < 0 || path > 1 || (path == 1 && mode == 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tab);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  const long long n = rows * L;
  if (mode == 2) {
    const long long blocks = (rows * 32 + kGatherThreads - 1) / kGatherThreads;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    gather_rows_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                         s>>>(t, ix, o, rows, L, n_tab);
    return static_cast<int>(cudaGetLastError());
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool cols = mode == 0 && path == 1 && L % kColLanes == 0 &&
                    aligned(t) && aligned(ix) && aligned(o);
  // the output's 16-byte steps: up to 3 elements before the first, up to
  // step - 1 after the last
  const int step = path == 1 ? kSmemStep : kL2Step;
  const int head = static_cast<int>(std::min<long long>(
      n, ((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4));
  const long long nvec = (n - head) / step;
  const int ntail = static_cast<int>(n - head - nvec * step);
  const bool idx_vec = aligned(ix + head);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = static_cast<cudaError_t>(crtpu_gather_limits(dev, &optin, &sms));
  if (err != cudaSuccess) return static_cast<int>(err);
  // each path's function attributes, set once a device
  static bool set[2][kMaxDevices] = {};
  const bool first = dev >= kMaxDevices || !set[path][dev];
  if (path == 1) {
    if (kSmemReserve + (n_tab * L * 4 + 15) / 16 * 16 > optin)
      return cudaErrorInvalidValue;
    if (first) {  // any instance may take all the opt-in bytes
      const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
      for (const auto k : {gather_table_kernel<0, false>,
                           gather_table_kernel<0, true>,
                           gather_table_kernel<1, false>,
                           gather_table_kernel<1, true>})
        if (err == cudaSuccess) err = cudaFuncSetAttribute(k, attr, optin);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(gather_cols_kernel, attr, optin);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cols) {
      // each column group gets an equal share of the SMs (at least one)
      const long long groups = L / kColLanes;
      const long long want =
          (rows * (kColLanes / kSmemStep) + kColsThreads - 1) / kColsThreads;
      const long long per = std::max<long long>(
          1, std::min<long long>(want, sms / groups));
      if (groups * per > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
      gather_cols_kernel<<<static_cast<unsigned>(groups * per), kColsThreads,
                           static_cast<int>(kSmemHead + n_tab * kColLanes * 4),
                           s>>>(t, ix, o, rows, L, n_tab);
    } else {
      const auto k = mode == 0 ? (idx_vec ? gather_table_kernel<0, true>
                                          : gather_table_kernel<0, false>)
                               : (idx_vec ? gather_table_kernel<1, true>
                                          : gather_table_kernel<1, false>);
      cudaLaunchAttribute cluster;
      cluster.id = cudaLaunchAttributeClusterDimension;
      cluster.val.clusterDim.x = kTableCluster;
      cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.blockDim = kTableThreads;
      cfg.dynamicSmemBytes =
          static_cast<size_t>(kSmemReserve + (n_tab * L * 4 + 15) / 16 * 16);
      cfg.stream = s;
      cfg.attrs = &cluster;
      cfg.numAttrs = 1;
      // as many whole clusters as run at once (a block an SM), no more
      // than the steps need
      cfg.gridDim = sms / kTableCluster * kTableCluster;
      int fit = 0;
      err = cudaOccupancyMaxActiveClusters(&fit, k, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (fit < 1) return cudaErrorInvalidConfiguration;
      const long long want =
          (nvec + kTableThreads * kTableCluster - 1) /
          (kTableThreads * kTableCluster);
      cfg.gridDim = static_cast<unsigned>(
          std::max<long long>(1, std::min<long long>(want, fit)) *
          kTableCluster);
      err = cudaLaunchKernelEx(&cfg, k, t, ix, o, head, nvec, ntail, L, n_tab);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  } else {
    if (first) {  // the path uses no shared memory: favour L1
      for (const auto k :
           {gather_l2_kernel<0, false>, gather_l2_kernel<0, true>,
            gather_l2_kernel<1, false>, gather_l2_kernel<1, true>})
        if (err == cudaSuccess)
          err = cudaFuncSetAttribute(
              k, cudaFuncAttributePreferredSharedMemoryCarveout,
              cudaSharedmemCarveoutMaxL1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long want = (nvec + kL2Threads - 1) / kL2Threads;
    const unsigned nb = static_cast<unsigned>(std::max<long long>(
        1, std::min<long long>(want, static_cast<long long>(sms) *
                                         kL2MinBlocks)));
    const auto k = mode == 0 ? (idx_vec ? gather_l2_kernel<0, true>
                                        : gather_l2_kernel<0, false>)
                             : (idx_vec ? gather_l2_kernel<1, true>
                                        : gather_l2_kernel<1, false>);
    k<<<nb, kL2Threads, 0, s>>>(t, ix, o, head, nvec, ntail, L, n_tab);
  }
  if (dev < kMaxDevices) set[path][dev] = true;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
