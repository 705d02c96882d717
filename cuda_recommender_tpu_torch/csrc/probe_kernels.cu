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
//     no other work. In the 2-byte tile pattern the grid walks the panel's
//     512-row x 128-column tiles in column-of-tiles order (down each column
//     strip, as the Pallas control's grid) or row-of-tiles order (along each
//     row band, the order in which a 2-D grid runs on the card); in the
//     16-byte-vector
//     pattern it walks the cells flat.
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
// Each stream comes in two load patterns:
//   * the 2-byte tile pattern (K1's former layout; panel_kernels.cu now
//     moves 16-byte vectors): a block of 32 x 8 threads owns a 512-row x
//     128-column tile, each thread loads 4 rows x 4 columns as 2-byte loads
//     (a warp reads 32 consecutive cells of one row) before any store, so 16
//     loads are in flight a thread. These measure that access pattern
//     without arithmetic: the access-pattern diagnostic.
//   * 16-byte vectors (``vec16``): the rmw walks the panel flat (its function
//     is per cell, so rows need no alignment), 4 vectors a thread in flight;
//     the read gives each thread 8 consecutive cells of a row, 4 rows in
//     flight, realigned from 16-byte-aligned loads where a row does not
//     start on a 16-byte boundary (W not a multiple of 8). These are the
//     achievable controls: what a plain stream reaches on the card.
// The column sums are reduced deterministically in two passes (per-tile
// partials in a fixed order, then the tiles in tile order; no float
// atomics).
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

constexpr int kThreadsX = 32;      // threads across a tile's columns
constexpr int kThreadsY = 8;       // threads down a tile's rows
constexpr int kColsPerThread = 4;
constexpr int kRowBatch = 4;       // rows loaded per thread before any use
constexpr int kTileCols = kThreadsX * kColsPerThread;  // 128
constexpr int kTileRows = 512;     // the Pallas probes' block height (BM)
constexpr int kReduceThreads = 256;
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
constexpr int kMaxGridY = 65535;
constexpr int kVecElems = 8;       // bf16 cells in a 16-byte vector
constexpr int kVecUnroll = 4;      // vectors in flight a thread (flat rmw)
constexpr int kVecThreads = 256;
constexpr int kVecTileCols = kThreadsX * kVecElems;  // 256, vec16 read

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

// One RMW pass over the tile (ti, tj) of the linear block index: R + 1,
// rounded once to bf16.
template <bool kRowMajor>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    stream_rmw_kernel(__nv_bfloat16* R, int M, int W, int n_row_tiles,
                      int n_col_tiles) {
  const int b = blockIdx.x;
  const int ti = kRowMajor ? b / n_col_tiles : b % n_row_tiles;
  const int tj = kRowMajor ? b % n_col_tiles : b / n_row_tiles;
  const int c_base = tj * kTileCols + threadIdx.x;
  const int r0 = ti * kTileRows;
  const int r1 = min(M, r0 + kTileRows);
  for (int rb = r0 + threadIdx.y; rb < r1; rb += kThreadsY * kRowBatch) {
    float x[kRowBatch][kColsPerThread];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int r = rb + k * kThreadsY;
      const size_t roff = static_cast<size_t>(r < r1 ? r : r0) * W;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int c = c_base + q * kThreadsX;
        x[k][q] = (r < r1 && c < W) ? __bfloat162float(R[roff + c]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int r = rb + k * kThreadsY;
      if (r >= r1) break;
      __nv_bfloat16* row = R + static_cast<size_t>(r) * W;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int c = c_base + q * kThreadsX;
        if (c < W) row[c] = __float2bfloat16_rn(__fadd_rn(x[k][q], 1.f));
      }
    }
  }
}

// First pass of stream_read: tile (blockIdx.y, blockIdx.x)'s column sums,
// times the tile's weight, into gpart[blockIdx.y, :].
template <bool kNanSkip>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    stream_read_kernel(const __nv_bfloat16* __restrict__ R,
                       const float* __restrict__ u,
                       float* __restrict__ gpart, int M, int W) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c_base = blockIdx.x * kTileCols + tx;
  const int r0 = blockIdx.y * kTileRows;
  const int r1 = min(M, r0 + kTileRows);
  float s[kColsPerThread] = {0.f, 0.f, 0.f, 0.f};
  for (int rb = r0 + ty; rb < r1; rb += kThreadsY * kRowBatch) {
    float x[kRowBatch][kColsPerThread];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int r = rb + k * kThreadsY;
      const size_t roff = static_cast<size_t>(r < r1 ? r : r0) * W;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int c = c_base + q * kThreadsX;
        x[k][q] = (r < r1 && c < W) ? __bfloat162float(R[roff + c]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        if (!kNanSkip || !isnan(x[k][q])) s[q] += x[k][q];
      }
    }
  }
  __shared__ float sg[kThreadsY][kTileCols];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) sg[ty][tx + q * kThreadsX] = s[q];
  __syncthreads();
  if (ty != 0) return;
  const float w = kNanSkip ? 1.f : u[r0];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int c = c_base + q * kThreadsX;
    if (c >= W) continue;
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < kThreadsY; ++y) t += sg[y][tx + q * kThreadsX];
    gpart[static_cast<size_t>(blockIdx.y) * W + c] = kNanSkip ? t : t * w;
  }
}

// stream_rmw with 16-byte vectors over the panel's n cells as one flat run:
// a block owns kVecThreads * kVecUnroll consecutive vectors of ``body``, each
// thread kVecUnroll of them (a warp's loads coalesced), all loaded before
// any store. Block 0 also does the ``head`` cells before ``body`` (up to the
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

// The 8 bf16 cells that start ``off`` bytes (even, 0..14) into the 32 bytes
// lo:hi, as floats.
__device__ __forceinline__ void unpack8(const uint4& lo, const uint4& hi,
                                        int off, float (&x)[kVecElems]) {
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (off & 8) {
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] = w[i + 2];
  }
  if (off & 4) {
#pragma unroll
    for (int i = 0; i < 7; ++i) w[i] = w[i + 1];
  }
#pragma unroll
  for (int j = 0; j < kVecElems / 2; ++j) {
    const uint32_t v = (off & 2) ? __funnelshift_r(w[j], w[j + 1], 16) : w[j];
    x[2 * j] = __uint_as_float(v << 16);
    x[2 * j + 1] = __uint_as_float(v & 0xFFFF0000u);
  }
}

// First pass of stream_read with 16-byte vectors: a block of 32 x 8 threads
// owns a 512-row x 256-column tile; each thread sums 8 consecutive columns
// down its rows, 4 rows in flight. A warp covers 512 consecutive bytes of a
// row: each lane loads the 16-byte-aligned vector that holds its first cell,
// takes the next one from its right-hand neighbour by a shuffle (lane 31
// loads its own), and shifts the pair into place. A vector is loaded only
// where it starts before the row's end: an aligned vector that holds a
// cell of the panel lies inside the panel's allocation (whose granules are
// multiples of 16 bytes).
template <bool kNanSkip>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    stream_read_vec_kernel(const __nv_bfloat16* __restrict__ R,
                           const float* __restrict__ u,
                           float* __restrict__ gpart, int M, int W) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c0 = blockIdx.x * kVecTileCols + tx * kVecElems;
  const int r0 = blockIdx.y * kTileRows;
  const int r1 = min(M, r0 + kTileRows);
  const int nvalid = W - c0;  // this thread's cells in a row: min(8, nvalid)
  float s[kVecElems] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int rb = r0 + ty; rb < r1; rb += kThreadsY * kRowBatch) {
    uint4 lo[kRowBatch], hi[kRowBatch];
    int off[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int r = rb + k * kThreadsY;  // one row for the whole warp
      lo[k] = hi[k] = make_uint4(0u, 0u, 0u, 0u);
      off[k] = 0;
      if (r < r1) {
        const __nv_bfloat16* row = R + static_cast<size_t>(r) * W;
        const uintptr_t end = reinterpret_cast<uintptr_t>(row + W);
        const uintptr_t a = reinterpret_cast<uintptr_t>(row) + 2u * c0;
        const uintptr_t al = a & ~static_cast<uintptr_t>(15);
        off[k] = static_cast<int>(a - al);
        if (al < end) lo[k] = *reinterpret_cast<const uint4*>(al);
        if (tx == kThreadsX - 1 && al + 16 < end)
          hi[k] = *reinterpret_cast<const uint4*>(al + 16);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const uint4 nb = make_uint4(__shfl_down_sync(0xffffffffu, lo[k].x, 1),
                                  __shfl_down_sync(0xffffffffu, lo[k].y, 1),
                                  __shfl_down_sync(0xffffffffu, lo[k].z, 1),
                                  __shfl_down_sync(0xffffffffu, lo[k].w, 1));
      if (tx != kThreadsX - 1) hi[k] = nb;
      if (rb + k * kThreadsY >= r1) continue;
      float x[kVecElems];
      unpack8(lo[k], hi[k], off[k], x);
#pragma unroll
      for (int e = 0; e < kVecElems; ++e) {
        if (e < nvalid && (!kNanSkip || !isnan(x[e]))) s[e] += x[e];
      }
    }
  }
  __shared__ float sg[kThreadsY][kVecTileCols];
#pragma unroll
  for (int e = 0; e < kVecElems; ++e) sg[ty][tx * kVecElems + e] = s[e];
  __syncthreads();
  // one column a thread: the 8 row groups' sums in order
  const int t = ty * kThreadsX + tx;
  const int c = blockIdx.x * kVecTileCols + t;
  if (c >= W) return;
  float acc = 0.f;
#pragma unroll
  for (int y = 0; y < kThreadsY; ++y) acc += sg[y][t];
  gpart[static_cast<size_t>(blockIdx.y) * W + c] = kNanSkip ? acc : acc * u[r0];
}

// Second pass of stream_read: the tiles' partials added in tile order.
__global__ void __launch_bounds__(kReduceThreads)
    tile_reduce_kernel(const float* __restrict__ gpart, float* __restrict__ g,
                       int nparts, int W) {
  const int c = blockIdx.x * kReduceThreads + threadIdx.x;
  if (c >= W) return;
  float t = 0.f;
  for (int p = 0; p < nparts; ++p) t += gpart[static_cast<size_t>(p) * W + c];
  g[c] = t;
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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

// ``mode`` 0: the 2-byte tiles in column-of-tiles order; 1: row-of-tiles
// order;
// 2: 16-byte vectors over the panel as one flat run.
int crtpu_stream_rmw(void* R, int M, int W, int mode, void* stream) {
  if (M <= 0 || W <= 0 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Rb = static_cast<__nv_bfloat16*>(R);
  if (mode == 2) {
    const long long n = static_cast<long long>(M) * W;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(R);
    const int head = static_cast<int>(
        n < 8 ? n : static_cast<long long>((16 - (addr & 15)) & 15) / 2);
    const long long nvec = (n - head) / kVecElems;
    const int ntail = static_cast<int>(n - head - nvec * kVecElems);
    const long long per_block = static_cast<long long>(kVecThreads) *
                                kVecUnroll;
    const long long blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    const unsigned nb = static_cast<unsigned>(blocks);
    uint4* body = reinterpret_cast<uint4*>(Rb + head);
    __nv_bfloat16* tail = Rb + head + nvec * kVecElems;
    stream_rmw_vec_kernel<<<nb, kVecThreads, 0, s>>>(Rb, head, body, nvec,
                                                     tail, ntail);
    return static_cast<int>(cudaGetLastError());
  }
  const int nr = (M + kTileRows - 1) / kTileRows;
  const int nc = (W + kTileCols - 1) / kTileCols;
  const dim3 block(kThreadsX, kThreadsY);
  if (mode == 1)
    stream_rmw_kernel<true><<<nr * nc, block, 0, s>>>(Rb, M, W, nr, nc);
  else
    stream_rmw_kernel<false><<<nr * nc, block, 0, s>>>(Rb, M, W, nr, nc);
  return static_cast<int>(cudaGetLastError());
}

// ``u`` null selects the NaN-skip mode (unweighted), else the weighted one;
// ``vec16`` the 16-byte-vector pattern (256-column tiles), else the 2-byte
// tile pattern.
int crtpu_stream_read(const void* R, const void* u, void* gpart, void* g,
                      int M, int W, int vec16, void* stream) {
  const int nr = (M + kTileRows - 1) / kTileRows;
  if (M <= 0 || W <= 0 || nr > kMaxGridY) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile_cols = vec16 ? kVecTileCols : kTileCols;
  const dim3 grid((W + tile_cols - 1) / tile_cols, nr);
  const dim3 block(kThreadsX, kThreadsY);
  const __nv_bfloat16* Rb = static_cast<const __nv_bfloat16*>(R);
  const float* uf = static_cast<const float*>(u);
  float* gp = static_cast<float*>(gpart);
  if (vec16 && u == nullptr)
    stream_read_vec_kernel<true><<<grid, block, 0, s>>>(Rb, uf, gp, M, W);
  else if (vec16)
    stream_read_vec_kernel<false><<<grid, block, 0, s>>>(Rb, uf, gp, M, W);
  else if (u == nullptr)
    stream_read_kernel<true><<<grid, block, 0, s>>>(Rb, uf, gp, M, W);
  else
    stream_read_kernel<false><<<grid, block, 0, s>>>(Rb, uf, gp, M, W);
  tile_reduce_kernel<<<(W + kReduceThreads - 1) / kReduceThreads,
                       kReduceThreads, 0, s>>>(gp, static_cast<float*>(g), nr,
                                               W);
  return static_cast<int>(cudaGetLastError());
}

// The largest dynamic shared memory a block may opt in to, and the SMs, of
// ``device``.
int crtpu_gather_limits(int device, int* smem_optin, int* sms) {
  cudaError_t err = cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
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
