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
// Each stream comes in two designs:
//   * the ring (the streams' own kernels, counted as stream_rmw and
//     stream_read): a persistent grid, a few blocks an SM, each with a
//     ring of shared-memory stages that the bulk copy engine (TMA,
//     cp.async.bulk) fills from device memory, each completing on its
//     mbarrier. A block is 8 consumer warps and one producer warp: the
//     producer issues the copies and the consumers wait only for the data
//     (full[slot]) and release a slot when done with it (a second
//     mbarrier a slot), so neither waits for the other's bookkeeping. The
//     threads spend no registers or instructions on the loads, so the
//     bytes in flight are bounded by shared memory (stages x stage bytes
//     a block), not by registers. The geometry is
//     ops/probe_kernels.py::stream_plan's; the entry points take it and
//     refuse what does not fit (cudaErrorInvalidValue). A ring wait that
//     lasts seconds traps: a lost copy is a fault, not a hang.
//     - rmw: the panel's cells as one flat run; the 16-byte-aligned body
//       is cut into chunks (a chunk a stage), dealt to the blocks in turn
//       (chunk c to block c mod grid, so that neighbouring blocks stream
//       neighbouring bytes). The consumers add 1 to each bf16 pair of a
//       chunk in shared memory and, after a proxy fence, release it; the
//       producer writes the stage back by a bulk copy
//       (cp.async.bulk.global.shared::cta) and commits it, and loads a
//       stage again only once cp.async.bulk.wait_group.read has released
//       its write-back, so the loads of later chunks overlap the
//       write-back of earlier ones. The cells before the first 16-byte
//       boundary and after the last one (up to 7 each) go one a thread of
//       block 0.
//     - read: the panel's W columns are cut into ns = ceil(W / 2048)
//       strips of equal width ws = ceil(W / ns) (the last one narrower),
//       and each strip's rows into ranges of per_cta >= 512 rows (one
//       range where the panel is short); block b takes strip b mod ns and
//       range b / ns, so that the blocks running side by side read the
//       strips of the same rows. Consumer thread t owns the strip's
//       columns t + k * kRingThreads (k < kRingCols) and sums them in
//       registers in row order. A stage holds ``rows`` rows of the strip,
//       each copied as the 16-byte-aligned span that covers its segment
//       into a slot of ``pitch`` bytes (its first cell at the start
//       address mod 16 in the slot); where one strip spans the panel (ns
//       = 1), consecutive rows are consecutive bytes, and a stage is one
//       span. Rounding a span out to 16 bytes stays inside the
//       allocation: an aligned 16 bytes that hold a cell of the panel lie
//       inside it (its granules are multiples of 16 bytes). NaN is skipped
//       by a select. A block writes the partial column sums of each
//       512-row block of its range, times the block's weight, to that
//       block's row of ``gpart``; the one piece that begins mid-block (its
//       range's first, where the range starts off a block boundary) goes
//       to the block's own row of ``gextra`` instead. A second pass
//       (ring_reduce_kernel) adds, for each column, the blocks' rows in
//       block order, each block's ``gextra`` piece after its ``gpart``
//       one: deterministic, no float atomics.
//     Why strips of row ranges (balancing the waves): at the variant
//     matrix's 165,376 x 18,432, whole 512-row blocks would be 323 units
//     over 132 SMs, 2.45 waves, whose last wave runs half empty; (block,
//     strip) units, 2,907 over 264 blocks, still leave 11.01 waves (12 for
//     three blocks, 9% lost). One range a block, ns x ranges <= the
//     blocks that run at once (9 x 29 = 261 of 264 there), is one wave in
//     which every block has the same rows to within one; with per_cta >=
//     512 a (512-row block, strip) piece is split between at most two
//     blocks, hence the one ``gextra`` row a block.
//   * 16-byte vectors (``vec16``, counted as stream_rmw_vec16 and
//     stream_read_vec16; the design the ring is timed against): the rmw
//     walks the panel flat (its function is per cell, so rows need no
//     alignment), 4 vectors a thread in flight; the read gives each thread
//     8 consecutive cells of a row, 4 rows in flight, realigned from
//     16-byte-aligned loads where a row does not start on a 16-byte
//     boundary (W not a multiple of 8). A block loads one batch, uses it
//     and exits; registers bound the bytes in flight. The read's column
//     sums are reduced in two passes (per-tile partials in a fixed order,
//     then the tiles in tile order; no float atomics).
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

constexpr int kThreadsX = 32;      // threads across a vec16 read tile
constexpr int kThreadsY = 8;       // threads down its rows
constexpr int kRowBatch = 4;       // rows loaded per thread before any use
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
// the streams' ring (ops/probe_kernels.py mirrors these as STREAM_*):
// consumer threads a block, the read's columns a thread (a strip is at
// most their product), the fewest and the most stages, and the bytes
// before the stages (two mbarriers a stage; the stages start 128-byte
// aligned). The rmw's producer reloads chunk i's stage only once chunk
// i + 1 is done, so a ring of one stage never loads its second chunk and
// hangs; both entry points refuse fewer than the plan's fewest
// (STREAM_STAGES[0]).
constexpr int kRingThreads = 256;    // the consumer warps
constexpr int kRingBlock = kRingThreads + 32;   // and one producer warp
constexpr int kRingCols = 8;
constexpr int kRingStrip = kRingThreads * kRingCols;   // 2048 columns
constexpr int kRingMinStages = 3;
constexpr int kRingMaxStages = 8;
constexpr int kRingHead = 128;
constexpr int kRingReduceThreads = 128;
constexpr int kRingReduceBatch = 16;   // partials a thread loads at once
// a ring wait that lasts this many cycles (seconds) traps instead of
// hanging the card: a copy that never completes is a fault
constexpr long long kRingTimeout = 1LL << 35;

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

// ---- mbarriers and bulk copies (the streams' ring; the gathers' tables) ----

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// mbar_wait bounded by kRingTimeout cycles.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > kRingTimeout) __trap();
  }
}

// ``bytes`` (a multiple of 16) from the 16-byte-aligned global ``src`` to
// this block's 16-byte-aligned shared ``dst``, completing ``bytes``
// transactions on the mbarrier at ``bar``.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ``bytes`` (a multiple of 16) from shared ``src`` to global ``dst``, both
// 16-byte aligned, in the thread's current bulk async-group.
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most ``kPending`` of the thread's committed bulk groups still
// read their shared-memory source.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}

// Until every committed bulk group of the thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The thread's shared-memory writes before it are ordered before the bulk
// copies (the async proxy) issued after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- the streams' ring: see the file's head ----

// stream_rmw: ``body`` (``body_bytes``, a multiple of 16, 16-byte aligned)
// in chunks of ``chunk`` bytes, chunk c to block c mod gridDim.x, through
// ``stages`` stages of ``chunk`` bytes. The consumer warps wait for a
// chunk's load (full[slot]), add 1 to its cells in shared memory, fence
// and arrive on done[slot]; the producer (lane 0 of the last warp) writes
// each done chunk back, and loads the slot of the chunk before it again
// once that chunk's write-back has read it. Block 0's consumers also do
// the ``head`` cells before ``body`` and the ``ntail`` after it, one a
// thread.
__global__ void __launch_bounds__(kRingBlock)
    stream_rmw_ring_kernel(__nv_bfloat16* R, int head, char* body,
                           long long body_bytes, int chunk, int stages,
                           int ntail) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = sbase, done = sbase + 8u * kRingMaxStages;
  const long long nchunks = (body_bytes + chunk - 1) / chunk;
  const long long step = gridDim.x;
  const long long mine =
      blockIdx.x < nchunks ? (nchunks - blockIdx.x + step - 1) / step : 0;
  // this block's i-th chunk: its bytes' offset in ``body``, and how many
  const auto offset = [&](long long i) {
    return (blockIdx.x + i * step) * chunk;
  };
  const auto nbytes = [&](long long i) {
    return static_cast<uint32_t>(
        min(static_cast<long long>(chunk), body_bytes - offset(i)));
  };
  const auto stage = [&](int slot) {
    return sbase + kRingHead + static_cast<uint32_t>(slot) * chunk;
  };
  const auto load = [&](long long i, int slot) {
    mbar_expect_tx(full + 8u * slot, nbytes(i));
    bulk_g2s(stage(slot), body + offset(i), nbytes(i), full + 8u * slot);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8u * s, 1);
      mbar_init(done + 8u * s, kRingThreads / 32);
    }
  __syncthreads();
  int slot = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= kRingThreads) {  // the producer warp
    if (threadIdx.x != kRingThreads) return;
    for (int s = 0; s < stages && s < mine; ++s) load(s, s);
    int prev = stages - 1;
    for (long long i = 0; i < mine; ++i) {
      ring_wait(done + 8u * slot, phase);
      bulk_s2g(body + offset(i), stage(slot), nbytes(i));
      bulk_commit();
      // the previous chunk's stage takes the chunk ``stages`` after it
      // once its write-back has read it (this chunk's may go on)
      if (i >= 1 && i - 1 + stages < mine) {
        bulk_wait_read<1>();
        load(i - 1 + stages, prev);
      }
      prev = slot;
      if (++slot == stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
    bulk_wait_all();
    return;
  }
  for (long long i = 0; i < mine; ++i) {
    ring_wait(full + 8u * slot, phase);
    const uint32_t n = nbytes(i);
    uint4* p = reinterpret_cast<uint4*>(
        smem + kRingHead + static_cast<size_t>(slot) * chunk);
    for (uint32_t v = threadIdx.x; v < n / 16; v += kRingThreads) {
      const uint4 x = p[v];
      p[v] = make_uint4(add_one_bf16x2(x.x), add_one_bf16x2(x.y),
                        add_one_bf16x2(x.z), add_one_bf16x2(x.w));
    }
    fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(done + 8u * slot);
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  if (blockIdx.x == 0) {
    if (static_cast<int>(threadIdx.x) < head) add_one_bf16(R + threadIdx.x);
    if (static_cast<int>(threadIdx.x) < ntail)
      add_one_bf16(reinterpret_cast<__nv_bfloat16*>(body + body_bytes) +
                   threadIdx.x);
  }
}

// A stream_read piece's partial column sums (strip ps, 512-row block pb),
// times the block's weight, into gpart's row pb or, where the piece began
// mid-block, into this block's gextra row; then zeroes them.
template <bool kNanSkip>
__device__ __forceinline__ void flush_piece(float (&acc)[kRingCols],
                                            float* __restrict__ gpart,
                                            float* __restrict__ gextra,
                                            const float* __restrict__ u,
                                            int W, int ws, int ps, int pb,
                                            bool pextra) {
  const int w = min(ws, W - ps * ws);
  float* dst = pextra ? gextra + static_cast<size_t>(blockIdx.x) * ws
                      : gpart + static_cast<size_t>(pb) * W +
                            static_cast<size_t>(ps) * ws;
  const float wt = kNanSkip ? 1.f : u[static_cast<size_t>(pb) * kTileRows];
#pragma unroll
  for (int j = 0; j < kRingCols; ++j) {
    const int c = threadIdx.x + j * kRingThreads;
    if (c < w) dst[c] = kNanSkip ? acc[j] : acc[j] * wt;
    acc[j] = 0.f;
  }
}

// stream_read's first pass: see the file's head. Block b takes strip
// s = b mod ns and the rows [k * per_cta, min(M, (k + 1) * per_cta)) of
// it, k = b / ns, ``rows`` a stage (at most 32 where ns > 1: a lane of the
// producer warp copies a row's segment). The producer warp waits for a
// slot's consumers to release it (empty[slot]) and loads the next stage
// into it (full[slot]); the consumer warps sum a stage's rows and release
// the slot, a warp at a time.
template <bool kNanSkip>
__global__ void __launch_bounds__(kRingBlock)
    stream_read_ring_kernel(const __nv_bfloat16* __restrict__ R,
                            const float* __restrict__ u,
                            float* __restrict__ gpart,
                            float* __restrict__ gextra, int M, int W, int ws,
                            int rows, int stages, int per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = sbase, empty = sbase + 8u * kRingMaxStages;
  const int ns = (W + ws - 1) / ws;
  const bool flat = ns == 1;  // a stage's rows are one span
  const uint32_t pitch = ((2u * ws + 15u) & ~15u) + 16u;
  const uint32_t stage_bytes = static_cast<uint32_t>(rows) * pitch;
  const int s = blockIdx.x % ns;
  const int c0 = s * ws;  // the strip's first column, and its width
  const int w = min(ws, W - c0);
  const int r0 = static_cast<int>(blockIdx.x / ns) * per_cta;
  const int r1 = min(M, r0 + per_cta);
  const int nstage = (r1 - r0 + rows - 1) / rows;
  // the address of the strip's first cell in row r
  const auto cell = [&](int r) {
    return reinterpret_cast<uintptr_t>(R) +
           2u * (static_cast<uintptr_t>(r) * W + c0);
  };
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0)
    for (int k = 0; k < stages; ++k) {
      mbar_init(full + 8u * k, 1);
      mbar_init(empty + 8u * k, kRingThreads / 32);
    }
  __syncthreads();
  int slot = 0;
  uint32_t phase = 0;

  if (t >= kRingThreads) {  // the producer warp: lane k copies row k
    for (int i = 0; i < nstage; ++i) {
      if (i >= stages) ring_wait(empty + 8u * slot, phase ^ 1u);
      const int r = r0 + i * rows;
      const int n = min(rows, r1 - r);
      const uint32_t bar = full + 8u * slot;
      const uint32_t dst = sbase + kRingHead + slot * stage_bytes;
      if (flat) {
        if (lane == 0) {
          const uintptr_t a0 = cell(r);
          const uintptr_t a = a0 & ~static_cast<uintptr_t>(15);
          const uintptr_t e =
              (a0 + 2u * static_cast<uintptr_t>(n) * W + 15u) &
              ~static_cast<uintptr_t>(15);
          mbar_expect_tx(bar, static_cast<uint32_t>(e - a));
          bulk_g2s(dst, reinterpret_cast<const void*>(a),
                   static_cast<uint32_t>(e - a), bar);
        }
      } else {
        const uintptr_t a0 = cell(r + min(lane, n - 1));
        const uintptr_t a = a0 & ~static_cast<uintptr_t>(15);
        const uintptr_t e = (a0 + 2u * static_cast<uintptr_t>(w) + 15u) &
                            ~static_cast<uintptr_t>(15);
        const uint32_t bytes = lane < n ? static_cast<uint32_t>(e - a) : 0u;
        const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
        if (lane == 0) mbar_expect_tx(bar, total);
        __syncwarp();
        if (lane < n)
          bulk_g2s(dst + lane * pitch, reinterpret_cast<const void*>(a),
                   bytes, bar);
      }
      if (++slot == stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  // the piece being summed: its 512-row block, whether it began mid-block
  // (the range's first piece goes to gextra then), and whether it has
  // rows yet
  int pb = r0 / kTileRows;
  bool pextra = r0 % kTileRows != 0, live = false;
  float acc[kRingCols];
#pragma unroll
  for (int j = 0; j < kRingCols; ++j) acc[j] = 0.f;
  for (int i = 0; i < nstage; ++i) {
    ring_wait(full + 8u * slot, phase);
    const int rs = r0 + i * rows;
    const int n = min(rows, r1 - rs);
    const unsigned char* st = smem + kRingHead + slot * stage_bytes;
    // flat: the stage's first cell's place in its span
    const uint32_t off0 = static_cast<uint32_t>(cell(rs)) & 15u;
    for (int k = 0; k < n; ++k) {
      const int r = rs + k;
      if (r % kTileRows == 0) {  // a new piece: a 512-row block begins
        if (live)
          flush_piece<kNanSkip>(acc, gpart, gextra, u, W, ws, s, pb, pextra);
        pb = r / kTileRows;
        pextra = live = false;
      }
      const uint32_t off =
          flat ? off0 + 2u * static_cast<uint32_t>(k) * W
               : k * pitch + (static_cast<uint32_t>(cell(r)) & 15u);
      const __nv_bfloat16* row =
          reinterpret_cast<const __nv_bfloat16*>(st + off);
#pragma unroll
      for (int j = 0; j < kRingCols; ++j) {
        const int c = t + j * kRingThreads;
        if (c < w) {
          const float x = __bfloat162float(row[c]);
          acc[j] += kNanSkip && isnan(x) ? 0.f : x;
        }
      }
      live = true;
    }
    __syncwarp();  // the warp has read the stage: release it
    if (lane == 0) mbar_arrive(empty + 8u * slot);
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
  if (live)
    flush_piece<kNanSkip>(acc, gpart, gextra, u, W, ws, s, pb, pextra);
}

// stream_read's second pass after the ring: column c's (block, strip)
// pieces in block order, each block's gextra piece (from the grid's block
// whose row range of the strip starts inside it, if any) after its gpart
// one.
__global__ void __launch_bounds__(kRingReduceThreads)
    ring_reduce_kernel(const float* __restrict__ gpart,
                       const float* __restrict__ gextra,
                       float* __restrict__ g, int nparts, int M, int W,
                       int ws, int per_cta) {
  const int c = blockIdx.x * kRingReduceThreads + threadIdx.x;
  if (c >= W) return;
  const int ns = (W + ws - 1) / ws;
  const int s = c / ws;
  const int j = c - s * ws;
  float t = 0.f;
  for (int p0 = 0; p0 < nparts; p0 += kRingReduceBatch) {
    float x[kRingReduceBatch];
#pragma unroll
    for (int k = 0; k < kRingReduceBatch; ++k)
      x[k] = p0 + k < nparts ? gpart[static_cast<size_t>(p0 + k) * W + c]
                             : 0.f;
#pragma unroll
    for (int k = 0; k < kRingReduceBatch; ++k) {
      const int p = p0 + k;
      if (p >= nparts) break;
      t += x[k];
      const int lo = p * kTileRows, hi = min(M, lo + kTileRows);
      const int range = lo / per_cta + 1;  // the first that starts after lo
      if (range * per_cta < hi)
        t += gextra[(static_cast<size_t>(range) * ns + s) * ws + j];
    }
  }
  g[c] = t;
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

}  // extern "C"

namespace {

// The current device's opt-in shared memory a block, with the ring
// kernels allowed all of it (set once a device).
cudaError_t ring_setup(int* optin) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = static_cast<cudaError_t>(crtpu_gather_limits(dev, optin, &sms));
  static bool set[kMaxDevices] = {};
  if (err != cudaSuccess || (dev < kMaxDevices && set[dev])) return err;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(stream_rmw_ring_kernel, attr, *optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_read_ring_kernel<false>, attr, *optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_read_ring_kernel<true>, attr, *optin);
  if (err == cudaSuccess && dev < kMaxDevices) set[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// ``mode`` 0: the ring, with ``head`` cells before the 16-byte-aligned body,
// chunks of ``chunk`` bytes, ``stages`` stages and ``grid`` blocks
// (ops/probe_kernels.py::stream_plan); 1: 16-byte vectors over the panel as
// one flat run (the last four arguments unused).
int crtpu_stream_rmw(void* R, int M, int W, int mode, int head, int chunk,
                     int stages, int grid, void* stream) {
  if (M <= 0 || W <= 0 || mode < 0 || mode > 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Rb = static_cast<__nv_bfloat16*>(R);
  const long long n = static_cast<long long>(M) * W;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(R);
  if (mode == 1) {
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
  if (head < 0 || head >= kVecElems || head > n || chunk < 16 ||
      chunk % 16 != 0 || stages < kRingMinStages ||
      stages > kRingMaxStages || grid < 1)
    return cudaErrorInvalidValue;
  const long long body_bytes = (2 * (n - head)) & ~15LL;
  if (body_bytes > 0 && ((addr + 2u * head) & 15) != 0)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = ring_setup(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = kRingHead + static_cast<long long>(stages) * chunk;
  if (smem > optin) return cudaErrorInvalidValue;
  stream_rmw_ring_kernel<<<grid, kRingBlock, static_cast<size_t>(smem),
                           s>>>(Rb, head, reinterpret_cast<char*>(Rb + head),
                                body_bytes, chunk, stages,
                                static_cast<int>(n - head - body_bytes / 2));
  return static_cast<int>(cudaGetLastError());
}

// ``u`` null selects the NaN-skip mode (unweighted), else the weighted one.
// ``mode`` 0: the ring, over ns = ceil(W / strip) column strips of
// ``strip`` columns cut into row ranges of ``per_cta`` rows, a block each
// (``grid`` = ns x the ranges), ``rows`` rows a stage, ``stages`` stages
// (ops/probe_kernels.py::stream_plan), with ``gextra`` (grid x strip
// floats; may be null for one range a strip); 1: 16-byte vectors in
// 256-column tiles (the last six arguments unused). ``gpart`` holds
// ceil(M / 512) x W floats.
int crtpu_stream_read(const void* R, const void* u, void* gpart, void* gextra,
                      void* g, int M, int W, int mode, int strip, int rows,
                      int stages, int grid, long long per_cta, void* stream) {
  const int nr = (M + kTileRows - 1) / kTileRows;
  if (M <= 0 || W <= 0 || nr > kMaxGridY || mode < 0 || mode > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* Rb = static_cast<const __nv_bfloat16*>(R);
  const float* uf = static_cast<const float*>(u);
  float* gp = static_cast<float*>(gpart);
  float* gx = static_cast<float*>(gextra);
  if (mode == 1) {
    const dim3 tiles((W + kVecTileCols - 1) / kVecTileCols, nr);
    const dim3 block(kThreadsX, kThreadsY);
    if (u == nullptr)
      stream_read_vec_kernel<true><<<tiles, block, 0, s>>>(Rb, uf, gp, M, W);
    else
      stream_read_vec_kernel<false><<<tiles, block, 0, s>>>(Rb, uf, gp, M, W);
    tile_reduce_kernel<<<(W + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, s>>>(gp, static_cast<float*>(g),
                                                 nr, W);
    return static_cast<int>(cudaGetLastError());
  }
  if (strip < 1 || strip > kRingStrip || per_cta < 1 || per_cta > M)
    return cudaErrorInvalidValue;
  const int ns = (W + strip - 1) / strip;
  const long long ranges = (M + per_cta - 1) / per_cta;  // a strip's
  if (rows < 1 || (ns > 1 && rows > 32) || stages < kRingMinStages ||
      stages > kRingMaxStages || grid != ns * ranges ||
      (ranges > 1 && (per_cta < kTileRows || gextra == nullptr)))
    return cudaErrorInvalidValue;
  const long long pitch = ((2LL * strip + 15) & ~15LL) + 16;
  const long long smem =
      kRingHead + static_cast<long long>(stages) * rows * pitch;
  int optin = 0;
  cudaError_t err = ring_setup(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return cudaErrorInvalidValue;
  if (u == nullptr)
    stream_read_ring_kernel<true><<<grid, kRingBlock,
                                    static_cast<size_t>(smem), s>>>(
        Rb, uf, gp, gx, M, W, strip, rows, stages, static_cast<int>(per_cta));
  else
    stream_read_ring_kernel<false><<<grid, kRingBlock,
                                     static_cast<size_t>(smem), s>>>(
        Rb, uf, gp, gx, M, W, strip, rows, stages, static_cast<int>(per_cta));
  ring_reduce_kernel<<<(W + kRingReduceThreads - 1) / kRingReduceThreads,
                       kRingReduceThreads, 0, s>>>(
      gp, gx, static_cast<float*>(g), nr, M, W, strip,
      static_cast<int>(per_cta));
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
