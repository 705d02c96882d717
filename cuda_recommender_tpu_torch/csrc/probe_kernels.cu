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
// atomics). The gathers read the table through the read-only cache
// (__ldg).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreadsX = 32;      // threads across a tile's columns
constexpr int kThreadsY = 8;       // threads down a tile's rows
constexpr int kColsPerThread = 4;
constexpr int kRowBatch = 4;       // rows loaded per thread before any use
constexpr int kTileCols = kThreadsX * kColsPerThread;  // 128
constexpr int kTileRows = 512;     // the Pallas probes' block height (BM)
constexpr int kReduceThreads = 256;
constexpr int kGatherThreads = 256;
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

// Gather forms A (kMode 0) and B (1): one thread an element.
template <int kMode>
__global__ void __launch_bounds__(kGatherThreads)
    gather_elem_kernel(const float* __restrict__ tab,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, long long n, int L,
                       long long n_tab) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (e >= n) return;
  const long long i = idx[e];
  const long long at = kMode == 0 ? i * L + e % L : i;
  const bool ok = i >= 0 && (kMode == 0 ? i < n_tab : i < n_tab * L);
  out[e] = ok ? __ldg(tab + at) : 0.f;
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

// ``mode`` 0, 1, 2: forms A, B, C; ``n_tab`` the table's rows S.
int crtpu_gather(const void* tab, const void* idx, void* out, long long rows,
                 int L, long long n_tab, int mode, void* stream) {
  if (rows <= 0 || L <= 0 || n_tab <= 0 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tab);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  const long long n = rows * L;
  const long long threads = mode == 2 ? rows * 32 : n;
  const long long blocks = (threads + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (mode == 0)
    gather_elem_kernel<0><<<nb, kGatherThreads, 0, s>>>(t, ix, o, n, L, n_tab);
  else if (mode == 1)
    gather_elem_kernel<1><<<nb, kGatherThreads, 0, s>>>(t, ix, o, n, L, n_tab);
  else
    gather_rows_kernel<<<nb, kGatherThreads, 0, s>>>(t, ix, o, rows, L, n_tab);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
