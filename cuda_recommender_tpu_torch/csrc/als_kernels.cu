// ALS gram assembly for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (ops/build.py, ops/als_kernels.py).
//
// Replaces no TPU kernel. On the TPU, XLA fused the JAX package's gather
// of [F | val] into its einsum (cuda_recommender_tpu/solvers/als_ell.py,
// _gram_and_rhs), so no Pallas kernel was written for this layer. On the
// H100 the same math in PyTorch is a gather that writes the operand
// Faug = [F[idx] | val] (S, E, k+1) to device memory and an f32 torch.bmm
// that reads it back with cuBLAS' small SIMT tiles, over every padded lane
// of the ELL layout: 89% of an ALS iteration at 4-6% of the layer's bound.
// This kernel is the reference program's updateW_overH_kernel idea
// (reference cuda_src/ALS_CUDA.cu) for the port's ELL layout:
//
//   Gaug[s] = sum over the slot's real lanes e of f_e f_e^T,
//   f_e = [other[idx[s, e], 0:k] | val[s, e]]   (k+1 floats)
//
// written as (S, k+1, k+1) f32, the layout K5 (gj_kernels.cu) reads:
// G = Gaug[:, :k, :k], r = Gaug[:, :k, k].
//
// What bounds it on an H100, at k = 40 ((k+1)^2 = 1,681 multiply-adds a
// lane on the full square, 861 on the upper triangle this kernel forms):
// * als.yahoo_r1 (230 M real lanes an iteration): the columns side reads
//   115 M W rows of 160 bytes from a 312 MB table, beyond the 50 MB L2
//   (18.4 GB from HBM), and the rows side writes 1.95 M grams of 6.7 KB
//   (13.1 GB); with indices and ratings about 35 GB, 10.4 ms at
//   3.35 TB/s, against about 7 ms of this design's FFMA at 67 TFLOP/s. It
//   is bound by bytes: the gathers have to overlap the arithmetic.
// * als.ml20m (40 M lanes): the factor tables (4-22 MB) sit in L2 and the
//   grams are 1.1 GB, so it is bound by the f32 operations (1.2 ms).
//
// What the design does about it:
// * Real lanes only. A slot's ratings sit in its first counts[s] lanes
//   (data/ell.py::_fill_side); the later lanes are the zero slot with
//   value 0, exact zeros in the sum, and are never read. At the cells'
//   auto floors that skips 41-44% of the layout's lanes.
// * No gathered operand in device memory. The other side's factor rows
//   go from `other` (n, k) straight into a ring of kStages shared-memory
//   stages of kStageLanes lanes each, by 16-byte cp.async (4-byte where
//   k % 4 != 0), kStages - 1 stages in flight while the block computes
//   on the current one, the indices and ratings of twice as many stages
//   ahead in a ring of their own; the rating goes into column k of the
//   staged row.
//   A lane index outside `other` (the ELL pad slot) copies zeros
//   (cp.async's src-size 0), so the function is the plain version's on any
//   lane below the count.
// * Register tiles. Thread t holds a 6 x 6 tile (ti, tj), ti <= tj, of the
//   (6T)^2 padded gram, T = ceil((k+1)/6): only the tiles on or above the
//   diagonal (28 at k = 40, one warp). A tile's six operands are read from
//   the staged row as one 16-byte and one 8-byte load (for odd ti the
//   8-byte load comes first, so the registers hold the tile's rows rotated
//   by 2, undone at the store): 36 FFMA to 4 shared loads a lane. Rows are
//   padded to P = 6T rounded up to 4 floats in shared memory only.
// * A block a work item, no float atomics. An item is a slot (buckets
//   with E <= chunk) or a chunk-lane segment of one: a bucket wider than
//   the chunk cuts every slot into ceil(E/chunk) segments by lane
//   position (segments past a slot's count are empty and store zeros);
//   each segment writes its partial gram to scratch, and
//   als_gram_sum_kernel adds a slot's partials in segment order. Every sum
//   runs in a fixed order, so runs repeat bit for bit.
// * The lower triangle is the upper one's mirror, stored from the same
//   registers: f32 products commute, so the gram is exactly symmetric.
//   The tiles go into shared memory (the ring's bytes, once its last stage
//   is done), and the block writes the gram out in coalesced 16-byte
//   pieces: 6.7 KB a slot at k = 40, 13.1 GB an iteration on Yahoo's rows
//   side, whose 1.95 M short slots make it bound by that write.
//
// Numerics: f32 FFMA only (no TF32, no bf16), each entry summed over the
// segment's lanes in lane order, then over segments in segment order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxK = 128;
constexpr int kWarp = 32;
constexpr int kTile = 6;          // a thread's register tile, kTile x kTile
constexpr int kStageLanes = 16;   // lanes a stage of the ring
static_assert(2 * kStageLanes == kWarp, "a warp fetches a stage's indices "
              "and ratings");
constexpr int kStages = 3;        // stages of the ring
constexpr int kAhead = kStages - 1;  // stages of rows in flight
// stages of indices and ratings held: a stage's indices must have landed
// kAhead stages before its rows are fetched
constexpr int kMetaStages = 2 * kAhead;
constexpr int kMaxThreads = 256;  // k = 128: T = 22, 253 tiles
constexpr int kSumThreads = 256;

struct Shape {
  int T;        // tiles along an edge
  int P;        // floats a staged lane row
  int threads;  // the block: a warp for every 32 tiles
};

// floats of the ring or of a gram placed up to 3 floats past its start,
// whichever is more, rounded up to 16 bytes
__host__ __device__ inline int union_floats(int k1, int P) {
  const int ring = kStages * kStageLanes * P, gram = k1 * k1 + 3;
  return ((ring > gram ? ring : gram) + 3) / 4 * 4;
}

Shape shape_of(int k) {
  const int T = (k + 1 + kTile - 1) / kTile;
  const int tiles = T * (T + 1) / 2;
  return Shape{T, (kTile * T + 3) / 4 * 4,
               (tiles + kWarp - 1) / kWarp * kWarp};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(long long* dst,
                                          const long long* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest kAhead - 1 complete
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a lane's row of `other`, or -1 (copy zeros) for an index outside it
__device__ __forceinline__ int row_of(long long r, long long n_other) {
  return r >= 0 && r < n_other ? static_cast<int>(r) : -1;
}

__global__ void __launch_bounds__(kMaxThreads)
als_gram_kernel(const long long* __restrict__ idx,
                const float* __restrict__ val,
                const float* __restrict__ counts,
                const float* __restrict__ other, long long n_other,
                float* __restrict__ out, float* __restrict__ part, int E,
                int chunk, int segs, int k, int T, int P, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int k1 = k + 1;
  // the ring [kStages][kStageLanes][P], and after the last stage the
  // gram on its way out; then the indices and ratings of kMetaStages
  // stages
  float* ring = smem;
  long long* midx = reinterpret_cast<long long*>(smem + union_floats(k1, P));
  float* mval = reinterpret_cast<float*>(midx + kMetaStages * kStageLanes);
  const int t = threadIdx.x, nt = blockDim.x;
  const long long item = blockIdx.x;
  const long long s = item / segs;
  // the item's lanes: the slot's real ones (an exact float count, at most
  // E) from chunk * segment on, at most chunk of them
  const float count = counts[s];
  const int first = static_cast<int>(item - s * segs) * chunk;
  const long long base = s * E + first;
  float* dest = (segs == 1 ? out + s * k1 * k1 : part + item * k1 * k1);

  // the thread's tile (ti, tj), row-major over the upper triangle; the
  // threads past the last tile compute the last diagonal tile and store
  // nothing
  int ti = 0, rem = t;
  while (ti < T && rem >= T - ti) {
    rem -= T - ti;
    ++ti;
  }
  const bool active = ti < T;
  if (!active) {
    ti = T - 1;
    rem = 0;
  }
  const int tj = ti + rem;
  const int xq = kTile * ti + ((ti & 1) ? 2 : 0);   // 16-byte operand
  const int xd = kTile * ti + ((ti & 1) ? 0 : 4);   // 8-byte operand
  const int yq = kTile * tj + ((tj & 1) ? 2 : 0);
  const int yd = kTile * tj + ((tj & 1) ? 0 : 4);

  // the indices (the first warp's first half) and ratings (its second)
  // of stage st's lanes below ``lanes`` into their slot (no commit)
  auto fetch_meta = [&](int st, int lanes) {
    const int e = t % kStageLanes, lane = st * kStageLanes + e;
    if (t < kWarp && lane < lanes) {
      const int m = (st % kMetaStages) * kStageLanes + e;
      if (t < kStageLanes)
        cp_async8(midx + m, idx + base + lane);
      else
        cp_async4(mval + m, val + base + lane, 4);
    }
  };
  // the lanes the slot's layout holds from ``first`` on (valid memory
  // before the count is known) cover the first kMetaStages stages
  const int held = E - first < chunk ? E - first : chunk;
#pragma unroll
  for (int st = 0; st < kMetaStages; ++st) fetch_meta(st, held);
  cp_async_commit();
  const int pad = P - k1;              // the rows' columns past k: zeros
  for (int q = t; q < kStages * kStageLanes * pad; q += nt)
    ring[(q / pad) * P + k1 + q % pad] = 0.f;
  int n = static_cast<int>(count);
  n = (n < 0 ? 0 : (n > E ? E : n)) - first;
  n = n < 0 ? 0 : (n > chunk ? chunk : n);
  const int stages = (n + kStageLanes - 1) / kStageLanes;
  cp_async_wait_all();
  __syncthreads();

  // the row copies of stage st into its ring slot, from its landed
  // indices, and its ratings into column k (no commit); a thread's copies
  // walk the stage's pieces nt apart, piece q = e * per + c being copy c
  // of lane e's row: one division here, none per copy
  const int width = vec ? 4 : 1;       // floats a copy
  const int per = k / width;           // copies a row
  const int e0 = t / per, c0 = t - e0 * per;
  const int de = nt / per, dc = nt - de * per;
  auto fetch_rows = [&](int st) {
    if (st >= stages) return;
    float* rows = ring + (st % kStages) * kStageLanes * P;
    const long long* mi = midx + (st % kMetaStages) * kStageLanes;
    const float* mv = mval + (st % kMetaStages) * kStageLanes;
    int lanes = n - st * kStageLanes;
    lanes = lanes < kStageLanes ? lanes : kStageLanes;
    for (int e = e0, c = c0; e < lanes;) {
      const int r = row_of(mi[e], n_other);
      float* dst = rows + e * P + width * c;
      const float* src =
          other + static_cast<long long>(r < 0 ? 0 : r) * k + width * c;
      if (vec)
        cp_async16(dst, src, r < 0 ? 0 : 16);
      else
        cp_async4(dst, src, r < 0 ? 0 : 4);
      e += de;
      c += dc;
      if (c >= per) {
        c -= per;
        ++e;
      }
    }
    for (int e = t; e < lanes; e += nt) rows[e * P + k] = mv[e];
  };

  // commit groups: the rows of stages 0 .. kAhead - 1, one a stage, then
  // at iteration st the rows of st + kAhead with the indices and ratings
  // of st + kMetaStages
#pragma unroll
  for (int st = 0; st < kAhead; ++st) {
    fetch_rows(st);
    cp_async_commit();
  }
  float acc[kTile][kTile] = {};
  for (int st = 0; st < stages; ++st) {
    cp_async_wait_ahead();             // stage st's rows, st + kAhead's
    __syncthreads();                   // indices, for every thread; and
    fetch_rows(st + kAhead);           // st - 1 done: its slot is free
    if (st + kMetaStages < stages) fetch_meta(st + kMetaStages, n);
    cp_async_commit();
    const float* rows = ring + (st % kStages) * kStageLanes * P;
    int lanes = n - st * kStageLanes;
    lanes = lanes < kStageLanes ? lanes : kStageLanes;
#pragma unroll 4
    for (int e = 0; e < lanes; ++e) {
      const float* r = rows + e * P;
      const float4 a = *reinterpret_cast<const float4*>(r + xq);
      const float2 a2 = *reinterpret_cast<const float2*>(r + xd);
      const float4 b = *reinterpret_cast<const float4*>(r + yq);
      const float2 b2 = *reinterpret_cast<const float2*>(r + yd);
      const float x[kTile] = {a.x, a.y, a.z, a.w, a2.x, a2.y};
      const float y[kTile] = {b.x, b.y, b.z, b.w, b2.x, b2.y};
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
  }

  // the gram goes out through shared memory, placed as far past a
  // 16-byte boundary as dest is, so that the copy out moves 16-byte pieces
  const int F = k1 * k1;
  const int shift =
      static_cast<int>(reinterpret_cast<uintptr_t>(dest) / 4 % 4);
  float* g = smem + shift;
  __syncthreads();                     // every thread is done with the ring
  if (active) {
    // register i holds the tile's row (i + 2) % 6 where ti is odd (its
    // 8-byte operand, columns 0-1, came first), likewise j and tj
    const int ro = (ti & 1) ? 2 : 0, co = (tj & 1) ? 2 : 0;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int row = kTile * ti + (i + ro) % kTile;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int col = kTile * tj + (j + co) % kTile;
        if (row < k1 && col < k1) {
          g[row * k1 + col] = acc[i][j];
          g[col * k1 + row] = acc[i][j];   // the same cell on the diagonal
        }
      }
    }
  }
  __syncthreads();
  int head = (4 - shift) % 4;
  head = head < F ? head : F;
  const int pieces = (F - head) / 4;
  if (t < head) dest[t] = g[t];
  for (int q = t; q < pieces; q += nt)
    *reinterpret_cast<float4*>(dest + head + 4 * q) =
        *reinterpret_cast<const float4*>(g + head + 4 * q);
  for (int j = head + 4 * pieces + t; j < F; j += nt) dest[j] = g[j];
}

// out[s] = part[s * segs] + part[s * segs + 1] + ... in segment order; a
// block a slot and kSumThreads of its F = (k+1)^2 entries
__global__ void __launch_bounds__(kSumThreads)
als_gram_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int segs, int F, int per) {
  const long long b = blockIdx.x;
  const long long s = b / per;
  const int x = static_cast<int>(b - s * per) * kSumThreads + threadIdx.x;
  if (x >= F) return;
  const float* p = part + s * segs * F + x;
  float acc = p[0];
  for (int j = 1; j < segs; ++j) acc += p[static_cast<long long>(j) * F];
  out[s * F + x] = acc;
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError(): a refused launch
// (bad configuration) never runs and is reported only here.
extern "C" {

// The (S, k+1, k+1) augmented grams of S slots of one bucket row group:
// idx (S * E) int64 and val (S * E) f32 lanes, slot s in [s*E, (s+1)*E);
// counts (S) f32, each slot's real lanes; other (n_other, k) f32
// contiguous. A bucket wider than ``chunk`` lanes needs ``part``, scratch
// of S * ceil(E / chunk) grams; else ``part`` is not read.
int crtpu_als_gram(const void* idx, const void* val, const void* counts,
                   const void* other, long long n_other, void* out,
                   void* part, long long S, int E, int chunk, int k,
                   void* stream) {
  if (k < 1 || k > kMaxK || E < 1 || chunk < 1 || S < 0 || n_other < 0 ||
      n_other > INT_MAX)
    return cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int segs = (E + chunk - 1) / chunk;
  if (S * segs > INT_MAX || (segs > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  static bool carveout = false;
  if (!carveout) {
    const cudaError_t err = cudaFuncSetAttribute(
        als_gram_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    carveout = true;
  }
  const Shape sh = shape_of(k);
  const size_t smem =
      static_cast<size_t>(union_floats(k + 1, sh.P)) * sizeof(float) +
      static_cast<size_t>(kMetaStages) * kStageLanes *
          (sizeof(long long) + sizeof(float));
  static size_t opted = 48 * 1024;    // dynamic shared memory allowed
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        als_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const int vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(other) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  als_gram_kernel<<<static_cast<unsigned>(S * segs), sh.threads, smem, st>>>(
      static_cast<const long long*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(counts), static_cast<const float*>(other),
      n_other, static_cast<float*>(out), static_cast<float*>(part), E, chunk,
      segs, k, sh.T, sh.P, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || segs == 1) return static_cast<int>(err);
  const int F = (k + 1) * (k + 1);
  const int per = (F + kSumThreads - 1) / kSumThreads;
  if (S * per > INT_MAX) return cudaErrorInvalidValue;
  als_gram_sum_kernel<<<static_cast<unsigned>(S * per), kSumThreads, 0,
                        st>>>(static_cast<const float*>(part),
                              static_cast<float*>(out), segs, F, per);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
