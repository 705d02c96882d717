// Batched pivot-free Gauss-Jordan solve of small SPD systems, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (ops/build.py, ops/gj_kernels.py).
//
// Replaces the Pallas TPU kernel of cuda_recommender_tpu/ops/gj_pallas.py:
//   crtpu_gj_solve  <- gj_solve_pallas_bl (_gj_kernel / _gj_kernel_dma)
//
// x = A^-1 b for S systems, A (S, k, k) and b (S, k) float32, 1 <= k <= 128;
// A are the ALS normal equations F^T F + lambda*I, SPD with their mass on
// the diagonal, so the elimination needs no pivoting. Each of the k steps
// is, on the augmented matrix M = [A | b]:
//   prow = M[i, :] / M[i, i];  M[r, :] -= M[r, i] * prow  (all r);
//   M[i, :] = prow
// and column k of M ends as x. A and b may be strided views (e.g. of the
// (S, k+1, k+1) augmented gram the ALS assembly makes, where row r of
// [A | b] is k+1 contiguous floats): the caller passes the batch and row
// strides; A's columns must be contiguous.
//
// What bounds it on an H100: not memory. A system is read once (4k(k+1)
// bytes) and its solution written once (4k), while the elimination does
// k dependent steps on data that stays on chip. It is bound by instruction
// issue, so the design spends issue only on needed work:
//
// * Only live columns are updated. At step i, columns <= i are finished:
//   prow[i] = d/d, so column i of every other row becomes 0 and never
//   changes again, and column k (x) reads only the multipliers M[r, i] of
//   the current step. So step i updates columns i+1 .. k, half the work of
//   a full sweep on average, and x keeps its bits (tests/test_torch_gj.py
//   holds such an elimination bit-equal to the plain version).
// * Rows lie across lanes, columns in registers (gj_rows_kernel, k <= 64).
//   A system is padded to a compile-time width K (a multiple of 8) as
//   identity, and kLanes lanes hold its rows, kR = K / kLanes of them a
//   lane (row j*kLanes + t in lane t, slot j); a warp holds 32 / kLanes
//   systems. The steps are unrolled at compile time (a fold over an index
//   sequence), so each row's multiplier M[r, i] is a register with a
//   compile-time index -- no shuffle, no select -- and each update loop has
//   a compile-time trip count. Steps past k are skipped: they would only
//   subtract exact zeros from the real rows.
// * No block barrier. A system lives in one warp; the pivot row goes
//   through a per-warp shared buffer: the owning lane stores its live
//   columns with 16-byte stores, __syncwarp, the system's lanes divide the
//   live elements between them (true division, one or a few each),
//   __syncwarp, every lane reads prow with 16-byte broadcast loads. The
//   buffer alternates by step parity, so two __syncwarp a step order every
//   write after the reads of the step before. Many independent warps a SM
//   hide the division's latency.
// * Coalesced loads that overlap the elimination. A warp walks its systems
//   (a grid-stride loop over groups of 32 / kLanes systems). It stages a
//   system in shared memory with 4-byte cp.async copies of consecutive
//   elements (the rows of the ALS gram are contiguous, so consecutive lanes
//   read consecutive addresses whatever the 4-byte offset of the system),
//   moves its rows into registers, and starts copying the next group
//   before it eliminates the current one. Staged rows are K+1 floats apart
//   (odd), so the lanes' row reads hit distinct banks. The pad cells of
//   the stage hold the identity and are written once.
// * Above k = 64 rows of k+1 floats do not fit in registers, so
//   gj_slots_kernel keeps the columns across the lanes of a warp (column c
//   in lane c % 32, register slot c / 32) and the rows across the warps of
//   a block, 8 a warp, with one __syncthreads a step; it skips the column
//   slots that are wholly finished (a warp-uniform test), and takes each
//   row's multiplier by a shuffle from the lane of column i, its slot by a
//   PTX select (a dynamic index would move the register array to local
//   memory).
//
// Numerics: prow uses true IEEE division (__fdiv_rn) and the update is
// fl(M - fl(M[r, i] * prow)) with explicit _rn intrinsics, the same
// roundings the plain PyTorch version does, so nvcc's FMA contraction
// cannot change the result. No fast-math. Each system is reduced inside one
// warp (k <= 64) or one block, with no atomics, so runs repeat bit for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <utility>

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxRowsK = 64;     // widest system gj_rows_kernel takes
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsWarps = 2;     // warps a block of gj_rows_kernel
constexpr int kSlotRows = 8;      // rows a warp of gj_slots_kernel

// ---------------------------------------------------------------- k <= 64

// Lanes a system at width K: all 32 rows in one slot, or fewer lanes with
// more slots a lane while the registers hold them.
constexpr int lanes_for(int K) { return K <= 24 ? 8 : K <= 32 ? 16 : 32; }

template <int K>
struct Rows {
  static constexpr int kLanes = lanes_for(K);
  static constexpr int kR = (K + kLanes - 1) / kLanes;  // row slots a lane
  static constexpr int kSys = kWarp / kLanes;           // systems a warp
  static constexpr int kP = K + 1;                      // staged row stride
  static constexpr int kQ = (K + 4) / 4 * 4;            // pivot row, 16 B
  static constexpr int kSlot = K * kP + 4;              // a system's stage
  static constexpr int kStage = kSys * kSlot;           // floats a warp
  static constexpr int kWarpFloats = kStage + 2 * kSys * kQ;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where a lane's element e of one system, (row, col) of [A | b], lies:
// the walk advances e by 32, so (row, col) advance by (drow, dcol).
struct Walk {
  int row0, col0, drow, dcol;
};

// Floats that system s's [A | b] starts past a 16-byte boundary: its
// stage starts as far into its slot, so that a flat copy keeps 16-byte
// pieces aligned at both ends (0 unless the copy is flat).
__device__ __forceinline__ int stage_shift(const float* A, long long sA0,
                                           long long s, bool flat) {
  return flat ? static_cast<int>(
                    (reinterpret_cast<unsigned long long>(A + s * sA0) / 4) %
                    4)
              : 0;
}

// Starts the copies of system s's [A | b] into its slot (row r at
// shift + r * kP, b in column K). ``flat``: the system is the k(k+1)
// contiguous floats of the ALS gram's rows at k == K, laid out as its
// stage, so it goes in 16-byte pieces and its ends 4 bytes at a time;
// else element by element, walking (row, col).
template <int K>
__device__ __forceinline__ void fetch(float* slot, const float* A,
                                      long long sA0, long long sA1,
                                      const float* b, long long sb0,
                                      long long sb1, long long s, int k,
                                      bool flat, int lane, const Walk& w) {
  const float* As = A + s * sA0;
  const float* bs = b + s * sb0;
  const int shift = stage_shift(A, sA0, s, flat);
  float* dst = slot + shift;
  if (flat) {
    constexpr int n = K * (K + 1);
    const int head = (4 - shift) % 4;
    const int pieces = (n - head) / 4;
    const int tail = head + 4 * pieces;   // n - tail < 4 floats after
#pragma unroll 4
    for (int j = lane; j < pieces; j += kWarp)
      cp_async16(dst + head + 4 * j, As + head + 4 * j);
    if (lane < head) cp_async4(dst + lane, As + lane);
    if (lane >= 4 && lane - 4 < n - tail)
      cp_async4(dst + tail + lane - 4, As + tail + lane - 4);
    return;
  }
  const int n = k * (k + 1);
  int row = w.row0, col = w.col0;
#pragma unroll 4
  for (int e = lane; e < n; e += kWarp) {
    const bool in_a = col < k;
    cp_async4(dst + row * Rows<K>::kP + (in_a ? col : K),
              in_a ? As + row * sA1 + col : bs + row * sb1);
    col += w.dcol;
    row += w.drow;
    if (col > k) {
      col -= k + 1;
      ++row;
    }
  }
}

// Step I of the elimination on the lane's rows m (slot j holds row
// j * kLanes + t); pivot holds the system's two pivot-row buffers.
template <int K, int I>
__device__ __forceinline__ void step(float (&m)[Rows<K>::kR][K + 1],
                                     float* pivot, int t) {
  using R = Rows<K>;
  constexpr int jo = I / R::kLanes;     // slot of row I
  constexpr int to = I % R::kLanes;     // lane of row I
  constexpr int q0 = I / 4;             // first 16-byte chunk stored
  constexpr int q1 = (I + 1) / 4;       // first chunk read back
  constexpr int qn = K / 4 + 1;         // chunks of columns 0 .. K
  float* pb = pivot + (I & 1) * R::kQ;
  const bool owner = t == to;
  if (owner) {                          // raw row I, columns I .. K
#pragma unroll
    for (int q = q0; q < qn; ++q) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * q + c;
        v[c] = (col >= I && col <= K) ? m[jo][col <= K ? col : K] : 0.f;
      }
      reinterpret_cast<float4*>(pb)[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncwarp();
  const float d = pb[I];
  constexpr int rounds = (K - I + R::kLanes - 1) / R::kLanes;
#pragma unroll
  for (int r = 0; r < rounds; ++r) {    // prow[c] = M[I, c] / d, c > I
    const int c = I + 1 + t + r * R::kLanes;
    if (c <= K) pb[c] = __fdiv_rn(pb[c], d);
  }
  __syncwarp();
  // prow a 16-byte chunk at a time, applied to every row slot before the
  // next chunk is read (few registers live); column I is not updated, so
  // each row's multiplier m[j][I] holds through the step
#pragma unroll
  for (int q = q1; q < qn; ++q) {
    const float4 v = reinterpret_cast<const float4*>(pb)[q];
    const float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < R::kR; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e <= K ? 4 * q + e : K;
        if (4 * q + e <= I || 4 * q + e > K) continue;
        const float u = __fsub_rn(m[j][c], __fmul_rn(m[j][I], pv[e]));
        m[j][c] = (j == jo && owner) ? pv[e] : u;  // row I becomes prow
      }
    }
  }
}

// Steps 0 .. k-1 (k <= K), each with a compile-time index.
template <int K, int... Is>
__device__ __forceinline__ void eliminate(float (&m)[Rows<K>::kR][K + 1],
                                          float* pivot, int t, int k,
                                          std::integer_sequence<int, Is...>) {
  (void)((Is < k && (step<K, Is>(m, pivot, t), true)) && ...);
}

template <int K>
__global__ void __launch_bounds__(kRowsWarps * kWarp)
gj_rows_kernel(const float* __restrict__ A, long long sA0, long long sA1,
               const float* __restrict__ b, long long sb0, long long sb1,
               float* __restrict__ x, long long S, int k) {
  using R = Rows<K>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* stage = smem + warp * R::kWarpFloats;
  const int g = lane / R::kLanes;       // system within the warp
  const int t = lane % R::kLanes;       // lane within the system
  float* pivot = stage + R::kStage + g * 2 * R::kQ;
  const long long groups = (S + R::kSys - 1) / R::kSys;
  const long long warps = static_cast<long long>(gridDim.x) * kRowsWarps;
  long long grp = static_cast<long long>(blockIdx.x) * kRowsWarps + warp;
  if (grp >= groups) return;            // warp-uniform

  if (k < K) {                          // pad cells: the identity, once
    for (int e = lane; e < R::kStage; e += kWarp) {
      const int c = (e % R::kSlot) % R::kP, r = (e % R::kSlot) / R::kP;
      if (r < K && (r >= k || (c >= k && c < K)))
        stage[e] = r == c ? 1.f : 0.f;
    }
  }
  const Walk w{lane / (k + 1), lane % (k + 1), kWarp / (k + 1),
               kWarp % (k + 1)};
  const bool flat = k == K && b == A + k && sb0 == sA0 && sA1 == k + 1 &&
                    sb1 == k + 1;
  auto fetch_group = [&](long long gi) {
#pragma unroll
    for (int u = 0; u < R::kSys; ++u) {
      const long long s = gi * R::kSys + u;
      if (s < S)
        fetch<K>(stage + u * R::kSlot, A, sA0, sA1, b, sb0, sb1, s, k, flat,
                 lane, w);
    }
    cp_async_commit();
  };

  fetch_group(grp);
  for (; grp < groups; grp += warps) {
    cp_async_wait_all();
    __syncwarp();
    const long long s = grp * R::kSys + g;
    const float* sys = stage + g * R::kSlot +
                       stage_shift(A, sA0, s < S ? s : 0, flat);
    float m[R::kR][K + 1];
#pragma unroll
    for (int j = 0; j < R::kR; ++j) {
      // a phantom row past K (kR * kLanes > K) reads row K-1: it is never
      // a pivot and never stored
      const int r = j * R::kLanes + t;
      const float* src =
          sys + ((j + 1) * R::kLanes > K && r >= K ? K - 1 : r) * R::kP;
#pragma unroll
      for (int c = 0; c <= K; ++c) m[j][c] = src[c];
    }
    __syncwarp();
    if (grp + warps < groups) fetch_group(grp + warps);
    eliminate<K>(m, pivot, t, k, std::make_integer_sequence<int, K>{});
    if (s < S) {
#pragma unroll
      for (int j = 0; j < R::kR; ++j) {
        const int r = j * R::kLanes + t;
        if (r < k) x[s * k + r] = m[j][K];
      }
    }
  }
}

// ----------------------------------------------------------------- k > 64

// c ? a : b as one PTX selp. Written in C++, a chain of these over a
// register array m[q] is folded by the optimizer into the indexed load
// m[qi], which moves the whole array to local memory; the asm is opaque to
// that fold.
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(r)
      : "r"(static_cast<unsigned>(c)), "f"(a), "f"(b));
  return r;
}

// One system a block: ceil(k / 8) warps of 8 rows, kCols column slots a
// lane. Per step i: the warp that owns row i divides its live slots by the
// pivot (fetched by a shuffle from the lane of column i) and publishes
// them to shared memory, one __syncthreads, and every warp updates its
// rows' live slots (slots with a column > i), each row's multiplier taken
// by a shuffle before that row's update. The pivot-row buffer alternates
// by step parity, so one barrier a step suffices.
template <int kCols>
__global__ void __launch_bounds__(kMaxK / kSlotRows * kWarp)
gj_slots_kernel(const float* __restrict__ A, long long sA0, long long sA1,
                const float* __restrict__ b, long long sb0, long long sb1,
                float* __restrict__ x, int k) {
  extern __shared__ __align__(16) float smem[];  // [2 parities][kCols * 32]
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int wps = blockDim.x / kWarp;
  const long long s = blockIdx.x;
  const int r0 = w * kSlotRows;

  float m[kSlotRows][kCols];
#pragma unroll
  for (int j = 0; j < kSlotRows; ++j) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int r = r0 + j;
      const int c = q * kWarp + lane;
      float v = 0.f;
      if (r < k && c < k)
        v = A[s * sA0 + r * sA1 + c];
      else if (r < k && c == k)
        v = b[s * sb0 + r * sb1];
      m[j][q] = v;
    }
  }

  for (int wo = 0; wo < wps; ++wo) {
#pragma unroll
    for (int jo = 0; jo < kSlotRows; ++jo) {
      const int i = wo * kSlotRows + jo;
      if (i >= k) continue;             // block-uniform: rows past the edge
      float* prow_s = smem + (i & 1) * (kCols * kWarp);
      const int qi = i / kWarp;         // register slot of column i
      const int li = i % kWarp;         // lane of column i
      const int qlive = (i + 1) / kWarp;  // first slot with a column > i
      if (w == wo) {                    // warp-uniform: this warp owns row i
        float piv = m[jo][0];
#pragma unroll
        for (int q = 1; q < kCols; ++q) piv = select(q == qi, m[jo][q], piv);
        const float d = __shfl_sync(kFull, piv, li);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (q < qlive) continue;
          m[jo][q] = __fdiv_rn(m[jo][q], d);
          prow_s[q * kWarp + lane] = m[jo][q];
        }
      }
      __syncthreads();
      float p[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        p[q] = q < qlive ? 0.f : prow_s[q * kWarp + lane];
#pragma unroll
      for (int j = 0; j < kSlotRows; ++j) {
        float v = m[j][0];
#pragma unroll
        for (int q = 1; q < kCols; ++q) v = select(q == qi, m[j][q], v);
        const float mult = __shfl_sync(kFull, v, li);
        if (j != jo || w != wo) {       // row i itself keeps prow
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            if (q < qlive) continue;
            m[j][q] = __fsub_rn(m[j][q], __fmul_rn(mult, p[q]));
          }
        }
      }
    }
  }

  if (lane == k % kWarp) {              // the lane of column k holds x
#pragma unroll
    for (int j = 0; j < kSlotRows; ++j) {
      float v = m[j][0];
#pragma unroll
      for (int q = 1; q < kCols; ++q) v = select(q == k / kWarp, m[j][q], v);
      if (r0 + j < k) x[s * k + r0 + j] = v;
    }
  }
}

// ---------------------------------------------------------------- launches

template <int K>
int launch_rows(const float* A, long long sA0, long long sA1, const float* b,
                long long sb0, long long sb1, float* x, long long S, int k,
                cudaStream_t stream) {
  using R = Rows<K>;
  const int threads = kRowsWarps * kWarp;
  const size_t smem = static_cast<size_t>(kRowsWarps) * R::kWarpFloats *
                      sizeof(float);
  // as many blocks as fit on the card at once; each warp walks its groups
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          gj_rows_kernel<K>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gj_rows_kernel<K>, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const long long groups = (S + R::kSys - 1) / R::kSys;
  const long long need = (groups + kRowsWarps - 1) / kRowsWarps;
  const long long blocks = need < resident ? need : resident;
  gj_rows_kernel<K><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      A, sA0, sA1, b, sb0, sb1, x, S, k);
  return static_cast<int>(cudaGetLastError());
}

template <int kCols>
int launch_slots(const float* A, long long sA0, long long sA1, const float* b,
                 long long sb0, long long sb1, float* x, long long S, int k,
                 cudaStream_t stream) {
  const int threads = kWarp * ((k + kSlotRows - 1) / kSlotRows);
  const size_t smem = 2 * static_cast<size_t>(kCols) * kWarp * sizeof(float);
  gj_slots_kernel<kCols>
      <<<static_cast<unsigned>(S), threads, smem, stream>>>(
          A, sA0, sA1, b, sb0, sb1, x, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError(): a refused launch
// (bad configuration) never runs and is reported only here.
extern "C" {

int crtpu_gj_solve(const void* A, long long sA0, long long sA1,
                   const void* b, long long sb0, long long sb1, void* x,
                   long long S, int k, void* stream) {
  if (k < 1 || k > kMaxK || S < 0) return cudaErrorInvalidValue;
  if (S == 0) return 0;
  if (k > kMaxRowsK && S > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
#define CRTPU_GJ_ROWS(K) \
  return launch_rows<K>(Af, sA0, sA1, bf, sb0, sb1, xf, S, k, st)
#define CRTPU_GJ_SLOTS(C) \
  return launch_slots<C>(Af, sA0, sA1, bf, sb0, sb1, xf, S, k, st)
  switch ((k + 7) / 8) {              // width: k padded to a multiple of 8
    case 1: CRTPU_GJ_ROWS(8);
    case 2: CRTPU_GJ_ROWS(16);
    case 3: CRTPU_GJ_ROWS(24);
    case 4: CRTPU_GJ_ROWS(32);
    case 5: CRTPU_GJ_ROWS(40);
    case 6: CRTPU_GJ_ROWS(48);
    case 7: CRTPU_GJ_ROWS(56);
    case 8: CRTPU_GJ_ROWS(64);
    default: break;
  }
  switch ((k + 1 + kWarp - 1) / kWarp) {  // column slots of 32 lanes
    case 3: CRTPU_GJ_SLOTS(3);
    case 4: CRTPU_GJ_SLOTS(4);
    case 5: CRTPU_GJ_SLOTS(5);
    default: break;
  }
#undef CRTPU_GJ_ROWS
#undef CRTPU_GJ_SLOTS
  return cudaErrorInvalidValue;
}

}  // extern "C"
