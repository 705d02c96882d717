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
// (S, k+1, k+1) augmented gram the ALS assembly makes): the caller passes
// the batch and row strides; A's columns must be contiguous.
//
// What bounds it on an H100: not memory. A system is read once (4k(k+1)
// bytes) and its solution written once (4k), while the elimination does
// about 2k^2(k+1) flops in k dependent steps. The plain version
// (ops/gj_kernels.py::gj_solve_plain) streams the whole (S, k, k+1) tensor
// through device memory several times per step; the kernel keeps every
// system on chip for all k steps, so it is bound by instruction issue and
// the per-step barrier. The design therefore spends as few instructions per
// element and step as it can: one multiply and one subtract, in registers.
//
// Design. The columns of M = [A | b] lie across the 32 lanes of a warp
// (column c in lane c % 32, register slot c / 32: kCols = ceil((k+1)/32)
// slots), the rows across the warps of a system and kRows register slots
// per warp (warp w owns rows w*kRows .. w*kRows + kRows-1). Every element
// stays in one thread's registers for the whole elimination; columns and
// rows past the system's edge hold zeros and stay zero. Per step i:
//   1. the warp that owns row i divides it by the pivot (fetched by a warp
//      shuffle from the lane that holds column i) and publishes the pivot
//      row to shared memory; it keeps prow as its row i;
//   2. one __syncthreads();
//   3. every thread reads prow at its columns from shared memory, and for
//      each row it owns takes the multiplier M[r, i] by a warp shuffle from
//      the lane that holds column i -- before that row's update, so the
//      zeroing of M[r, i] cannot race with its use -- and updates its
//      elements.
// Column i's register slot is chosen by a PTX select (select() below),
// never by a dynamic array index: that would move the register array to
// local memory.
// The pivot-row buffer is double-buffered by step parity, so one barrier a
// step suffices: a buffer is rewritten two steps later, after every thread
// has passed the next step's barrier. A block holds one system when k >= 32
// (ceil(k/8) warps of 8 rows) and several, one or two warps each, when
// k < 32, so that small systems still fill a block. Lanes past column k
// idle: at k = 40 the two column slots use 41 of 64 lanes.
//
// Numerics: prow uses true IEEE division (__fdiv_rn) and the update is
// fl(M - fl(M[r, i] * prow)) with explicit _rn intrinsics, the same
// roundings the plain PyTorch version does, so nvcc's FMA contraction
// cannot change the result. No fast-math. Each system is reduced inside one
// block with no atomics, so runs repeat bit for bit. The grid covers a
// ragged S exactly: a block's systems past S are solved as identities and
// never stored.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxK = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kBlockWarps = 8;   // warps a block of small systems aims at

struct Geometry {
  int cols;  // register slots of columns per lane: ceil((k+1)/32)
  int rows;  // register slots of rows per warp (the kernel's kRows)
  int wps;   // warps per system
  int spb;   // systems per block
};

Geometry geometry(int k) {
  Geometry g;
  g.cols = (k + 1 + kWarp - 1) / kWarp;
  if (g.cols == 1) {                 // k < 32: one or two warps a system
    g.wps = k <= 16 ? 1 : 2;
    const int need = (k + g.wps - 1) / g.wps;
    g.rows = 1;
    while (g.rows < need) g.rows *= 2;
  } else {                           // 8 rows a warp
    g.rows = 8;
    g.wps = (k + g.rows - 1) / g.rows;
  }
  g.spb = g.wps >= kBlockWarps ? 1 : kBlockWarps / g.wps;
  return g;
}

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

template <int kCols, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
gj_kernel(const float* __restrict__ A, long long sA0, long long sA1,
          const float* __restrict__ b, long long sb0, long long sb1,
          float* __restrict__ x, long long S, int k, int wps) {
  extern __shared__ float prow_buf[];  // [2 parities][spb][kCols * 32]
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int sys = warp / wps;          // system within the block
  const int w = warp - sys * wps;      // warp within the system
  const int spb = blockDim.x / (kWarp * wps);
  const long long s = static_cast<long long>(blockIdx.x) * spb + sys;
  const bool valid = s < S;
  const int r0 = w * kRows;

  float m[kRows][kCols];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int r = r0 + j;
      const int c = q * kWarp + lane;
      float v = 0.f;
      if (r < k && c <= k) {
        if (!valid)
          v = (r == c) ? 1.f : 0.f;
        else if (c < k)
          v = A[s * sA0 + r * sA1 + c];
        else
          v = b[s * sb0 + r * sb1];
      }
      m[j][q] = v;
    }
  }

  // step i = wo * kRows + jo: row i is slot jo (a compile-time index, so
  // the register array never needs a dynamic index) of warp wo. The inner
  // loop has a constant trip count and no early exit, so it unrolls.
  for (int wo = 0; wo < wps; ++wo) {
#pragma unroll
    for (int jo = 0; jo < kRows; ++jo) {
      const int i = wo * kRows + jo;
      if (i >= k) continue;            // block-uniform: rows past the edge
      float* prow_s = prow_buf + ((i & 1) * spb + sys) * (kCols * kWarp);
      const int qi = i / kWarp;        // register slot of column i
      const int li = i % kWarp;        // lane of column i
      if (w == wo) {                   // warp-uniform: this warp owns row i
        float piv = m[jo][0];
#pragma unroll
        for (int q = 1; q < kCols; ++q) piv = select(q == qi, m[jo][q], piv);
        const float d = __shfl_sync(kFull, piv, li);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          m[jo][q] = __fdiv_rn(m[jo][q], d);
          prow_s[q * kWarp + lane] = m[jo][q];
        }
      }
      __syncthreads();
      float p[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) p[q] = prow_s[q * kWarp + lane];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        // M[r, i] from the lane of column i, before row r's update
        float v = m[j][0];
#pragma unroll
        for (int q = 1; q < kCols; ++q) v = select(q == qi, m[j][q], v);
        const float mult = __shfl_sync(kFull, v, li);
        if (j != jo || w != wo) {      // row i itself keeps prow
#pragma unroll
          for (int q = 0; q < kCols; ++q)
            m[j][q] = __fsub_rn(m[j][q], __fmul_rn(mult, p[q]));
        }
      }
    }
  }

  if (valid && lane == k % kWarp) {    // the lane of column k holds x
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float v = m[j][0];
#pragma unroll
      for (int q = 1; q < kCols; ++q) v = select(q == k / kWarp, m[j][q], v);
      if (r0 + j < k) x[s * k + r0 + j] = v;
    }
  }
}

template <int kCols, int kRows>
void launch(const float* A, long long sA0, long long sA1, const float* b,
            long long sb0, long long sb1, float* x, long long S, int k,
            const Geometry& geo, cudaStream_t stream) {
  const int threads = kWarp * geo.wps * geo.spb;
  const long long blocks = (S + geo.spb - 1) / geo.spb;
  const size_t smem = 2 * static_cast<size_t>(geo.spb) * kCols * kWarp *
                      sizeof(float);
  gj_kernel<kCols, kRows>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
          A, sA0, sA1, b, sb0, sb1, x, S, k, geo.wps);
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
  const Geometry geo = geometry(k);
  if ((S + geo.spb - 1) / geo.spb > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(b);
  float* xf = static_cast<float*>(x);
#define CRTPU_GJ_LAUNCH(C, R)                                          \
  launch<C, R>(Af, sA0, sA1, bf, sb0, sb1, xf, S, k, geo, st)
  if (geo.cols == 1 && geo.rows == 1) CRTPU_GJ_LAUNCH(1, 1);
  else if (geo.cols == 1 && geo.rows == 2) CRTPU_GJ_LAUNCH(1, 2);
  else if (geo.cols == 1 && geo.rows == 4) CRTPU_GJ_LAUNCH(1, 4);
  else if (geo.cols == 1 && geo.rows == 8) CRTPU_GJ_LAUNCH(1, 8);
  else if (geo.cols == 1 && geo.rows == 16) CRTPU_GJ_LAUNCH(1, 16);
  else if (geo.cols == 2) CRTPU_GJ_LAUNCH(2, 8);
  else if (geo.cols == 3) CRTPU_GJ_LAUNCH(3, 8);
  else if (geo.cols == 4) CRTPU_GJ_LAUNCH(4, 8);
  else if (geo.cols == 5) CRTPU_GJ_LAUNCH(5, 8);
  else return cudaErrorInvalidValue;
#undef CRTPU_GJ_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
