// Fused CCD++ residual passes for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/build.py, ops/panel_kernels.py,
// ops/ccd_kernels.py).
//
// Three entry points, one per pass, each for either mask mode. They replace
// the Pallas TPU kernels (files under cuda_recommender_tpu/)
//   crtpu_update_vsweep, NaN sentinel <- ops/panel_pallas.py
//                                        panel_update_vsweep (K1)
//   crtpu_vsweep, NaN sentinel        <- ops/panel_pallas.py panel_vsweep (K3)
//   crtpu_usweep, NaN sentinel        <- ops/panel_pallas.py panel_usweep (K2)
//   crtpu_update_vsweep, explicit     <- ops/ccd_pallas.py
//                                        fused_update_vsweep (K4)
// and, with an explicit mask, the XLA sweeps of the dense schedule
// (solvers/ccd_dense.py::_half_sweep): crtpu_vsweep (masked_vsweep) and
// crtpu_usweep (masked_usweep). A fourth entry point,
// crtpu_update_vsweep_irne, is K1 with its store rounded the other way:
// the port of the rounding variant of scripts/panel_kernel_variants.py
// (P2, run_uv_variant with _uv_kernel_astype), a probe, not a training pass.
//
// A residual is an (M, W) row-major block, float32 or bfloat16. Its mask is
// either the NaN sentinel (unobserved cells hold NaN; no mask array) or an
// explicit {0,1} array of the same shape, bfloat16 or int8 (unobserved
// residual cells hold 0). Per rank:
//   update+v-sweep, NaN sentinel (K1): R' = round(R + (uo*vo - up*vp)) in
//      place, then g[j] = sum_i uo[i]*R'[i,j]*m, h[j] = sum_i uo[i]^2*m,
//      m = !isnan(R'): the sweep reads the STORED value.
//   update+v-sweep, explicit mask (K4): s = R + fl(fl(uo*vo - up*vp)*m)
//      stored as round(s) in place, g[j] = sum_i uo[i]*s, h[j] =
//      sum_i fl(uo[i]^2)*m: the sweep reads s BEFORE the rounding, as the
//      Pallas kernel sums its f32 block (ccd_pallas.py:41-51).
//   v-sweep (K3, masked_vsweep): the same sums over R without the update.
//   u-sweep (K2, masked_usweep): g[i] = sum_j R[i,j]*v[j] (times m in NaN
//      mode), h[i] = sum_j fl(v[j]^2)*m.
//
// What bounds them on an H100: memory. Each cell costs a handful of flops
// and 2 bytes read (+2 written by an update) at bf16, 4 (+4) at f32, plus 2
// (bf16) or 1 (int8) mask byte(s) read in explicit-mask mode; a 6.5e9-cell
// bf16 stair is 13 GB per pass. The design streams every cell once,
// coalesced (a warp reads 32 consecutive cells of one row, and the mask
// cell beside each residual cell), keeps the factor vectors in registers or
// the read-only cache, and in NaN mode takes the mask from the sentinel
// in-register, so no mask array exists.
//
// The Pallas kernels accumulate g/h across a sequential grid; GPU blocks run
// in parallel, so the column sums (K1, K3, K4, masked_vsweep) are reduced
// deterministically in two passes: each block owns a strip of rows x 128
// columns and writes its per-column partials (fixed order inside the
// block), then one thread per column adds the strips' partials in strip
// order. No float atomics: runs repeat bit for bit. The u-sweeps give each
// row to one warp, which walks the whole row and reduces with a fixed
// butterfly, so they need no second pass.
//
// Rounding: the delta is formed as fl(fl(uo*vo) - fl(up*vp)) (times the mask
// in explicit mode) and added with explicit _rn intrinsics, so nvcc's FMA
// contraction cannot change the stored bits; the sum is rounded once to the
// storage type (round-to-nearest-even). NaN passes through the add. The
// stored residual is therefore bit-equal to the plain PyTorch versions
// (ops/panel_kernels.py, ops/ccd_kernels.py) on the same card.
//
// The rounding is a policy of the update's store: RoundCvt, the hardware
// conversion __float2bfloat16_rn (K1-K4; the analogue of the TPU's astype),
// or RoundIntRne, the integer round-to-nearest-even on the f32 bits
// ((bits + 0x7FFF + lsb) >> 16, the TPU kernel's _round_to_storage,
// ops/panel_pallas.py:73-90). On the card an arithmetic NaN is 0x7FFFFFFF,
// which the bias add would carry into -0, so RoundIntRne converts NaN by
// the hardware conversion: the sentinel stays NaN, with K1's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kColThreadsX = 32;  // threads across a strip's columns
constexpr int kColThreadsY = 8;   // threads down a strip's rows
constexpr int kColsPerThread = 4;
constexpr int kRowBatch = 4;      // rows loaded per thread before any store
constexpr int kStripCols = kColThreadsX * kColsPerThread;  // 128
constexpr int kRowWarps = 8;      // rows (one warp each) per u-sweep block
constexpr int kRowLoads = 8;      // loads in flight per lane in the u-sweep
constexpr int kReduceThreads = 256;

// Mask storage: NanMask = no mask array (the residual's NaN sentinel marks
// unobserved cells); __nv_bfloat16 or int8_t = an explicit {0,1} array.
struct NanMask {};

template <typename MaskT>
constexpr bool kExplicit = !std::is_same<MaskT, NanMask>::value;

__device__ __forceinline__ float load_mask(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float load_mask(const int8_t* p) {
  return static_cast<float>(*p);
}

__device__ __forceinline__ float load_cell(const float* p) { return *p; }

__device__ __forceinline__ float load_cell(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Rounding policies of the update's store (see the header).
struct RoundCvt {};
struct RoundIntRne {};

// Round once to the storage type, store, and return exactly what was stored.
template <typename Round>
__device__ __forceinline__ float store_cell(float* p, float x) {
  *p = x;
  return x;
}

template <typename Round>
__device__ __forceinline__ float store_cell(__nv_bfloat16* p, float x) {
  __nv_bfloat16 b = __float2bfloat16_rn(x);
  if constexpr (std::is_same<Round, RoundIntRne>::value) {
    const unsigned bits = __float_as_uint(x);
    if (!isnan(x))
      b = __ushort_as_bfloat16(static_cast<unsigned short>(
          (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16));
  }
  *p = b;
  return __bfloat162float(b);
}

// Column sweep over one strip: rows [blockIdx.y*rows_per_part, +rows_per_part)
// x columns [blockIdx.x*128, +128). With kUpdate the rank-1 delta is applied
// and stored first, rounded by the policy Round. Writes the strip's
// per-column partials of g and h.
template <typename T, typename MaskT, bool kUpdate, typename Round = RoundCvt>
__global__ void __launch_bounds__(kColThreadsX* kColThreadsY)
    col_sweep_kernel(T* R, const MaskT* __restrict__ Mk,
                     const float* __restrict__ uo,
                     const float* __restrict__ up,
                     const float* __restrict__ vo,
                     const float* __restrict__ vp, float* __restrict__ gpart,
                     float* __restrict__ hpart, int M, int W,
                     int rows_per_part) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c_base = blockIdx.x * kStripCols + tx;
  const int r0 = blockIdx.y * rows_per_part;
  const int r1 = min(M, r0 + rows_per_part);

  float vo_c[kColsPerThread], vp_c[kColsPerThread];
  float g[kColsPerThread], h[kColsPerThread];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int c = c_base + q * kColThreadsX;
    vo_c[q] = (kUpdate && c < W) ? vo[c] : 0.f;
    vp_c[q] = (kUpdate && c < W) ? vp[c] : 0.f;
    g[q] = 0.f;
    h[q] = 0.f;
  }

  // Rows go in batches of kRowBatch per thread and all of a batch's loads
  // (residual and mask cells) are issued before its stores: the compiler
  // cannot prove that a store to one row misses the next row's cells, so
  // row-at-a-time code would wait out each load's latency behind the
  // previous row's stores. Here kRowBatch * kColsPerThread residual loads
  // (and as many mask loads) are in flight per thread.
  for (int rb = r0 + ty; rb < r1; rb += kColThreadsY * kRowBatch) {
    float x[kRowBatch][kColsPerThread];
    float mk[kRowBatch][kColsPerThread];
    float a[kRowBatch], ap[kRowBatch];
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int r = rb + b * kColThreadsY;
      const bool row_ok = r < r1;
      a[b] = row_ok ? uo[r] : 0.f;
      ap[b] = (kUpdate && row_ok) ? up[r] : 0.f;
      const size_t roff = static_cast<size_t>(row_ok ? r : r0) * W;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int c = c_base + q * kColThreadsX;
        const bool ok = row_ok && c < W;
        x[b][q] = ok ? load_cell(R + roff + c) : 0.f;
        if constexpr (kExplicit<MaskT>)
          mk[b][q] = ok ? load_mask(Mk + roff + c) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int r = rb + b * kColThreadsY;
      if (r >= r1) break;
      T* row = R + static_cast<size_t>(r) * static_cast<size_t>(W);
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int c = c_base + q * kColThreadsX;
        if (c >= W) continue;
        float xv = x[b][q];
        if constexpr (kExplicit<MaskT>) {
          if (kUpdate) {  // K4: the sweep reads the sum before rounding
            const float d = __fsub_rn(__fmul_rn(a[b], vo_c[q]),
                                      __fmul_rn(ap[b], vp_c[q]));
            xv = __fadd_rn(xv, __fmul_rn(d, mk[b][q]));
            store_cell<Round>(row + c, xv);
          }
          g[q] += a[b] * xv;
          h[q] += __fmul_rn(a[b], a[b]) * mk[b][q];
        } else {
          if (kUpdate) {  // K1: the sweep reads the stored value
            const float d = __fsub_rn(__fmul_rn(a[b], vo_c[q]),
                                      __fmul_rn(ap[b], vp_c[q]));
            xv = store_cell<Round>(row + c, __fadd_rn(xv, d));
          }
          if (!isnan(xv)) {
            g[q] += a[b] * xv;
            h[q] += a[b] * a[b];
          }
        }
      }
    }
  }

  __shared__ float sg[kColThreadsY][kStripCols];
  __shared__ float sh[kColThreadsY][kStripCols];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    sg[ty][tx + q * kColThreadsX] = g[q];
    sh[ty][tx + q * kColThreadsX] = h[q];
  }
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int c = c_base + q * kColThreadsX;
      if (c < W) {
        float gs = 0.f, hs = 0.f;
#pragma unroll
        for (int y = 0; y < kColThreadsY; ++y) {
          gs += sg[y][tx + q * kColThreadsX];
          hs += sh[y][tx + q * kColThreadsX];
        }
        const size_t o = static_cast<size_t>(blockIdx.y) * W + c;
        gpart[o] = gs;
        hpart[o] = hs;
      }
    }
  }
}

// Second pass of the column sums: strip partials added in strip order.
__global__ void __launch_bounds__(kReduceThreads)
    col_reduce_kernel(const float* __restrict__ gpart,
                      const float* __restrict__ hpart, float* __restrict__ g,
                      float* __restrict__ h, int nparts, int W) {
  const int c = blockIdx.x * kReduceThreads + threadIdx.x;
  if (c >= W) return;
  float gs = 0.f, hs = 0.f;
  for (int p = 0; p < nparts; ++p) {
    const size_t o = static_cast<size_t>(p) * W + c;
    gs += gpart[o];
    hs += hpart[o];
  }
  g[c] = gs;
  h[c] = hs;
}

// Row sweep: one warp per row walks all W columns (kRowLoads loads in
// flight per lane, 4 accumulators), then a fixed butterfly reduces the warp.
template <typename T, typename MaskT>
__global__ void __launch_bounds__(kRowWarps * 32)
    row_sweep_kernel(const T* __restrict__ R, const MaskT* __restrict__ Mk,
                     const float* __restrict__ v, float* __restrict__ g,
                     float* __restrict__ h, int M, int W) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= M) return;  // whole warp leaves together
  const size_t roff = static_cast<size_t>(r) * static_cast<size_t>(W);
  const T* row = R + roff;
  float gs[4] = {0.f, 0.f, 0.f, 0.f};
  float hs[4] = {0.f, 0.f, 0.f, 0.f};
  int c = lane;
  for (; c + 32 * (kRowLoads - 1) < W; c += 32 * kRowLoads) {
    float x[kRowLoads], mk[kRowLoads];  // all loads first: in flight per lane
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      x[q] = load_cell(row + c + 32 * q);
      if constexpr (kExplicit<MaskT>) mk[q] = load_mask(Mk + roff + c + 32 * q);
    }
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const float vc = v[c + 32 * q];
      if constexpr (kExplicit<MaskT>) {
        gs[q & 3] += x[q] * vc;
        hs[q & 3] += __fmul_rn(vc, vc) * mk[q];
      } else if (!isnan(x[q])) {
        gs[q & 3] += x[q] * vc;
        hs[q & 3] += vc * vc;
      }
    }
  }
  for (; c < W; c += 32) {
    const float x = load_cell(row + c);
    const float vc = v[c];
    if constexpr (kExplicit<MaskT>) {
      gs[0] += x * vc;
      hs[0] += __fmul_rn(vc, vc) * load_mask(Mk + roff + c);
    } else if (!isnan(x)) {
      gs[0] += x * vc;
      hs[0] += vc * vc;
    }
  }
  float gt = (gs[0] + gs[1]) + (gs[2] + gs[3]);
  float ht = (hs[0] + hs[1]) + (hs[2] + hs[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    gt += __shfl_xor_sync(0xffffffffu, gt, off);
    ht += __shfl_xor_sync(0xffffffffu, ht, off);
  }
  if (lane == 0) {
    g[r] = gt;
    h[r] = ht;
  }
}

template <typename T, typename MaskT, bool kUpdate, typename Round = RoundCvt>
void launch_col_sweep(void* R, const void* Mk, const void* uo, const void* up,
                      const void* vo, const void* vp, void* gpart,
                      void* hpart, void* g, void* h, int M, int W,
                      int rows_per_part, cudaStream_t stream) {
  const int nparts = (M + rows_per_part - 1) / rows_per_part;
  const dim3 grid((W + kStripCols - 1) / kStripCols, nparts);
  const dim3 block(kColThreadsX, kColThreadsY);
  col_sweep_kernel<T, MaskT, kUpdate, Round><<<grid, block, 0, stream>>>(
      static_cast<T*>(R), static_cast<const MaskT*>(Mk),
      static_cast<const float*>(uo), static_cast<const float*>(up),
      static_cast<const float*>(vo), static_cast<const float*>(vp),
      static_cast<float*>(gpart), static_cast<float*>(hpart), M, W,
      rows_per_part);
  col_reduce_kernel<<<(W + kReduceThreads - 1) / kReduceThreads,
                      kReduceThreads, 0, stream>>>(
      static_cast<const float*>(gpart), static_cast<const float*>(hpart),
      static_cast<float*>(g), static_cast<float*>(h), nparts, W);
}

template <typename T, typename MaskT>
void launch_row_sweep(const void* R, const void* Mk, const void* v, void* g,
                      void* h, int M, int W, cudaStream_t stream) {
  row_sweep_kernel<T, MaskT>
      <<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, stream>>>(
          static_cast<const T*>(R), static_cast<const MaskT*>(Mk),
          static_cast<const float*>(v), static_cast<float*>(g),
          static_cast<float*>(h), M, W);
}

// residual dtype codes shared with ops/panel_kernels.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
// mask codes shared with ops/panel_kernels.py: none (the NaN sentinel; the
// mask pointer must be null), or an explicit bfloat16 / int8 array
constexpr int kMaskNone = 0;
constexpr int kMaskBFloat16 = 1;
constexpr int kMaskInt8 = 2;

bool bad_args(int dtype, int M, int W) {
  return (dtype != kFloat32 && dtype != kBFloat16) || M <= 0 || W <= 0;
}

template <typename MaskT>
struct MaskTag {
  using type = MaskT;
};

// Calls f(MaskTag<MaskT>{}) for the mask code; false (nothing called) for an
// unknown code or a mask pointer that does not fit it.
template <typename F>
bool with_mask(const void* Mk, int mask_dtype, F&& f) {
  if (mask_dtype == kMaskNone && Mk == nullptr)
    f(MaskTag<NanMask>{});
  else if (mask_dtype == kMaskBFloat16 && Mk != nullptr)
    f(MaskTag<__nv_bfloat16>{});
  else if (mask_dtype == kMaskInt8 && Mk != nullptr)
    f(MaskTag<int8_t>{});
  else
    return false;
  return true;
}

// Column sweep (update or not) for a residual dtype code and mask type.
template <typename MaskT, bool kUpdate>
void col_sweep(int dtype, void* R, const void* Mk, const void* uo,
               const void* up, const void* vo, const void* vp, void* gpart,
               void* hpart, void* g, void* h, int M, int W, int rows_per_part,
               cudaStream_t s) {
  if (dtype == kFloat32)
    launch_col_sweep<float, MaskT, kUpdate>(R, Mk, uo, up, vo, vp, gpart,
                                            hpart, g, h, M, W, rows_per_part,
                                            s);
  else
    launch_col_sweep<__nv_bfloat16, MaskT, kUpdate>(R, Mk, uo, up, vo, vp,
                                                    gpart, hpart, g, h, M, W,
                                                    rows_per_part, s);
}

template <typename MaskT>
void row_sweep(int dtype, const void* R, const void* Mk, const void* v,
               void* g, void* h, int M, int W, cudaStream_t s) {
  if (dtype == kFloat32)
    launch_row_sweep<float, MaskT>(R, Mk, v, g, h, M, W, s);
  else
    launch_row_sweep<__nv_bfloat16, MaskT>(R, Mk, v, g, h, M, W, s);
}

}  // namespace

// Each entry point launches on ``stream`` and returns cudaGetLastError():
// a refused launch (bad configuration) never runs and is reported only here.
// ``Mk`` and ``mask_dtype`` select the mask: (null, kMaskNone) for a
// NaN-sentinel residual (K1-K3), else an explicit mask (K4 and the masked
// sweeps).
extern "C" {

int crtpu_update_vsweep(void* R, int dtype, const void* Mk, int mask_dtype,
                        const void* uo, const void* up, const void* vo,
                        const void* vp, void* gpart, void* hpart, void* g,
                        void* h, int M, int W, int rows_per_part,
                        void* stream) {
  if (bad_args(dtype, M, W) || rows_per_part <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_mask(Mk, mask_dtype, [&](auto tag) {
    col_sweep<typename decltype(tag)::type, true>(dtype, R, Mk, uo, up, vo, vp,
                                                  gpart, hpart, g, h, M, W,
                                                  rows_per_part, s);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : cudaErrorInvalidValue;
}

int crtpu_vsweep(const void* R, int dtype, const void* Mk, int mask_dtype,
                 const void* u, void* gpart, void* hpart, void* g, void* h,
                 int M, int W, int rows_per_part, void* stream) {
  if (bad_args(dtype, M, W) || rows_per_part <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* Rw = const_cast<void*>(R);  // the read-only instantiation never stores
  const bool ok = with_mask(Mk, mask_dtype, [&](auto tag) {
    col_sweep<typename decltype(tag)::type, false>(
        dtype, Rw, Mk, u, nullptr, nullptr, nullptr, gpart, hpart, g, h, M, W,
        rows_per_part, s);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : cudaErrorInvalidValue;
}

// K1 at a bfloat16 residual with the NaN sentinel, its store rounded by
// RoundIntRne (the P2 rounding probe); otherwise crtpu_update_vsweep's
// arguments.
int crtpu_update_vsweep_irne(void* R, const void* uo, const void* up,
                             const void* vo, const void* vp, void* gpart,
                             void* hpart, void* g, void* h, int M, int W,
                             int rows_per_part, void* stream) {
  if (bad_args(kBFloat16, M, W) || rows_per_part <= 0)
    return cudaErrorInvalidValue;
  launch_col_sweep<__nv_bfloat16, NanMask, true, RoundIntRne>(
      R, nullptr, uo, up, vo, vp, gpart, hpart, g, h, M, W, rows_per_part,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int crtpu_usweep(const void* R, int dtype, const void* Mk, int mask_dtype,
                 const void* v, void* g, void* h, int M, int W, void* stream) {
  if (bad_args(dtype, M, W)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = with_mask(Mk, mask_dtype, [&](auto tag) {
    row_sweep<typename decltype(tag)::type>(dtype, R, Mk, v, g, h, M, W, s);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : cudaErrorInvalidValue;
}

}  // extern "C"
