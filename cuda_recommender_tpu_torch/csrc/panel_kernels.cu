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
// A residual is an (M, W) row-major block, float32, bfloat16 or float8
// e4m3fn (Fp8 below: bias 7, no infinities, NaN = S.1111.111). Its mask is
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
// and 2 bytes read (+2 written by an update) at bf16, 4 (+4) at f32, 1 (+1)
// at fp8, plus 2 (bf16) or 1 (int8) mask byte(s) read in explicit-mask
// mode; a 6.5e9-cell bf16 stair is 13 GB per pass. The design streams every
// cell once, keeps the factor vectors in registers, and in NaN mode takes
// the mask from the sentinel in-register, so no mask array exists.
//
// The column sweeps (K1, K3, K4, masked_vsweep) move their cells in 16-byte
// vectors: a block of 32 x 8 threads owns a strip of 256 columns of some
// rows, each warp one row at a time, each lane 8 consecutive columns of it
// (16 bytes at bf16, 32 at f32, 8 at fp8, moved in 8-byte vectors; the
// mask's 16 or 8), several rows loaded before any store (64 residual bytes
// a lane; 32 at fp8 beside a bf16 mask). Rows need not start on a 16-byte
// boundary (W * size is 4 mod 16 at Netflix's 17,770 bf16 columns; an odd
// W shifts every row; a view may start anywhere), but rows that lie a
// multiple of 64 rows apart (128 at fp8) start equally far into their
// 128-byte lines. So a block takes every 64th (128th) row of a band (rows
// q, q + 64, ...), and shifts its strip left by that many cells onto the
// rows' 128-byte grid:
// each warp's row segment then covers whole lines, and each lane's run is
// one or two aligned vectors, loaded and stored whole, with no shuffle and
// no realignment (K1 ran a fifth slower with segments on a 16- or 32-byte
// grid that straddle lines shared with the next strip). Strips meet on line
// boundaries;
// only the vector at a row's start and the one at its end hold cells of
// another row (or lie at the tensor's edge), so they are loaded whole (a
// vector that holds a byte of the tensor lies inside its allocation) and
// stored cell by cell, only the row's own cells. Every cell is written by
// exactly one lane, and no byte outside the tensor's cells is written. The
// mask starts at another offset than the residual (its cells are 1 or 2
// bytes): a lane loads the aligned mask vector that holds its first cell,
// takes the next from its right-hand neighbour by a shuffle (lane 31 loads
// its own) and shifts its cells into place.
//
// The Pallas kernels accumulate g/h across a sequential grid; GPU blocks run
// in parallel, so the column sums are reduced deterministically in two
// passes: each block writes its rows' per-column partials (each lane sums
// its rows in order, then the 8 warps' sums are added in order; the strip's
// shift moves a column to another block, not its order), then one thread
// per column adds the partials in order. No float atomics: runs repeat bit
// for bit.
//
// The u-sweeps (row_sweep_kernel, one template over the residual and the
// mask) split each row across the card, in the same 8-cell runs a lane as
// the column sweeps. A row's runs start where its first cell lies in its
// first unit (16 bytes; 8 at 1 byte a cell): run k holds the columns
// [8k - s, 8k - s + 8), s the row's shift (its first cell's place in that
// unit, 0-7 cells). Rows a multiple of ``inter`` = unit / gcd(unit, W *
// size) apart share their shift, so a block takes rows of one such class,
// and its runs cover the same columns on every row it reads. A warp's
// item is a chunk of a row, 128 runs (4 a lane: 1024 cells); 8 chunks are
// a span (8192 cells). A row of at most 3 spans is one segment (the
// headline's 17,770 columns, the dense path's 10,677 and 4,096); a wider
// row is cut into segments of one span (Yahoo's 1.9M-column panel into
// 238). A block takes 32 rows, so that every panel, a short, wide one
// too, gives the card many small blocks and its last wave stays short.
// The segments depend on W, the cell size and the shift alone, so a row's
// sums depend on its own cells, v and its alignment, never on how many
// rows share its panel. A block (segment, row group) stages each span's v
// in shared memory once, shifted to its class (an (M, W) panel's v is
// read once a block, not once a cell), then deals the span's live chunks
// x its rows to its 8 warps in turn, so that every warp has work whatever
// the width. An item's warp sums its lanes by a fixed butterfly, the block
// adds a row's chunks in chunk order and its spans in span order. A row
// of one segment is written straight to g, h; otherwise each block writes
// its rows' segment sums to (segments, M) partials, and the last block of
// a row group to finish (an int counter a group, __threadfence, no float
// atomics; the counter resets itself) adds them in segment order. Only a
// row's first and last run hold cells of another row (or bytes past the
// tensor's ends). v is 0 there, so a finite one adds +-0 and leaves the
// sums' bits alone; but such a cell need not be finite (a NaN or inf
// times 0 is NaN). So an item that holds either run and whose sums come
// out NaN is summed again, by a slow path that zeroes the cells outside
// the row first: a row's sums depend on its own cells alone, and the
// common case pays one test an item. (An fp8 residual with the NaN
// sentinel needs no second pass: every byte is a finite e4m3fn value or
// NaN, and a NaN is skipped.) An unobserved cell adds +0.0 to g and 0 to
// h by a select, not a branch (at fp8, bound by its instructions, it is
// skipped by a predicated FMA and add instead: the same bits in fewer
// instructions).
// No TMA and no tensor cores: a product-free stream needs neither.
//
// Rounding: the delta is formed as fl(fl(uo*vo) - fl(up*vp)) (times the mask
// in explicit mode) and added with explicit _rn intrinsics, so nvcc's FMA
// contraction cannot change the stored bits; the sum is rounded once to the
// storage type (round-to-nearest-even). NaN passes through the add. The
// stored residual is therefore bit-equal to the plain PyTorch versions
// (ops/panel_kernels.py, ops/ccd_kernels.py) on the same card.
//
// The order of the update's roundings is a policy too (fp8 only; f32 and
// bf16 store once): StoreOnce is the Pallas kernels' order above, the sum
// rounded once (K1 sweeps the stored value, K4 the unrounded sum);
// StoreDeltaFirst is the order XLA computes ``Rd + (delta·mask).astype(
// dtype)`` in (the JAX dense step, the hybrid's einsum panels and its
// sharded step): R' = round(R + round(delta·mask)), and every sweep, K4's
// too, reads the stored value. At fp8 the two differ in about a quarter of
// the observed cells.
//
// An fp8 store rounds to nearest even WITHOUT saturating, as JAX's astype
// does: |x| > 464 (the midpoint above the largest finite value, 448), an
// infinity or a NaN stores NaN with x's sign. The hardware conversion
// (cvt.rn.satfinite.e4m3x2.f32) exists only as satfinite, so fp8_encode8
// fixes those inputs up after it.
//
// The fp8 update is bound by its instructions, not by memory: a cell moves
// one byte, and each rounding is a conversion. So the fp8 update works on a
// lane's 8 cells a pair at a time (fp8_update): one
// cvt.rn.satfinite.e4m3x2.f32 rounds two cells straight into the stored
// bytes, one cvt.rn.f16x2.e4m3x2 (then two f16 -> f32 moves) gives both
// stored values back, and the > 464 fix-up is a compare and a predicated
// OR a cell, with no branch (a branch a row cut the rows' code into blocks
// the compiler could not interleave). A delta-first store rounds
// delta·mask so, then adds it to R in f16x2 and rounds the pair from f16x2
// (fp8x2_add): the f32 round trip in between falls away. An int8 mask cell
// becomes a float by an integer multiply (a {0,1} byte times the bits of
// 1.0f), not by I2F. The fp8 sweep (fp8_sweep) adds an observed cell by a
// predicated FMA and sums the columns outside the row too (the reduction
// never writes them), where the f32 and bf16 sweeps select each cell and
// test it against the row's bounds. The stored bits and the sums are the
// same.
//
// The rounding is a policy of the update's store: RoundCvt, the hardware
// conversion __float2bfloat16_rn (K1-K4; the analogue of the TPU's astype),
// or RoundIntRne, the integer round-to-nearest-even on the f32 bits
// ((bits + 0x7FFF + lsb) >> 16, the TPU kernel's _round_to_storage,
// ops/panel_pallas.py:73-90). On the card an arithmetic NaN is 0x7FFFFFFF,
// which the bias add would carry into -0, so RoundIntRne converts NaN by
// the hardware conversion: the sentinel stays NaN, with K1's bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kColThreadsX = 32;  // lanes across a strip's columns
constexpr int kColThreadsY = 8;   // warps down a strip's rows
constexpr int kColsPerThread = 8; // consecutive columns a lane owns
constexpr int kStripCols = kColThreadsX * kColsPerThread;  // 256
constexpr int kBatchBytes = 64;   // residual bytes a lane loads before a store
constexpr int kLine = 128;        // bytes: strips start on this grid
// rows a multiple of kInterleave<T> apart start equally far into their
// 128-byte lines (kInterleave * W * sizeof(T) is a multiple of kLine for
// every W): 64 at 2 and 4 bytes a cell, 128 at 1
template <typename T>
constexpr int kInterleave = sizeof(T) == 1 ? 128 : 64;
// cells a strip shifts by at most: kLine / sizeof(T) - 1 at 1 byte; 63 at
// 2 and 4 (at 4 bytes one strip more than needed, which covers no cell)
template <typename T>
constexpr int kMaxShift = sizeof(T) == 1 ? kLine - 1 : kLine / 2 - 1;
constexpr int kRowWarps = 8;      // warps a row-sweep block
constexpr int kRowRuns = 4;       // runs (8 cells each) a lane holds of a row
constexpr int kChunkRuns = 32 * kRowRuns;  // a warp's runs of a row: a chunk
constexpr int kSpanChunks = 8;    // chunks a span
constexpr int kSpanRuns = kSpanChunks * kChunkRuns;  // 1024 runs, 8192 cells
constexpr int kRowBlockRows = 32; // rows a row-sweep block
constexpr int kRowSegmentSpans = 3;  // spans a row of one segment, at most
// residual bytes a lane loads of a batch of items: 128 (f32 1 item, bf16
// 2, fp8 4; beside an explicit mask 1)
constexpr int kRowBatchBytes = 128;
constexpr int kReduceThreads = 256;

// Mask storage: NanMask = no mask array (the residual's NaN sentinel marks
// unobserved cells); __nv_bfloat16 or int8_t = an explicit {0,1} array.
struct NanMask {};

// A 1-byte float8 e4m3fn residual cell (its bits).
struct Fp8 {
  uint8_t bits;
};

template <typename MaskT>
constexpr bool kExplicit = !std::is_same<MaskT, NanMask>::value;

// Two fp8 e4m3fn cells (the low 16 bits of v, the first in the low byte)
// -> their f16x2, exact (e4m3 fits f16); 0x7F / 0xFF give NaN.
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t v) {
  const unsigned short pair = static_cast<unsigned short>(v);
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(pair));
  return h2;
}

// Two fp8 e4m3fn cells (as fp8x2_to_f16x2) -> floats, exact: the hardware
// conversion to f16x2, then to f32.
__device__ __forceinline__ float2 fp8x2_decode(uint32_t v) {
  const uint32_t h2 = fp8x2_to_f16x2(v);
  float lo, hi;
  asm("{\n\t.reg .b16 l, h;\n\tmov.b32 {l, h}, %2;\n\t"
      "cvt.f32.f16 %0, l;\n\tcvt.f32.f16 %1, h;\n\t}"
      : "=f"(lo), "=f"(hi)
      : "r"(h2));
  return make_float2(lo, hi);
}

// A lane's 8 fp8 cells (packed as in memory: cell e in byte e % 4 of word
// e / 4) -> floats, exact, a pair per conversion.
__device__ __forceinline__ void fp8_decode8(const uint32_t (&w)[2],
                                            float (&x)[kColsPerThread]) {
#pragma unroll
  for (int p = 0; p < kColsPerThread / 2; ++p) {
    const float2 v = fp8x2_decode(w[p / 2] >> (16 * (p & 1)));
    x[2 * p] = v.x;
    x[2 * p + 1] = v.y;
  }
}

// |x| > 464 (the midpoint above 448), an infinity or a NaN: where JAX's
// astype stores NaN and the hardware conversion saturates.
__device__ __forceinline__ bool fp8_over(float x) {
  return !(fabsf(x) <= 464.f);
}

// A lane's 8 floats -> their fp8 e4m3fn bits, packed as in memory, rounded
// to nearest even WITHOUT saturating: the hardware conversion a pair at a
// time (satfinite, lo in the low byte), then one more bit in the byte of a
// value past 464. The conversion gives such a value ±448 (0x7E with its
// sign), which the bit turns into NaN with its sign (0x7F, 0xFF), and a
// NaN NaN; every NaN that reaches a store here is an arithmetic result,
// the card's positive 0x7FFFFFFF, stored 0x7F as JAX's astype stores it.
__device__ __forceinline__ void fp8_encode8(const float (&x)[kColsPerThread],
                                            uint32_t (&w)[2]) {
#pragma unroll
  for (int p = 0; p < kColsPerThread / 2; ++p) {
    unsigned short pair;
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;"
        : "=h"(pair)
        : "f"(x[2 * p + 1]), "f"(x[2 * p]));
    const uint32_t bits = pair;
    w[p / 2] = (p & 1) ? w[p / 2] | (bits << 16) : bits;
  }
#pragma unroll
  for (int e = 0; e < kColsPerThread; ++e)
    if (fp8_over(x[e])) w[e / 4] |= 1u << (8 * (e & 3));
}

// Rounding policies of the update's store (see the header).
struct RoundCvt {};
struct RoundIntRne {};
// Store orders of the update (see the header).
struct StoreOnce {};
struct StoreDeltaFirst {};

// Round once to the storage type: returns the stored bits (in the low bits)
// and sets ``back`` to exactly the value stored.
template <typename Round>
__device__ __forceinline__ uint32_t round_bits(float x, float& back,
                                               float*) {
  back = x;
  return __float_as_uint(x);
}

template <typename Round>
__device__ __forceinline__ uint32_t round_bits(float x, float& back,
                                               __nv_bfloat16*) {
  __nv_bfloat16 b = __float2bfloat16_rn(x);
  if constexpr (std::is_same<Round, RoundIntRne>::value) {
    const unsigned bits = __float_as_uint(x);
    if (!isnan(x))
      b = __ushort_as_bfloat16(static_cast<unsigned short>(
          (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16));
  }
  back = __bfloat162float(b);
  return __bfloat16_as_ushort(b);
}

// A lane's run of kColsPerThread cells of type E (kBytes bytes), moved as
// aligned units of kUnit bytes: 16, or 8 for a 1-byte cell (an int8 mask,
// an fp8 residual), whose run is 8.
template <typename E>
struct Run {
  static constexpr int kSize = static_cast<int>(sizeof(E));
  static constexpr int kBytes = kColsPerThread * kSize;  // 8, 16 or 32
  static constexpr int kUnit = kBytes < 16 ? kBytes : 16;
  static constexpr int kUnits = kBytes / kUnit;           // 1 or 2 a lane
  static constexpr int kWords = kBytes / 4;
  static constexpr int kUnitWords = kUnit / 4;
  static constexpr int kUnitCells = kUnit / kSize;
};

// A lane's loaded mask units of one row: its own kUnits, then the next one
// (its right-hand neighbour's first, or for lane 31 its own load), and the
// byte offset of its first cell in the first unit (the same in every lane
// of the warp: a lane's run starts kBytes after its left-hand neighbour's).
template <typename E>
struct Loaded {
  uint32_t w[Run<E>::kWords + Run<E>::kUnitWords];
  int off;
};

template <int kUnit>
__device__ __forceinline__ void load_unit(uintptr_t at, uintptr_t start,
                                          uintptr_t end, uint32_t* w) {
  if (at >= end || at + kUnit <= start) {  // no cell of the row: not used
#pragma unroll
    for (int i = 0; i < kUnit / 4; ++i) w[i] = 0u;
  } else if constexpr (kUnit == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(at);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(at);
    w[0] = v.x;
    w[1] = v.y;
  }
}

// out = the kOut words that start ``off`` bytes (0 <= off < 16) into w; w
// is clobbered. Selects and funnel shifts, no dynamic register indexing.
template <int kIn, int kOut>
__device__ __forceinline__ void realign(uint32_t (&w)[kIn], int off,
                                        uint32_t (&out)[kOut]) {
  static_assert(kOut < kIn, "realign needs a word past the output");
  if (off & 8) {
#pragma unroll
    for (int i = 0; i + 2 < kIn; ++i) w[i] = w[i + 2];
  }
  if (off & 4) {
#pragma unroll
    for (int i = 0; i + 1 < kIn; ++i) w[i] = w[i + 1];
  }
  const unsigned sh = 8u * static_cast<unsigned>(off & 3);
#pragma unroll
  for (int j = 0; j < kOut; ++j) out[j] = __funnelshift_r(w[j], w[j + 1], sh);
}

// The lane's kColsPerThread cells, as floats, from its words (packed as in
// memory). kMask01: an int8 cell is a {0,1} mask, taken without I2F (a byte
// b of 0 or 1 times 1.0f's bits is b's float bits).
template <typename E, bool kMask01 = false>
__device__ __forceinline__ void cells(const uint32_t (&c)[Run<E>::kWords],
                                      float (&x)[kColsPerThread]) {
  if constexpr (std::is_same<E, Fp8>::value) {
    fp8_decode8(c, x);
  } else {
#pragma unroll
    for (int e = 0; e < kColsPerThread; ++e) {
      if constexpr (sizeof(E) == 4) {
        x[e] = __uint_as_float(c[e]);
      } else if constexpr (sizeof(E) == 2) {
        const uint32_t v = c[e / 2];
        x[e] = __uint_as_float((e & 1) ? (v & 0xFFFF0000u) : (v << 16));
      } else if constexpr (kMask01) {
        x[e] = __uint_as_float(
            __byte_perm(c[e / 4], 0u, 0x4440u + (e & 3)) * 0x3F800000u);
      } else {
        x[e] = static_cast<float>(
            static_cast<int8_t>((c[e / 4] >> (8 * (e & 3))) & 0xFFu));
      }
    }
  }
}

// R + round(delta) of two cells, both e4m3 (the low 16 bits of r and of
// d), rounded to e4m3 as fp8_encode8 rounds: their sum in f16x2, then the
// hardware conversion from f16x2 (satfinite) and the bit past 464. Both
// addends are exact in f16, and f16 rounds their sum to 11 bits before
// the conversion rounds it to 4: a double rounding, innocuous for a sum
// of two 4-bit floats at 11 >= 2·4 + 1 bits, so the bits are those of the
// exact sum rounded once (the f32 sum of the plain version). One
// conversion in, one add and one out for the pair, no f32 in between.
__device__ __forceinline__ uint32_t fp8x2_add(uint32_t r, uint32_t d) {
  const uint32_t a = fp8x2_to_f16x2(r), b = fp8x2_to_f16x2(d);
  __half2 ha, hb;
  memcpy(&ha, &a, 4);
  memcpy(&hb, &b, 4);
  const __half2 s = __hadd2(ha, hb);
  uint32_t sb;
  memcpy(&sb, &s, 4);
  unsigned short pair;
  asm("cvt.rn.satfinite.e4m3x2.f16x2 %0, %1;" : "=h"(pair) : "r"(sb));
  // 0xFFFF in each half past 464 (or NaN): its byte's lowest bit
  const uint32_t over =
      __hgtu2_mask(__habs2(s), __float2half2_rn(464.f));
  return static_cast<uint32_t>(pair) | (__byte_perm(over, 0u, 0x4420u) &
                                        0x0101u);
}

// The fp8 update of a lane's 8 cells of one row, a pair at a time (see the
// header): x holds the cells decoded (xw as loaded) and becomes what the
// sweep reads, own the stored bits. The delta is fl(fl(a vo) - fl(ap vp)),
// times the mask mk where kMasked; then, by the store order, round(x +
// delta) (K1 sweeps the stored value, K4 the sum before rounding) or
// round(x + round(delta)) (the sweep reads the stored value).
template <bool kMasked, bool kDeltaFirst>
__device__ __forceinline__ void fp8_update(
    float (&x)[kColsPerThread], const uint32_t (&xw)[2],
    const float (&mk)[kColsPerThread], float a, float ap,
    const float (&vo)[kColsPerThread], const float (&vp)[kColsPerThread],
    uint32_t (&own)[2]) {
  float d[kColsPerThread];
#pragma unroll
  for (int e = 0; e < kColsPerThread; ++e) {
    d[e] = __fsub_rn(__fmul_rn(a, vo[e]), __fmul_rn(ap, vp[e]));
    if constexpr (kMasked) d[e] = __fmul_rn(d[e], mk[e]);
  }
  if constexpr (kDeltaFirst) {
    uint32_t dw[2];
    fp8_encode8(d, dw);
#pragma unroll
    for (int p = 0; p < kColsPerThread / 2; ++p) {
      const int sh = 16 * (p & 1);
      const uint32_t pair = fp8x2_add(xw[p / 2] >> sh, dw[p / 2] >> sh);
      own[p / 2] = (p & 1) ? own[p / 2] | (pair << 16) : pair;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kColsPerThread; ++e) x[e] = __fadd_rn(x[e], d[e]);
    fp8_encode8(x, own);
  }
  if constexpr (kDeltaFirst || !kMasked) fp8_decode8(own, x);
}

// The fp8 sweep of a lane's 8 cells x (and mask mk where kMasked) of one
// row with factor a into the column sums g, h: the same sums as the f32
// and bf16 sweeps, in fewer instructions. A cell outside the row is summed
// too (its column's sums are never written: the reduction writes the
// row's columns only), and an unobserved cell (NaN) is skipped, which
// leaves the sums' bits as adding its ±0 would (a sum that starts at +0
// never becomes -0).
template <bool kMasked>
__device__ __forceinline__ void fp8_sweep(const float (&x)[kColsPerThread],
                                          const float (&mk)[kColsPerThread],
                                          float a,
                                          float (&g)[kColsPerThread],
                                          float (&h)[kColsPerThread]) {
  const float aa = __fmul_rn(a, a);
#pragma unroll
  for (int e = 0; e < kColsPerThread; ++e) {
    if constexpr (kMasked) {
      g[e] += a * x[e];
      h[e] += aa * mk[e];
    } else if (!isnan(x[e])) {
      g[e] = __fmaf_rn(a, x[e], g[e]);
      h[e] = __fadd_rn(h[e], aa);
    }
  }
}

// The mask cells of a lane whose run starts at column c0 of the mask row
// ``row`` (W cells): the lane's aligned unit(s) and, by a shuffle, its
// right-hand neighbour's first (lane 31 loads its own), shifted into place.
// Every lane of the warp must call unpack_mask on what load_mask issued.
template <typename E>
__device__ __forceinline__ void load_mask(const E* row, int W, int c0,
                                          bool last_lane, Loaded<E>& L) {
  using Rn = Run<E>;
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t end = start + static_cast<uintptr_t>(W) * Rn::kSize;
  const uintptr_t a = start + static_cast<uintptr_t>(static_cast<intptr_t>(
                                  c0) * Rn::kSize);
  const uintptr_t al = a & ~static_cast<uintptr_t>(Rn::kUnit - 1);
  L.off = static_cast<int>(a - al);
#pragma unroll
  for (int j = 0; j < Rn::kUnits; ++j)
    load_unit<Rn::kUnit>(al + j * Rn::kUnit, start, end,
                         L.w + j * Rn::kUnitWords);
  if (last_lane)
    load_unit<Rn::kUnit>(al + Rn::kBytes, start, end, L.w + Rn::kWords);
}

template <typename E, bool kMask01 = false>
__device__ __forceinline__ void unpack_mask(Loaded<E>& L, int lane,
                                            float (&x)[kColsPerThread]) {
  using Rn = Run<E>;
#pragma unroll
  for (int i = 0; i < Rn::kUnitWords; ++i) {
    const uint32_t nb = __shfl_down_sync(0xffffffffu, L.w[i], 1);
    if (lane != kColThreadsX - 1) L.w[Rn::kWords + i] = nb;
  }
  uint32_t c[Rn::kWords];
  realign(L.w, L.off, c);
  cells<E, kMask01>(c, x);
}

// A residual run on the 16-byte grid (8-byte at 1 byte a cell): the kUnits
// units at ``at``, which hold columns [c0, c0 + kColsPerThread) of a row of
// W cells. A unit that holds a cell of the row is loaded whole (the units at
// the row's two ends also hold cells of its neighbours, or lie at the
// tensor's edge: inside its allocation all the same).
template <typename T>
__device__ __forceinline__ void load_res(uintptr_t at, int c0, int W,
                                         uint32_t (&w)[Run<T>::kWords]) {
  using Rn = Run<T>;
#pragma unroll
  for (int j = 0; j < Rn::kUnits; ++j) {
    const int first = c0 + j * Rn::kUnitCells;
    uint32_t* u = w + j * Rn::kUnitWords;
    if (first + Rn::kUnitCells > 0 && first < W) {
      if constexpr (Rn::kUnit == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(at + 16 * j);
        u[0] = v.x;
        u[1] = v.y;
        u[2] = v.z;
        u[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(at + 8 * j);
        u[0] = v.x;
        u[1] = v.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < Rn::kUnitWords; ++i) u[i] = 0u;
    }
  }
}

// Stores a residual run (see load_res): a unit whose cells all lie in the
// row [0, W) whole, one at the row's start or end cell by cell, only the
// row's own cells (1-, 2- or 4-byte stores).
template <typename T>
__device__ __forceinline__ void store_res(uintptr_t at, int c0, int W,
                                          const uint32_t (&w)[
                                              Run<T>::kWords]) {
  using Rn = Run<T>;
#pragma unroll
  for (int j = 0; j < Rn::kUnits; ++j) {
    const int first = c0 + j * Rn::kUnitCells;
    const uintptr_t u = at + Rn::kUnit * j;
    const uint32_t* wj = w + j * Rn::kUnitWords;
    if (first >= 0 && first + Rn::kUnitCells <= W) {
      if constexpr (Rn::kUnit == 16)
        *reinterpret_cast<uint4*>(u) = make_uint4(wj[0], wj[1], wj[2], wj[3]);
      else
        *reinterpret_cast<uint2*>(u) = make_uint2(wj[0], wj[1]);
    } else {
#pragma unroll
      for (int k = 0; k < Rn::kUnitCells; ++k) {
        const int c = first + k;
        if (c < 0 || c >= W) continue;
        const uint32_t word = wj[k * Rn::kSize / 4];
        if constexpr (Rn::kSize == 4)
          *reinterpret_cast<uint32_t*>(u + 4 * k) = word;
        else if constexpr (Rn::kSize == 2)
          *reinterpret_cast<unsigned short*>(u + 2 * k) =
              static_cast<unsigned short>(word >> (16 * (k & 1)));
        else
          *reinterpret_cast<uint8_t*>(u + k) =
              static_cast<uint8_t>(word >> (8 * (k & 3)));
      }
    }
  }
}

// Column sweep over one strip of the rows q, q + I, q + 2I, ... of the row
// band [b*I*rows_per_part, (b+1)*I*rows_per_part), where I =
// kInterleave<T> (64, or 128 at 1 byte a cell), b = blockIdx.y / I and q =
// blockIdx.y % I; warp ty takes every eighth of them from q + I ty on. Rows
// a multiple of I apart start equally far into their 128-byte lines (I * W
// cells are a multiple of 128 bytes), so the block shifts its strip by that
// many cells, ``shift``, and covers the columns [blockIdx.x * 256 - shift,
// +256) of each of its rows: every warp's row segment then starts on a line
// (a segment that straddles lines shared with the next strip costs K1 a
// fifth of its rate on the card), every lane's run on a 16-byte (8-byte at
// 1 byte a cell) boundary, and only the units at a row's two ends hold
// cells of another row. With kUpdate the rank-1 delta is applied and
// stored first, rounded by the policy Round in the order Order. Writes the
// block's per-column partials of g and h into row blockIdx.y of the
// partials: each column lies in one strip of a row band's residue, and its
// sum over the block's rows runs in the same order whatever the shift.
template <typename T, typename MaskT, bool kUpdate, typename Round = RoundCvt,
          typename Order = StoreOnce>
__global__ void __launch_bounds__(kColThreadsX* kColThreadsY, 2)
    col_sweep_kernel(T* R, const MaskT* __restrict__ Mk,
                     const float* __restrict__ uo,
                     const float* __restrict__ up,
                     const float* __restrict__ vo,
                     const float* __restrict__ vp, float* __restrict__ gpart,
                     float* __restrict__ hpart, int M, int W,
                     int rows_per_part) {
  // the mask's element type (unused in NaN mode)
  using MaskE = std::conditional_t<kExplicit<MaskT>, MaskT, int8_t>;
  // rows a warp loads before it stores: f32 2, bf16 4, fp8 8 (4 beside a
  // bf16 mask, whose 16-byte units would take twice the registers)
  constexpr int kRows =
      (sizeof(T) == 1 && kExplicit<MaskT> && sizeof(MaskE) == 2)
          ? 4
          : kBatchBytes / Run<T>::kBytes;
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int kInter = kInterleave<T>;
  constexpr int kWarpRowStep = kInter * kColThreadsY;
  constexpr bool kDeltaFirst = std::is_same<Order, StoreDeltaFirst>::value;
  constexpr bool kFp8 = std::is_same<T, Fp8>::value;
  static_assert(!kDeltaFirst || kFp8, "delta-first is an fp8 store order");
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int band = kInter * rows_per_part;
  const int r0 = (blockIdx.y / kInter) * band;
  const int r1 = min(M, r0 + band);
  const int q = r0 + blockIdx.y % kInter;  // the block's first row
  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(R) +
       static_cast<size_t>(q) * static_cast<size_t>(W) * kSize) &
      (kLine - 1)) / kSize;
  const int lo = blockIdx.x * kStripCols - shift;
  const int c0 = lo + lane * kColsPerThread;
  const bool last_lane = lane == kColThreadsX - 1;

  float vo_c[kColsPerThread], vp_c[kColsPerThread];
  float g[kColsPerThread], h[kColsPerThread];
  bool ok[kColsPerThread];  // the column lies in the row
#pragma unroll
  for (int e = 0; e < kColsPerThread; ++e) {
    const int c = c0 + e;
    ok[e] = c >= 0 && c < W;
    vo_c[e] = (kUpdate && ok[e]) ? vo[c] : 0.f;
    vp_c[e] = (kUpdate && ok[e]) ? vp[c] : 0.f;
    g[e] = 0.f;
    h[e] = 0.f;
  }

  // The warp's rows go kRows at a time, and all of a batch's loads
  // (residual and mask) go out before its stores: the compiler cannot
  // prove that a store to one row misses the next row's cells, so
  // row-at-a-time code would wait out each load's latency behind the
  // previous row's stores. A row is one warp's, so every branch on the row
  // is uniform across the warp and its shuffles.
  for (int rb = q + kInter * ty; rb < r1; rb += kWarpRowStep * kRows) {
    uint32_t xs[kRows][Run<T>::kWords];
    Loaded<MaskE> ms[kRows];
    float a[kRows], ap[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const int r = rb + b * kWarpRowStep;
      if (r >= r1) break;
      a[b] = uo[r];
      ap[b] = kUpdate ? up[r] : 0.f;
      const size_t roff = static_cast<size_t>(r) * static_cast<size_t>(W);
      load_res<T>(reinterpret_cast<uintptr_t>(R + roff + c0), c0, W, xs[b]);
      if constexpr (kExplicit<MaskT>)
        load_mask(Mk + roff, W, c0, last_lane, ms[b]);
    }
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const int r = rb + b * kWarpRowStep;
      if (r >= r1) break;
      float x[kColsPerThread], mk[kColsPerThread];
      cells<T>(xs[b], x);
      if constexpr (kExplicit<MaskT>)
        unpack_mask<MaskE, kFp8>(ms[b], lane, mk);
      uint32_t own[Run<T>::kWords];
#pragma unroll
      for (int i = 0; i < Run<T>::kWords; ++i) own[i] = 0u;
      if constexpr (kFp8) {
        // the update in pairs, XLA's order included: the delta (times the
        // mask) rounded to the storage type, added, the sum rounded again
        if constexpr (kUpdate)
          fp8_update<kExplicit<MaskT>, kDeltaFirst>(x, xs[b], mk, a[b],
                                                    ap[b], vo_c, vp_c, own);
        fp8_sweep<kExplicit<MaskT>>(x, mk, a[b], g, h);
      } else {
#pragma unroll
        for (int e = 0; e < kColsPerThread; ++e) {
          float xv = x[e];
          if constexpr (kUpdate) {
            const float d = __fsub_rn(__fmul_rn(a[b], vo_c[e]),
                                      __fmul_rn(ap[b], vp_c[e]));
            float back;
            uint32_t bits;
            if constexpr (kExplicit<MaskT>) {
              // K4: the sweep reads the sum before rounding
              xv = __fadd_rn(xv, __fmul_rn(d, mk[e]));
              bits = round_bits<Round>(xv, back, R);
            } else {
              // K1: the sweep reads the stored value
              bits = round_bits<Round>(__fadd_rn(xv, d), back, R);
              xv = back;
            }
            if constexpr (sizeof(T) == 4)
              own[e] = bits;
            else
              own[e / 2] |= bits << (16 * (e & 1));
          }
          if (!ok[e]) continue;
          if constexpr (kExplicit<MaskT>) {
            g[e] += a[b] * xv;
            h[e] += __fmul_rn(a[b], a[b]) * mk[e];
          } else {
            // an unobserved cell adds +-0, which leaves the sums' bits as
            // skipping it would: selects, not a branch that diverges on a
            // random mask
            const bool obs = !isnan(xv);
            g[e] += a[b] * (obs ? xv : 0.f);
            h[e] += obs ? a[b] * a[b] : 0.f;
          }
        }
      }
      if constexpr (kUpdate)
        store_res<T>(reinterpret_cast<uintptr_t>(
                         R + static_cast<size_t>(r) * W + c0),
                     c0, W, own);
    }
  }

  __shared__ float sg[kColThreadsY][kStripCols];
  __shared__ float sh[kColThreadsY][kStripCols];
#pragma unroll
  for (int e = 0; e < kColsPerThread; ++e) {
    sg[ty][lane * kColsPerThread + e] = g[e];
    sh[ty][lane * kColsPerThread + e] = h[e];
  }
  __syncthreads();
  // one column a thread: the 8 warps' sums in order
  const int t = ty * kColThreadsX + lane;
  const int c = lo + t;
  if (c < 0 || c >= W) return;
  float gs = 0.f, hs = 0.f;
#pragma unroll
  for (int y = 0; y < kColThreadsY; ++y) {
    gs += sg[y][t];
    hs += sh[y][t];
  }
  const size_t o = static_cast<size_t>(blockIdx.y) * W + c;
  gpart[o] = gs;
  hpart[o] = hs;
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

// A row-sweep lane's run of 8 cells x (mask mk where explicit) against
// its 8 values of v into the lane's sums ga, ha.
template <typename T, typename MaskT>
__device__ __forceinline__ void row_run_sum(const float (&x)[kColsPerThread],
                                            const float (&mk)[kColsPerThread],
                                            const float4& lo, const float4& hi,
                                            float& ga, float& ha) {
  const float vc[kColsPerThread] = {lo.x, lo.y, lo.z, lo.w,
                                    hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int e = 0; e < kColsPerThread; ++e) {
    const float vv = __fmul_rn(vc[e], vc[e]);
    if constexpr (kExplicit<MaskT>) {
      ga = __fmaf_rn(x[e], vc[e], ga);
      ha = __fmaf_rn(vv, mk[e], ha);
    } else if constexpr (sizeof(T) == 1) {
      // fp8, bound by its instructions: an observed cell adds by a
      // predicated FMA and add, as the column sweep's fp8_sweep
      if (!isnan(x[e])) {
        ga = __fmaf_rn(x[e], vc[e], ga);
        ha = __fadd_rn(ha, vv);
      }
    } else {
      // an unobserved cell adds +0.0 to g and 0 to h: the bits of
      // skipping it (the sums start at +0.0)
      const bool obs = !isnan(x[e]);
      ga = __fmaf_rn(obs ? x[e] : 0.f, vc[e], ga);
      ha = __fadd_rn(ha, obs ? vv : 0.f);
    }
  }
}

// A row-sweep item's sums from its lanes' (a fixed butterfly over the
// warp: every lane gets the same bits).
__device__ __forceinline__ float2 row_item_total(const float (&ga)[2],
                                                 const float (&ha)[2]) {
  float gs = __fadd_rn(ga[0], ga[1]), hs = __fadd_rn(ha[0], ha[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    gs = __fadd_rn(gs, __shfl_xor_sync(0xffffffffu, gs, off));
    hs = __fadd_rn(hs, __shfl_xor_sync(0xffffffffu, hs, off));
  }
  return make_float2(gs, hs);
}

// The row sweep's slow path (see the header): the sums of the item whose
// runs start at run ``run0`` of the row at ``roff`` (its runs in the span
// from ``kr0``), loaded again and summed as the fast path sums them, with
// the cells outside the row zeroed. Every lane of the warp calls it.
template <typename T, typename MaskT>
__device__ __noinline__ float2 row_item_zeroed(
    const T* __restrict__ R, const MaskT* __restrict__ Mk, size_t roff,
    int W, int run0, int kr0, int shift, const float4* vlo,
    const float4* vhi) {
  using MaskE = std::conditional_t<kExplicit<MaskT>, MaskT, int8_t>;
  constexpr int kSize = static_cast<int>(sizeof(T));
  const int lane = threadIdx.x % 32;
  const uintptr_t row = reinterpret_cast<uintptr_t>(R + roff);
  float ga[2] = {0.f, 0.f}, ha[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kRowRuns; ++j) {
    const int c0 = kColsPerThread * (run0 + lane + 32 * j) - shift;
    uint32_t xw[Run<T>::kWords];
    Loaded<MaskE> m;
    float x[kColsPerThread], mk[kColsPerThread];
    load_res<T>(row + static_cast<intptr_t>(c0) * kSize, c0, W, xw);
    if constexpr (kExplicit<MaskT>) {
      load_mask(Mk + roff, W, c0, lane == 31, m);
      unpack_mask<MaskE, true>(m, lane, mk);
    }
    cells<T>(xw, x);
#pragma unroll
    for (int e = 0; e < kColsPerThread; ++e)
      if (c0 + e < 0 || c0 + e >= W) x[e] = mk[e] = 0.f;
    const int kr = kr0 + lane + 32 * j;
    row_run_sum<T, MaskT>(x, mk, vlo[kr], vhi[kr], ga[j & 1], ha[j & 1]);
  }
  return row_item_total(ga, ha);
}

// Row sweep (K2, masked_usweep): g[r] = sum_c R[r, c] v[c] (over observed
// cells in NaN mode), h[r] = sum_c fl(v[c]^2) m[r, c]. Block b takes
// segment b % segments of row group b / segments: the rows q + inter (i0
// + i), i < kRowBlockRows, of class q = group % inter, i0 = kRowBlockRows
// (group / inter). A row of one segment has all its ``spans`` in it, else
// segment s is span s. For each span of its segment the block stages the
// span's v in shared memory, shifted by the class's shift (run k's 8
// columns at [8k, 8k + 8), 0 outside the row) and split in two planes of
// 4 (a lane's two 16-byte reads of a run fall on consecutive 16 bytes of
// its warp: no bank conflict); then the span's live chunks (nch, 1-8) x
// the rows are items, item k (row k / nch, chunk k % nch) warp k % 8's:
// every warp has work whatever the width. Lane l of an item holds the
// chunk's runs l + 32 j, j < kRowRuns, and a warp loads a batch of items
// (128 residual bytes a lane) before it sums any; an item that holds the
// row's first or last run and sums to NaN takes the slow path (the
// header).
// With segments > 1, gpart and hpart hold (segments, M) floats and count
// a zero a group (left so).
// Resident row-sweep blocks an SM the compiler keeps registers for: 3 (85
// registers), or 2 (128) where a residual of 4 bytes a cell, or 2 beside a
// bf16 mask, needs them for its mask (at 3 it spilled up to 172 bytes).
template <typename T, typename MaskT>
constexpr int kRowMinBlocks =
    kExplicit<MaskT> && sizeof(T) + sizeof(std::conditional_t<
                                        kExplicit<MaskT>, MaskT, int8_t>) >=
                            4
        ? 2
        : 3;

template <typename T, typename MaskT>
__global__ void __launch_bounds__(kRowWarps * 32,
                                  (kRowMinBlocks<T, MaskT>))
    row_sweep_kernel(const T* __restrict__ R, const MaskT* __restrict__ Mk,
                     const float* __restrict__ v, float* __restrict__ gpart,
                     float* __restrict__ hpart, unsigned* __restrict__ count,
                     float* __restrict__ g, float* __restrict__ h, int M,
                     int W, int inter, int runs, int spans, int segments) {
  using MaskE = std::conditional_t<kExplicit<MaskT>, MaskT, int8_t>;
  using Rn = Run<T>;
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int kRows =
      kExplicit<MaskT> ? 1 : kRowBatchBytes / (kRowRuns * Rn::kBytes);
  // whether a cell outside the row can make a sum NaN (see the header)
  constexpr bool kSlowPath = kExplicit<MaskT> || kSize > 1;
  __shared__ float4 vlo[kSpanRuns], vhi[kSpanRuns];
  __shared__ float sg[kRowBlockRows][kSpanChunks];
  __shared__ float sh[kRowBlockRows][kSpanChunks];
  __shared__ bool last_block;
  const int seg = blockIdx.x % segments, grp = blockIdx.x / segments;
  const int q = grp % inter, i0 = (grp / inter) * kRowBlockRows;
  const int nrows = min(kRowBlockRows, (M - q + inter - 1) / inter - i0);
  if (nrows <= 0) return;  // a class with fewer rows: the whole block
  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(R) +
       static_cast<size_t>(q) * static_cast<size_t>(W) * kSize) %
      Rn::kUnit) / kSize;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const bool last_lane = lane == 31;
  // the run that holds a row's last cell (a row's first cell is in run 0)
  const int last_run = (W - 1 + shift) / kColsPerThread;
  float acc_g = 0.f, acc_h = 0.f;  // thread t < nrows: row i0 + t's sums

  const int span_end = segments == 1 ? spans : seg + 1;
  for (int span = segments == 1 ? 0 : seg; span < span_end; ++span) {
    const int nch = min(kSpanChunks,
                        (runs - span * kSpanRuns + kChunkRuns - 1) /
                            kChunkRuns);
    __syncthreads();  // the last span's readers of vlo, vhi, sg, sh
    // the span's v, shifted: run k's cells e < 4 in vlo[k], e >= 4 in
    // vhi[k]
    const int col0 = span * kSpanRuns * kColsPerThread - shift;
    for (int i = t; i < nch * kChunkRuns * kColsPerThread;
         i += kRowWarps * 32) {
      const int c = col0 + i;
      const float x = (c >= 0 && c < W) ? __ldg(v + c) : 0.f;
      float* plane = reinterpret_cast<float*>((i & 4) ? vhi : vlo);
      plane[(i >> 3) * 4 + (i & 3)] = x;
    }
    __syncthreads();

    const int items = nrows * nch;
    for (int k = w; k < items; k += kRowWarps * kRows) {
      // the batch's loads (residual and mask) before any sum
      uint32_t xs[kRows][kRowRuns][Rn::kWords];
      Loaded<MaskE> ms[kRows][kRowRuns];
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const int kb = k + b * kRowWarps;
        if (kb >= items) break;
        const int ii = kb / nch, ch = kb % nch;
        const size_t roff = static_cast<size_t>(q + inter * (i0 + ii)) *
                            static_cast<size_t>(W);
        const uintptr_t row = reinterpret_cast<uintptr_t>(R + roff);
#pragma unroll
        for (int j = 0; j < kRowRuns; ++j) {
          const int c0 =
              kColsPerThread * (span * kSpanRuns + ch * kChunkRuns + lane +
                                32 * j) -
              shift;
          load_res<T>(row + static_cast<intptr_t>(c0) * kSize, c0, W,
                      xs[b][j]);
          if constexpr (kExplicit<MaskT>)
            load_mask(Mk + roff, W, c0, last_lane, ms[b][j]);
        }
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const int kb = k + b * kRowWarps;
        if (kb >= items) break;
        const int ii = kb / nch, ch = kb % nch;
        float ga[2] = {0.f, 0.f}, ha[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kRowRuns; ++j) {
          const int kr = ch * kChunkRuns + lane + 32 * j;  // run in span
          float x[kColsPerThread], mk[kColsPerThread];
          cells<T>(xs[b][j], x);
          if constexpr (kExplicit<MaskT>)
            unpack_mask<MaskE, true>(ms[b][j], lane, mk);
          row_run_sum<T, MaskT>(x, mk, vlo[kr], vhi[kr], ga[j & 1],
                                ha[j & 1]);
        }
        float2 tot = row_item_total(ga, ha);
        if constexpr (kSlowPath) {
          // an item with the row's first or last run whose sums are NaN:
          // uniform over the warp, and rare (the header)
          const int run0 = span * kSpanRuns + ch * kChunkRuns;
          if ((isnan(tot.x) || isnan(tot.y)) &&
              (run0 == 0 ||
               (last_run >= run0 && last_run < run0 + kChunkRuns)))
            tot = row_item_zeroed<T, MaskT>(
                R, Mk,
                static_cast<size_t>(q + inter * (i0 + ii)) *
                    static_cast<size_t>(W),
                W, run0, ch * kChunkRuns, shift, vlo, vhi);
        }
        const float gs = tot.x, hs = tot.y;
        if (lane == 0) {
          sg[ii][ch] = gs;
          sh[ii][ch] = hs;
        }
      }
    }
    __syncthreads();
    // the span's chunks in chunk order
    if (t < nrows) {
      for (int c = 0; c < nch; ++c) {
        acc_g = __fadd_rn(acc_g, sg[t][c]);
        acc_h = __fadd_rn(acc_h, sh[t][c]);
      }
    }
  }

  const int r = q + inter * (i0 + t);  // thread t's row (t < nrows)
  if (segments == 1) {
    if (t < nrows) {
      g[r] = acc_g;
      h[r] = acc_h;
    }
    return;
  }
  if (t < nrows) {
    gpart[static_cast<size_t>(seg) * M + r] = acc_g;
    hpart[static_cast<size_t>(seg) * M + r] = acc_h;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last_block = atomicAdd(count + grp, 1u) == segments - 1u;
  __syncthreads();
  if (!last_block) return;
  // the group's last block: each row's segments in segment order
  __threadfence();
  if (t < nrows) {
    float gt = 0.f, ht = 0.f;
    for (int k = 0; k < segments; ++k) {
      gt = __fadd_rn(gt, __ldcg(gpart + static_cast<size_t>(k) * M + r));
      ht = __fadd_rn(ht, __ldcg(hpart + static_cast<size_t>(k) * M + r));
    }
    g[r] = gt;
    h[r] = ht;
  }
  if (t == 0) count[grp] = 0u;
}

template <typename T, typename MaskT, bool kUpdate, typename Round = RoundCvt,
          typename Order = StoreOnce>
void launch_col_sweep(void* R, const void* Mk, const void* uo, const void* up,
                      const void* vo, const void* vp, void* gpart,
                      void* hpart, void* g, void* h, int M, int W,
                      int rows_per_part, cudaStream_t stream) {
  // a strip shifts left by up to kMaxShift<T> cells (the kernel's
  // ``shift``): one more strip covers the row's end
  const int band = kInterleave<T> * rows_per_part;
  const int nparts = kInterleave<T> * ((M + band - 1) / band);
  const dim3 grid((W + kMaxShift<T> + kStripCols - 1) / kStripCols, nparts);
  const dim3 block(kColThreadsX, kColThreadsY);
  col_sweep_kernel<T, MaskT, kUpdate, Round, Order>
      <<<grid, block, 0, stream>>>(
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

// Launches the row sweep by ops/panel_kernels.py::row_sweep_plan's
// ``inter``, ``runs``, ``segments`` and ``groups``; cudaErrorInvalidValue
// (nothing launched) where they would leave a cell or a row out or break
// the segment rule, or where a plan of more than one segment lacks its
// partials or counters.
template <typename T, typename MaskT>
int launch_row_sweep(const void* R, const void* Mk, const void* v,
                     void* gpart, void* hpart, void* count, void* g, void* h,
                     int M, int W, int inter, int runs, int segments,
                     int groups, cudaStream_t stream) {
  constexpr int kUnit = Run<T>::kUnit;
  constexpr int kSize = static_cast<int>(sizeof(T));
  // the rows a class apart must share their shift, the runs cover the
  // widest shifted row, the groups every row of every class
  const int max_shift =
      inter == 1 ? static_cast<int>(reinterpret_cast<uintptr_t>(R) % kUnit) /
                       kSize
                 : kUnit / kSize - 1;
  const int spans = (runs + kSpanRuns - 1) / kSpanRuns;
  const long long grid = static_cast<long long>(segments) * groups;
  if (inter <= 0 || kUnit % inter != 0 ||
      static_cast<long long>(W) * kSize * inter % kUnit != 0 ||
      static_cast<long long>(runs) * kColsPerThread <
          static_cast<long long>(W) + max_shift ||
      segments != (spans <= kRowSegmentSpans ? 1 : spans) ||
      static_cast<long long>(groups) * kRowBlockRows <
          static_cast<long long>(inter) * ((M + inter - 1) / inter) ||
      groups % inter != 0 || grid > 0x7fffffffLL ||
      (segments > 1 && (gpart == nullptr || hpart == nullptr ||
                        count == nullptr)))
    return cudaErrorInvalidValue;
  row_sweep_kernel<T, MaskT>
      <<<static_cast<unsigned>(grid), kRowWarps * 32, 0, stream>>>(
          static_cast<const T*>(R), static_cast<const MaskT*>(Mk),
          static_cast<const float*>(v), static_cast<float*>(gpart),
          static_cast<float*>(hpart), static_cast<unsigned*>(count),
          static_cast<float*>(g), static_cast<float*>(h), M, W, inter, runs,
          spans, segments);
  return static_cast<int>(cudaGetLastError());
}

// residual dtype codes shared with ops/panel_kernels.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat8 = 2;
// mask codes shared with ops/panel_kernels.py: none (the NaN sentinel; the
// mask pointer must be null), or an explicit bfloat16 / int8 array
constexpr int kMaskNone = 0;
constexpr int kMaskBFloat16 = 1;
constexpr int kMaskInt8 = 2;
// store order codes shared with ops/panel_kernels.py (delta-first: fp8
// only)
constexpr int kOrderOnce = 0;
constexpr int kOrderDeltaFirst = 1;

bool bad_args(int dtype, int M, int W) {
  return (dtype != kFloat32 && dtype != kBFloat16 && dtype != kFloat8) ||
         M <= 0 || W <= 0;
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

// Column sweep (update or not) for a residual dtype code, store order code
// and mask type; false (nothing launched) for an order the dtype does not
// take.
template <typename MaskT, bool kUpdate>
bool col_sweep(int dtype, int order, void* R, const void* Mk, const void* uo,
               const void* up, const void* vo, const void* vp, void* gpart,
               void* hpart, void* g, void* h, int M, int W, int rows_per_part,
               cudaStream_t s) {
  if (order != kOrderOnce && (dtype != kFloat8 || order != kOrderDeltaFirst))
    return false;
  if (dtype == kFloat32)
    launch_col_sweep<float, MaskT, kUpdate>(R, Mk, uo, up, vo, vp, gpart,
                                            hpart, g, h, M, W, rows_per_part,
                                            s);
  else if (dtype == kBFloat16)
    launch_col_sweep<__nv_bfloat16, MaskT, kUpdate>(R, Mk, uo, up, vo, vp,
                                                    gpart, hpart, g, h, M, W,
                                                    rows_per_part, s);
  else if (order == kOrderOnce)
    launch_col_sweep<Fp8, MaskT, kUpdate>(R, Mk, uo, up, vo, vp, gpart,
                                          hpart, g, h, M, W, rows_per_part,
                                          s);
  else if constexpr (kUpdate)
    launch_col_sweep<Fp8, MaskT, kUpdate, RoundCvt, StoreDeltaFirst>(
        R, Mk, uo, up, vo, vp, gpart, hpart, g, h, M, W, rows_per_part, s);
  else
    return false;
  return true;
}

template <typename MaskT>
int row_sweep(int dtype, const void* R, const void* Mk, const void* v,
              void* gpart, void* hpart, void* count, void* g, void* h, int M,
              int W, int inter, int runs, int segments, int groups,
              cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_row_sweep<float, MaskT>(R, Mk, v, gpart, hpart, count, g,
                                          h, M, W, inter, runs, segments,
                                          groups, s);
  if (dtype == kBFloat16)
    return launch_row_sweep<__nv_bfloat16, MaskT>(
        R, Mk, v, gpart, hpart, count, g, h, M, W, inter, runs, segments,
        groups, s);
  return launch_row_sweep<Fp8, MaskT>(R, Mk, v, gpart, hpart, count, g, h, M,
                                      W, inter, runs, segments, groups, s);
}

}  // namespace

// Each entry point launches on ``stream`` and returns cudaGetLastError():
// a refused launch (bad configuration) never runs and is reported only here.
// ``Mk`` and ``mask_dtype`` select the mask: (null, kMaskNone) for a
// NaN-sentinel residual (K1-K3), else an explicit mask (K4 and the masked
// sweeps). ``order`` selects the update's store order (kOrderOnce, or at
// fp8 kOrderDeltaFirst).
extern "C" {

int crtpu_update_vsweep(void* R, int dtype, const void* Mk, int mask_dtype,
                        int order, const void* uo, const void* up,
                        const void* vo, const void* vp, void* gpart,
                        void* hpart, void* g, void* h, int M, int W,
                        int rows_per_part, void* stream) {
  if (bad_args(dtype, M, W) || rows_per_part <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  const bool known = with_mask(Mk, mask_dtype, [&](auto tag) {
    ok = col_sweep<typename decltype(tag)::type, true>(
        dtype, order, R, Mk, uo, up, vo, vp, gpart, hpart, g, h, M, W,
        rows_per_part, s);
  });
  return known && ok ? static_cast<int>(cudaGetLastError())
                     : cudaErrorInvalidValue;
}

int crtpu_vsweep(const void* R, int dtype, const void* Mk, int mask_dtype,
                 const void* u, void* gpart, void* hpart, void* g, void* h,
                 int M, int W, int rows_per_part, void* stream) {
  if (bad_args(dtype, M, W) || rows_per_part <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* Rw = const_cast<void*>(R);  // the read-only instantiation never stores
  const bool ok = with_mask(Mk, mask_dtype, [&](auto tag) {
    col_sweep<typename decltype(tag)::type, false>(
        dtype, kOrderOnce, Rw, Mk, u, nullptr, nullptr, nullptr, gpart,
        hpart, g, h, M, W, rows_per_part, s);
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

// The row sweep (K2, masked_usweep) by ops/panel_kernels.py::
// row_sweep_plan (its ``interleave``, ``runs``, ``segments`` and
// ``groups``); with more than one segment, gpart and hpart hold
// (segments, M) floats and count the row groups' zeros (left so).
int crtpu_usweep(const void* R, int dtype, const void* Mk, int mask_dtype,
                 const void* v, void* gpart, void* hpart, void* count,
                 void* g, void* h, int M, int W, int inter, int runs,
                 int segments, int groups, void* stream) {
  if (bad_args(dtype, M, W)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cudaErrorInvalidValue;
  with_mask(Mk, mask_dtype, [&](auto tag) {
    err = row_sweep<typename decltype(tag)::type>(
        dtype, R, Mk, v, gpart, hpart, count, g, h, M, W, inter, runs,
        segments, groups, s);
  });
  return err;
}

}  // extern "C"
