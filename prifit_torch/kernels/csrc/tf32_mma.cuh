// Tensor-core building blocks of the clustering kernels (bandwidth.cu,
// mean_shift.cu, mean_shift_bwd.cu, nms.cu): 3xTF32 products with mma.sync
// m16n8k8, cp.async copies into shared memory, and the fragment layouts
// they use.
//
// 3xTF32: each f32 operand is split a = hi + lo, hi = tf32(a) rounded to
// nearest and lo = a - hi (split_tf32), and a product is taken as
// lo*hi + hi*lo + hi*hi with an f32 accumulator.  That keeps about
// 21 bits of each operand, against 11 for a single TF32 product, which is
// what the f32 limits of the mean-shift step need (the exponent
// (<q, x> - 1) / b^2 is divided by b^2 ~ 0.1-1).
//
// Fragments of mma.m16n8k8 (tf32 A and B, f32 C), lane = 4 grp + tig:
//   A 16x8, row-major: a0 (grp, tig)  a1 (grp + 8, tig)
//                      a2 (grp, tig + 4)  a3 (grp + 8, tig + 4)
//   B 8x8 (k x n):     b0 (tig, grp)  b1 (tig + 4, grp)
//   C 16x8:            c0 (grp, 2 tig)  c1 (grp, 2 tig + 1)
//                      c2 (grp + 8, 2 tig)  c3 (grp + 8, 2 tig + 1)
// The k index of a product may be permuted freely.  Two permutations keep
// the loads wide and the C tile in registers:
//   - within a k-step, k = tig is column 2 tig and k = tig + 4 column
//     2 tig + 1 of the step's 8, so b0 and b1 of a first product (B = a
//     tile transposed) are adjacent floats (frag_bt, load_frag_rows);
//   - a C tile of a first product feeds a second product as its A operand
//     without a trip through shared memory: with k = tig the C column
//     2 tig and k = tig + 4 the column 2 tig + 1, (a0, a1, a2, a3) =
//     (c0, c2, c1, c3), and B's rows are read in that order (frag_b_pair).
#pragma once

#include <type_traits>

#include "common.cuh"

// Rows of width d <= 128 are held in shared memory padded with zeros to DP,
// the least of 32, 64 and 128 that is at least d (kernels/shapes.py picks
// it).  A zero column adds exactly nothing to a 3xTF32 product
// (split_tf32(0) is (0, 0)).  Each kernel is instantiated for the three.
template <int DP>
struct Width {
  static_assert(DP == 32 || DP == 64 || DP == 128, "DP is 32, 64 or 128");
  static constexpr int kNT = DP / 8;                   // n-tiles of a row
  static constexpr int kHalfPairs = DP >= 64 ? 4 : 2;  // n-tile pairs a half
  static constexpr int kHalfNT = 2 * kHalfPairs;       // n-tiles a half
  static constexpr int kHalves = kNT / kHalfNT;        // 2, 1, 1
};

// Calls f(DP, full) for the padded width dp (32, 64 or 128) of rows of
// width d, as std::integral_constant values, with full = (d == dp): a kernel
// instantiated with full takes d as the constant DP, so at d = 128 it is
// the code of a kernel written for that width alone.
template <typename F>
int with_width(int d, int dp, F&& f) {
  using std::false_type;
  using std::integral_constant;
  using std::true_type;
  switch (dp) {
    case 32:
      return d == 32 ? f(integral_constant<int, 32>(), true_type())
                     : f(integral_constant<int, 32>(), false_type());
    case 64:
      return d == 64 ? f(integral_constant<int, 64>(), true_type())
                     : f(integral_constant<int, 64>(), false_type());
    case 128:
      return d == 128 ? f(integral_constant<int, 128>(), true_type())
                      : f(integral_constant<int, 128>(), false_type());
  }
  return (int)cudaErrorInvalidValue;
}

// A [rows][DP] f32 tile in shared memory keeps rows of DP floats with the
// 8-byte pairs of row r permuted, pair p at p ^ 4 sw(r), sw(r) = (r & 3) ^
// ((r >> 2) & 1) (a row has at least 16 pairs, so p ^ 4 sw stays in it).
// Then each half-warp's 8-byte B-fragment reads hit all 32 banks once:
// frag_bt's (4 consecutive rows, 4 adjacent pairs) and frag_b_pair's (rows
// 2 tig, pairs grp) alike, which no row padding does for both.  16-byte
// chunks stay whole, so cp.async fills rows as they are.
template <int DP>
__device__ __forceinline__ int tile_at(int r, int c) {
  const int sw = (r & 3) ^ ((r >> 2) & 1);
  return r * DP + ((((c >> 1) ^ (sw << 2)) << 1) | (c & 1));
}

constexpr float kClampLo = -13.0f;
constexpr float kClampHi = 75.0f;

// hi = x rounded to TF32 (to nearest, ties away: add half a TF32 ulp, then
// drop the 13 low bits), lo = x - hi exactly.  lo goes to the tensor cores
// as it is: an mma on .tf32 operands ignores their 13 low bits, so lo is
// truncated to TF32 there, which costs less than 2^-23 |x| (|lo| is at
// most half a TF32 ulp of x).  Three integer and float operations, against
// two cvt.rna.tf32.f32 conversions and a subtraction.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
  __device__ __forceinline__ void set(float4 v) { set(v.x, v.y, v.z, v.w); }
  // From a C tile of a first product (the permuted k order above).
  __device__ __forceinline__ void from_c(const float (&c)[4]) {
    set(c[0], c[2], c[1], c[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (an accumulator of zeros).
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// d[nt] += a b[nt] (d[nt] = a b[nt] when kFresh) in 3xTF32 for NT n-tiles,
// the small terms first, each term over all n-tiles before the next, so NT
// independent chains hide the mma latency.
template <int NT, bool kFresh = false>
__device__ __forceinline__ void mma_3xtf32_row(float (*d)[4], const FragA& a,
                                               const FragB (&b)[NT]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (kFresh)
      mma_tf32_fresh(d[nt], a.lo, b[nt].hi);
    else
      mma_tf32(d[nt], a.lo, b[nt].hi);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], a.hi, b[nt].lo);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], a.hi, b[nt].hi);
}

// B fragment of tile^T for a first product (k over the tile's columns,
// permuted as the A fragments are): rows n0 + grp, columns 8 kk + 2 tig
// and 8 kk + 2 tig + 1, one 8-byte load.
template <int DP>
__device__ __forceinline__ FragB frag_bt(const float* tile, int n0, int kk,
                                         int grp, int tig) {
  const float2 v = *reinterpret_cast<const float2*>(
      tile + tile_at<DP>(n0 + grp, 8 * kk + 2 * tig));
  FragB b;
  b.set(v.x, v.y);
  return b;
}

// B fragments of the tile for a second product whose A came from a C tile
// (k over the tile's rows k0 + 2 tig, k0 + 2 tig + 1), for the pair of
// n-tiles 2 p (even) and 2 p + 1 (odd): n-tile 2 p + e, lane column grp
// is tile column 16 p + 2 grp + e, so both come from one 8-byte load a
// row.  Its C element (row, 2 tig + c) is output column 16 p + 4 tig +
// 2 c + e: a thread's 4 values of a row in the pair are 4 adjacent
// columns (pair_row).
template <int DP>
__device__ __forceinline__ void frag_b_pair(const float* tile, int k0, int p,
                                            int grp, int tig, FragB& even,
                                            FragB& odd) {
  const int c = 16 * p + 2 * grp;
  const float2 r0 = *reinterpret_cast<const float2*>(
      tile + tile_at<DP>(k0 + 2 * tig, c));
  const float2 r1 = *reinterpret_cast<const float2*>(
      tile + tile_at<DP>(k0 + 2 * tig + 1, c));
  even.set(r0.x, r1.x);
  odd.set(r0.y, r1.y);
}

// d[i] += a tile[k0..k0+8) (d[i] = ... when kFresh) for the kHalfNT output
// n-tiles kHalfNT half + i (output columns 64 half..64 half + 63; at DP = 32
// the one half is columns 0..31).
template <int DP, bool kFresh = false>
__device__ __forceinline__ void mma_3xtf32_half(float (*d)[4], const FragA& a,
                                                const float* tile, int k0,
                                                int half, int grp, int tig) {
  constexpr int kP = Width<DP>::kHalfPairs;
  FragB bx[2 * kP];
#pragma unroll
  for (int pp = 0; pp < kP; ++pp)
    frag_b_pair<DP>(tile, k0, kP * half + pp, grp, tig, bx[2 * pp],
                    bx[2 * pp + 1]);
  mma_3xtf32_row<2 * kP, kFresh>(d, a, bx);
}

// d[dn] += a tile[k0..k0+8) for all DP / 8 n-tiles of the output, a half
// (at most 32 registers of B fragments) at a time.
template <int DP>
__device__ __forceinline__ void mma_3xtf32_rows_of(float (&d)[DP / 8][4],
                                                   const FragA& a,
                                                   const float* tile, int k0,
                                                   int grp, int tig) {
#pragma unroll
  for (int half = 0; half < Width<DP>::kHalves; ++half)
    mma_3xtf32_half<DP>(d + Width<DP>::kHalfNT * half, a, tile, k0, half,
                        grp, tig);
}

// The C values of row half h (rows grp, grp + 8) of n-tile pair p, in
// output column order 16 p + 4 tig + 0..3 (see frag_b_pair), times scale.
template <int DP>
__device__ __forceinline__ float4 pair_row(const float (&d)[DP / 8][4], int p,
                                           int h, float scale) {
  return make_float4(d[2 * p][2 * h] * scale, d[2 * p + 1][2 * h] * scale,
                     d[2 * p][2 * h + 1] * scale,
                     d[2 * p + 1][2 * h + 1] * scale);
}

// Columns col..col+3 (col a multiple of 4) of a row of width d: one 16-byte
// store where the row's columns are 16-byte aligned (d % 4 == 0), else one
// store a column; columns past d are dropped.
__device__ __forceinline__ void store_cols(float* row, int col, float4 v,
                                           int d) {
  if ((d & 3) == 0) {
    if (col < d) *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < d) row[col + i] = e[i];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// 4 bytes, for rows that are not 16-byte aligned (d % 4 != 0).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows src_row(r), r < nrows, of a [*, d] f32 array into an
// [nrows][DP] tile (tile_at) with cp.async, columns d..DP-1 zeros; a row for
// which src_row gives -1 is filled with zeros.  16-byte copies where rows
// are 16-byte aligned (d % 4 == 0), 4-byte ones otherwise.  All threads of
// the block take part.
template <int DP, typename RowFn>
__device__ __forceinline__ void stage_rows(float* tile,
                                           const float* __restrict__ src,
                                           int d, int nrows, RowFn src_row) {
  constexpr int kV = DP / 4;
  const bool vec = (d & 3) == 0;
  for (int c = threadIdx.x; c < nrows * kV; c += blockDim.x) {
    const int r = c / kV, c4 = c % kV;
    const int row = src_row(r);
    float* dst = tile + tile_at<DP>(r, c4 * 4);
    const float* g = src + (size_t)(row < 0 ? 0 : row) * d + c4 * 4;
    if (vec) {
      const bool pred = row >= 0 && c4 * 4 < d;
      cp_async16(dst, pred ? g : src, pred);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool pred = row >= 0 && c4 * 4 + e < d;
        cp_async4(dst + e, pred ? g + e : src, pred);
      }
    }
  }
}

// Rows src_row(r), r < nrows (a multiple of 16), of a [*, d] f32 array into
// shared memory as A fragments of width DP (columns d..DP-1 zeros), split
// into hi and lo as they are read (the split fragments of a warp's 16 rows
// would not fit in registers beside its accumulator): float4 index
// ((DP / 8) grp16 + kk) 32 + lane holds (a0, a1, a2, a3) of rows 16 grp16.. and
// k-step kk (-1: zeros), with the k index permuted within the step so that
// k = tig is column 8 kk + 2 tig and k = tig + 4 is column 8 kk + 2 tig + 1
// (frag_bt reads B likewise).
template <int DP, typename RowFn>
__device__ __forceinline__ void load_frag_rows(float* frag,
                                               const float* __restrict__ src,
                                               int d, int nrows,
                                               RowFn src_row) {
  for (int e = threadIdx.x; e < nrows * DP; e += blockDim.x) {
    const int r = e / DP, c = e % DP;
    const int row = src_row(r);
    const float v = row < 0 || c >= d ? 0.0f : src[(size_t)row * d + c];
    const int rr = r % 16, cc = c % 8;
    const int lane = (rr % 8) * 4 + cc / 2;
    const int comp = rr / 8 + 2 * (cc % 2);
    frag[(((r / 16) * (DP / 8) + c / 8) * 32 + lane) * 4 + comp] = v;
  }
}

// K = exp(clip(e)) with e = (sim - 1) / b^2, from sm1 = sim - 1, and
// whether e lies strictly inside the clip range (guard_exp's gradient
// cutoff).
__device__ __forceinline__ float kernel_value(float sm1, float inv_bw2,
                                              bool& live) {
  const float e = sm1 * inv_bw2;
  live = e > kClampLo && e < kClampHi;
  return expf(fminf(fmaxf(e, kClampLo), kClampHi));
}
