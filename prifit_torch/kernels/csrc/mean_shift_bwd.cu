// Backward of one Gaussian mean-shift step (mean_shift.cu) on the tensor
// cores, over the live rows of the cotangent only: nothing [n, n] is stored
// and no atomics are used.
//
// Forward: K_ij = exp(clip(e_ij, -13, 75)), e_ij = (<q_i, x_j> - 1) / b^2,
//          s_i = sum_j K_ij,  m_i = (sum_j K_ij x_j) / s_i.
// With the cotangent g of m:
//   c_i  = <g_i, m_i>
//   t_ij = K_ij (<g_i, x_j> - c_i) / (s_i b^2),  0 where e_ij was clipped
//   dq_i = sum_j t_ij x_j
//   dx_j = sum_i t_ij q_i + sum_i (K_ij / s_i) g_i
// b^2 gets no gradient (the bandwidth is computed without one upstream).
//
// Replaces the backward TPU kernel prifit_tpu/ops/pallas/mean_shift.py::
// _bwd_kernel (_pallas_bwd, the custom VJP of mean_shift_step_pallas).  That
// kernel walks its row tiles in a sequential grid and carries dx across them
// in one [n, D] output block.  Blocks on Hopper run in no order, so the two
// sums go to two kernels, as in a flash-attention backward.
//
// Live rows.  A row i with g_i = 0 has c_i = 0 and t_ij = 0, so it adds
// exactly nothing to dq or dx.  On the self-sup path g is the gradient of
// the centers gathered from the modes, so at most max_num_clusters (25) of
// n rows are live.  The wrapper lists them on the device (order: live rows
// first in ascending id, count: how many), and both passes walk that list:
//   1. rows pass: a block of 8 warps owns 32 slots k of order.  If no slot
//      is live it writes zeros to dq rows order[k]; otherwise it holds the
//      32 rows of q and g as A fragments and streams x in 128-row chunks,
//      each warp taking 16 slots x 32 chunk rows.  The stacked product
//      [q; g] x^T gives sim and <g, x> from one read of x's fragments;
//      t then feeds t x from the accumulator (tf32_mma.cuh).  The four
//      warps of a slot group add their partial dq through shared memory.
//      It writes c_i for the second pass.
//   2. columns pass: a block of 4 warps owns 64 rows j of x (A fragments)
//      and streams only the ceil(count / 32) tiles of live rows i, gathered
//      through order with their 1 / s_i, 1 / (s_i b^2), c_i / (s_i b^2).
//      Per tile it recomputes sim and <g, x>, forms t and K / s in
//      registers, and accumulates dx_j = t^T q + (K / s)^T g.
// With every row live (count = n) this is the dense flash-style backward.
//
// Any width d <= 128 and any n: rows are held padded with zeros to DP (the
// kernels' template width, tf32_mma.cuh), and dq and dx get only their d
// columns.  In the rows pass t_ij is set to exactly 0 for the columns j past
// n (zero rows of x in shared memory); in the columns pass the i past count
// have 1 / s = 0 and so t = K / s = 0; rows past n write nothing.
//
// Precision.  t_ij and K_ij / s_i are up to 1 / b^2 (~250 at the smallest
// bandwidth held) times the gradient they sum to, and an error of sim moves
// every K of its row by that factor too.  The tensor cores add each product
// to their accumulator with less care than an f32 add, so no long sum stays
// in them: sim and <g, x> are summed a k-step at a time, dq and dx a
// streamed tile at a time, each partial added in f32.
//
// Bound on the H100: operations when g is dense, 10 n^2 D flops a shape
// (the two forward products and the three backward ones; this kernel
// recomputes sim and <g, x> in both passes, 14 n^2 D) in 3xTF32 at the TF32
// rate; bytes when few rows are live (10 count n D flops): x and g read,
// dq and dx written.
#include "tf32_mma.cuh"

namespace {

template <int NT>
__device__ __forceinline__ void add_to(float (*d)[4],
                                       const float (&part)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[nt][r] += part[nt][r];
}

// ---- rows pass ----
constexpr int kSlots = 32;                    // slots of order a block owns
constexpr int kChunk = 128;                   // x rows per streamed chunk
constexpr int kSub = 32;                      // chunk rows per warp
constexpr int kRowWarps = (kSlots / 16) * (kChunk / kSub);  // 8
constexpr int kRowThreads = 32 * kRowWarps;
template <int DP>
constexpr size_t rows_smem_bytes() {
  return sizeof(float) * (2 * kSlots * DP + 2 * kSlots + 2 * kChunk * DP);
}

// Row i of a [*, d] array, as float4 chunks where d % 4 == 0: c = <g_i, m_i>
// summed by a warp.
__device__ __forceinline__ float warp_dot(const float* g, const float* m,
                                          int d, int lane) {
  float c = 0.0f;
  if ((d & 3) == 0) {
    for (int c4 = lane; c4 < d / 4; c4 += 32) {
      const float4 gv = reinterpret_cast<const float4*>(g)[c4];
      const float4 mv = reinterpret_cast<const float4*>(m)[c4];
      c += gv.x * mv.x + gv.y * mv.y + gv.z * mv.z + gv.w * mv.w;
    }
  } else {
    for (int k = lane; k < d; k += 32) c += g[k] * m[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, off);
  return c;
}

template <int DP, bool kFull>
__global__ void __launch_bounds__(kRowThreads, 1)
    ms_bwd_rows_kernel(const float* __restrict__ q,
                       const float* __restrict__ x,
                       const float* __restrict__ bw2,
                       const float* __restrict__ m,
                       const float* __restrict__ s,
                       const float* __restrict__ g,
                       const int* __restrict__ order,
                       const int* __restrict__ count,
                       float* __restrict__ c_out, float* __restrict__ dq,
                       int n, int d) {
  if (kFull) d = DP;  // a constant from here on
  constexpr int kChunkFloats = kChunk * DP;
  constexpr int kRedStride = DP + 4;  // dq partials: rows 4 banks apart
  static_assert(kRowWarps * 16 * kRedStride <= 2 * kChunkFloats,
                "the dq reduction reuses the chunk ring");
  constexpr int kV = DP / 4;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kSlots;
  const size_t base = (size_t)b * n;
  const int* ord = order + base;
  const int cnt = count[b];

  if (k0 >= cnt) {  // no live slot: dq rows are exact zeros
    for (int e = threadIdx.x; e < kSlots * kV; e += blockDim.x) {
      const int k = k0 + e / kV;
      if (k < n)
        store_cols(dq + (base + ord[k]) * d, (e % kV) * 4,
                   make_float4(0.0f, 0.0f, 0.0f, 0.0f), d);
    }
    return;
  }

  float* qf = smem;                    // [kSlots * DP] A fragments of q
  float* gf = qf + kSlots * DP;        // [kSlots * DP] A fragments of g
  float* rs2 = gf + kSlots * DP;       // [kSlots] 1 / (s b^2)
  float* cs2 = rs2 + kSlots;           // [kSlots] c / (s b^2)
  float* xs = cs2 + kSlots;            // [2][kChunk][DP] chunks of x

  const float* xb = x + base * d;
  const float inv_bw2 = 1.0f / bw2[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int sgrp = warp / (kChunk / kSub);   // 16-slot group of this warp
  const int sub = warp % (kChunk / kSub);    // its 32 rows of each chunk
  const int nchunks = (n + kChunk - 1) / kChunk;
  auto slot_row = [&](int r) { return k0 + r < n ? ord[k0 + r] : -1; };

  auto stage = [&](int chunk) {
    const int j0 = chunk * kChunk;
    stage_rows<DP>(xs + (chunk & 1) * kChunkFloats, xb, d, kChunk,
               [&](int r) { return j0 + r < n ? j0 + r : -1; });
    cp_async_commit();
  };
  stage(0);
  load_frag_rows<DP>(qf, q + base * d, d, kSlots, slot_row);
  load_frag_rows<DP>(gf, g + base * d, d, kSlots, slot_row);
  // Row statistics, one warp a slot: c = <g, m>, 1 / (s b^2), c / (s b^2).
  for (int r = warp; r < kSlots; r += kRowWarps) {
    const int row = slot_row(r);
    float c = 0.0f, r2 = 0.0f;
    if (row >= 0) {
      c = warp_dot(g + (base + row) * d, m + (base + row) * d, d, lane);
      r2 = inv_bw2 / s[base + row];
      if (lane == 0) c_out[base + row] = c;
    }
    if (lane == 0) {
      rs2[r] = r2;
      cs2[r] = c * r2;
    }
  }
  __syncthreads();
  const float my_rs2[2] = {rs2[sgrp * 16 + grp], rs2[sgrp * 16 + grp + 8]};
  const float my_cs2[2] = {cs2[sgrp * 16 + grp], cs2[sgrp * 16 + grp + 8]};
  const float4* qw =
      reinterpret_cast<const float4*>(qf) + sgrp * (DP / 8) * 32;
  const float4* gw =
      reinterpret_cast<const float4*>(gf) + sgrp * (DP / 8) * 32;
  const bool active = k0 + sgrp * 16 < cnt;  // a live slot in my group

  float acc[DP / 8][4] = {};
  for (int it = 0; it < nchunks; ++it) {
    if (it + 1 < nchunks) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk it visible to all
    const int j0 = it * kChunk + sub * kSub;
    if (active && j0 < n) {
      const float* xt = xs + (it & 1) * kChunkFloats + sub * kSub * DP;
      float sim[kSub / 8][4] = {}, gx[kSub / 8][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < DP / 8; ++kk) {
        FragA aq, ag;
        aq.set(qw[kk * 32 + lane]);
        ag.set(gw[kk * 32 + lane]);
        FragB bx[kSub / 8];
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt)
          bx[nt] = frag_bt<DP>(xt, nt * 8, kk, grp, tig);
        float ps[kSub / 8][4], pg[kSub / 8][4];
        mma_3xtf32_row<kSub / 8, true>(ps, aq, bx);
        mma_3xtf32_row<kSub / 8, true>(pg, ag, bx);
        add_to(sim, ps);
        add_to(gx, pg);
      }
      // t in place of <g, x>; exactly 0 in the columns past n
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          bool inside;
          const float K = kernel_value(sim[nt][r] - 1.0f, inv_bw2, inside);
          const int h = r >> 1;
          inside = inside && j0 + nt * 8 + 2 * tig + (r & 1) < n;
          gx[nt][r] = inside ? K * (gx[nt][r] * my_rs2[h] - my_cs2[h]) : 0.0f;
        }
      // acc += t x, this chunk's sum first
      FragA at[kSub / 8];
#pragma unroll
      for (int ks = 0; ks < kSub / 8; ++ks) at[ks].from_c(gx[ks]);
#pragma unroll
      for (int half = 0; half < Width<DP>::kHalves; ++half) {
        float part[Width<DP>::kHalfNT][4];
        mma_3xtf32_half<DP, true>(part, at[0], xt, 0, half, grp, tig);
#pragma unroll
        for (int ks = 1; ks < kSub / 8; ++ks)
          mma_3xtf32_half<DP>(part, at[ks], xt, ks * 8, half, grp, tig);
        add_to(acc + Width<DP>::kHalfNT * half, part);
      }
    }
    __syncthreads();  // chunk it consumed before its stage is refilled
  }

  // dq of each slot group = the sum of its four warps' partials.
  float* red = xs;  // [kRowWarps][16][kRedStride]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = red + (warp * 16 + grp + 8 * h) * kRedStride + 4 * tig;
#pragma unroll
    for (int p = 0; p < DP / 16; ++p)
      *reinterpret_cast<float4*>(dst + 16 * p) =
          pair_row<DP>(acc, p, h, 1.0f);
  }
  __syncthreads();
  constexpr int kParts = kChunk / kSub;
  for (int e = threadIdx.x; e < kSlots * kV; e += blockDim.x) {
    const int r = e / kV, c4 = e % kV;
    const int row = slot_row(r);
    if (row < 0 || c4 * 4 >= d) continue;
    const int w0 = (r / 16) * kParts;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(
          red + ((w0 + p) * 16 + r % 16) * kRedStride + c4 * 4);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store_cols(dq + (base + row) * d, c4 * 4, sum, d);
  }
}

// ---- columns pass ----
constexpr int kJRows = 64;                 // rows j of x a block owns
constexpr int kColWarps = kJRows / 16;     // 4
constexpr int kColThreads = 32 * kColWarps;
constexpr int kITile = 32;                 // live rows i per streamed tile
template <int DP>
__host__ __device__ constexpr int itile_floats() {
  return 2 * kITile * DP + 3 * kITile;
}

template <int DP>
constexpr size_t cols_smem_bytes() {
  return sizeof(float) * (kJRows * DP + 2 * itile_floats<DP>());
}

template <int DP, bool kFull>
__global__ void __launch_bounds__(kColThreads, 2)
    ms_bwd_cols_kernel(const float* __restrict__ q,
                       const float* __restrict__ x,
                       const float* __restrict__ bw2,
                       const float* __restrict__ s,
                       const float* __restrict__ g,
                       const float* __restrict__ c_in,
                       const int* __restrict__ order,
                       const int* __restrict__ count,
                       float* __restrict__ dx, int n, int d) {
  if (kFull) d = DP;  // a constant from here on
  constexpr int kITileFloats = itile_floats<DP>();
  extern __shared__ __align__(16) float smem[];
  float* xf = smem;                    // [kJRows * DP] A fragments of x
  float* ring = smem + kJRows * DP;    // [2] x {q, g tiles, rs, rs2, cs2}

  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kJRows;
  const size_t base = (size_t)b * n;
  const int* ord = order + base;
  const int cnt = count[b];
  const float inv_bw2 = 1.0f / bw2[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ntiles = (cnt + kITile - 1) / kITile;

  auto stage = [&](int tile) {
    float* qs = ring + (tile & 1) * kITileFloats;
    float* gs = qs + kITile * DP;
    float* st = gs + kITile * DP;
    const int i0 = tile * kITile;
    auto live_row = [&](int r) { return i0 + r < cnt ? ord[i0 + r] : -1; };
    stage_rows<DP>(qs, q + base * d, d, kITile, live_row);
    stage_rows<DP>(gs, g + base * d, d, kITile, live_row);
    cp_async_commit();
    // 1 / s, 1 / (s b^2), c / (s b^2); zeros past count make t = K / s = 0
    for (int r = threadIdx.x; r < kITile; r += blockDim.x) {
      const int row = live_row(r);
      float rs = 0.0f, rs2 = 0.0f, cs2 = 0.0f;
      if (row >= 0) {
        const float sv = s[base + row];
        rs = 1.0f / sv;
        rs2 = inv_bw2 / sv;
        cs2 = c_in[base + row] * rs2;
      }
      st[r] = rs;
      st[kITile + r] = rs2;
      st[2 * kITile + r] = cs2;
    }
  };
  if (ntiles > 0) stage(0);
  load_frag_rows<DP>(xf, x + base * d, d, kJRows,
                 [&](int r) { return j0 + r < n ? j0 + r : -1; });
  const float4* xw =
      reinterpret_cast<const float4*>(xf) + warp * (DP / 8) * 32;

  float acc[DP / 8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it visible to all
    const float* qs = ring + (it & 1) * kITileFloats;
    const float* gs = qs + kITile * DP;
    const float* st = gs + kITile * DP;

    // sim = x q^T and <g, x> = x g^T: 16 rows j x 32 rows i a warp.
    float sim[kITile / 8][4] = {}, gx[kITile / 8][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      FragA a;
      a.set(xw[kk * 32 + lane]);
      FragB bq[kITile / 8], bg[kITile / 8];
#pragma unroll
      for (int nt = 0; nt < kITile / 8; ++nt) {
        bq[nt] = frag_bt<DP>(qs, nt * 8, kk, grp, tig);
        bg[nt] = frag_bt<DP>(gs, nt * 8, kk, grp, tig);
      }
      float ps[kITile / 8][4], pg[kITile / 8][4];
      mma_3xtf32_row<kITile / 8, true>(ps, a, bq);
      mma_3xtf32_row<kITile / 8, true>(pg, a, bg);
      add_to(sim, ps);
      add_to(gx, pg);
    }
    // t in place of <g, x>, and K / s
    float w[kITile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kITile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = nt * 8 + 2 * tig + (r & 1);
        bool inside;
        const float K = kernel_value(sim[nt][r] - 1.0f, inv_bw2, inside);
        gx[nt][r] = inside ? K * (gx[nt][r] * st[kITile + i]
                                  - st[2 * kITile + i]) : 0.0f;
        w[nt][r] = K * st[i];
      }
    // acc += t^T q + (K / s)^T g, k over the tile's live rows, this
    // tile's sum first
#pragma unroll
    for (int half = 0; half < Width<DP>::kHalves; ++half) {
      float part[Width<DP>::kHalfNT][4];
#pragma unroll
      for (int ks = 0; ks < kITile / 8; ++ks) {
        FragA at, aw;
        at.from_c(gx[ks]);
        aw.from_c(w[ks]);
        if (ks == 0)
          mma_3xtf32_half<DP, true>(part, at, qs, 0, half, grp, tig);
        else
          mma_3xtf32_half<DP>(part, at, qs, ks * 8, half, grp, tig);
        mma_3xtf32_half<DP>(part, aw, gs, ks * 8, half, grp, tig);
      }
      add_to(acc + Width<DP>::kHalfNT * half, part);
    }
    __syncthreads();  // tile it consumed before its stage is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = j0 + warp * 16 + grp + 8 * h;
    if (row >= n) continue;
    float* out = dx + (base + row) * d;
#pragma unroll
    for (int p = 0; p < DP / 16; ++p)
      store_cols(out, 16 * p + 4 * tig, pair_row<DP>(acc, p, h, 1.0f), d);
  }
}

template <int DP, bool kFull>
int launch(const float* q, const float* x, const float* bw2, const float* m,
           const float* s, const float* g, const int* order, const int* count,
           float* c, float* dq, float* dx, int b, int n, int d,
           cudaStream_t st) {
  constexpr size_t kRowsSmem = rows_smem_bytes<DP>();
  constexpr size_t kColsSmem = cols_smem_bytes<DP>();
  cudaFuncSetAttribute(ms_bwd_rows_kernel<DP, kFull>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRowsSmem);
  cudaFuncSetAttribute(ms_bwd_cols_kernel<DP, kFull>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kColsSmem);
  ms_bwd_rows_kernel<DP, kFull>
      <<<dim3((n + kSlots - 1) / kSlots, b), kRowThreads, kRowsSmem, st>>>(
          q, x, bw2, m, s, g, order, count, c, dq, n, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ms_bwd_cols_kernel<DP, kFull>
      <<<dim3((n + kJRows - 1) / kJRows, b), kColThreads, kColsSmem, st>>>(
          q, x, bw2, s, g, c, order, count, dx, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, x, m, g [b, n, d] f32, bw2 [b] f32, s [b, n] f32, order [b, n] int32
// (a permutation of each shape's rows: the live rows of g, those with a
// nonzero entry, first in ascending id) and count [b] int32 (how many are
// live) -> dq, dx [b, n, d] f32; c [b, n] f32 is scratch (<g_i, m_i> of the
// live rows, written by the first pass, read by the second).  dp is the
// padded width (32, 64 or 128, at least d).  Rows of order past count must
// have g = 0.
PRIFIT_API int mean_shift_backward(const void* q, const void* x,
                                   const void* bw2, const void* m,
                                   const void* s, const void* g,
                                   const void* order, const void* count,
                                   void* c, void* dq, void* dx, int b, int n,
                                   int d, int dp, void* stream) {
  return with_width(d, dp, [&](auto w, auto full) {
    return launch<decltype(w)::value, decltype(full)::value>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const float*>(bw2), static_cast<const float*>(m),
        static_cast<const float*>(s), static_cast<const float*>(g),
        static_cast<const int*>(order), static_cast<const int*>(count),
        static_cast<float*>(c), static_cast<float*>(dq),
        static_cast<float*>(dx), b, n, d, static_cast<cudaStream_t>(stream));
  });
}
