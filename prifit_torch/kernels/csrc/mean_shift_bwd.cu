// Backward of one Gaussian mean-shift step (mean_shift.cu), in two passes:
// nothing [n, n] is stored and no atomics are used.
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
// sums go to two kernels, as in a flash-attention backward:
//   1. rows pass: a block owns 32 rows i of one shape and walks over x in
//      32-row tiles.  It recomputes K and <g_i, x_j>, accumulates dq in
//      registers, and writes c_i for the second pass.
//   2. columns pass: a block owns 32 rows j of x and walks over q and g in
//      32-row tiles, with each tile's 1/s_i and c_i/(s_i b^2) read once.  It
//      recomputes K and <g_i, x_j> and accumulates dx in registers.
// Each warp owns 4 of the block's rows; the 4 x 32 values of t (and K/s) it
// needs go through shared memory that only it touches, so no block barrier
// sits between the products, as in the forward kernel.  Operands are f32 like
// the forward kernel's (the TPU kernel's are bf16).
//
// Bound on the H100: operations.  Counted as 10 n^2 D flops per shape and
// launch (the two forward products and the three backward ones) plus n^2
// exponentials: 128.8 GFLOP at b = 24, n = 2048, D = 128, so 1.92 ms at
// 67 TFLOP/s f32.  This simple version recomputes both forward products in
// each pass, 14 n^2 D flops in all, on the f32 pipes.
#include "common.cuh"

namespace {

constexpr int kBlockRows = 32;                       // rows a block owns
constexpr int kStream = 32;                          // rows per streamed tile
constexpr int kWarps = kThreads / 32;                // 8
constexpr int kRowsPerWarp = kBlockRows / kWarps;    // 4
constexpr int kStride = kBlockRows + 4;  // t row stride, keeps float4 aligned
constexpr int kPadded = kD + 1;          // padded tile row: 32 lanes, 32 banks
constexpr float kClampLo = -13.0f;
constexpr float kClampHi = 75.0f;

static_assert(kRowsPerWarp == 4, "the float4 reads assume 4 rows a warp");

// K_ij and whether its exponent lies strictly inside the clip range (the
// gradient cutoff of guard_exp).
__device__ __forceinline__ float kernel_value(float sim, float inv_bw2,
                                              bool& live) {
  const float e = (sim - 1.0f) * inv_bw2;
  live = e > kClampLo && e < kClampHi;
  return expf(fminf(fmaxf(e, kClampLo), kClampHi));
}

// dst[d * kBlockRows + r] = src[(row0 + r) * kD + d] for r < kBlockRows.
__device__ __forceinline__ void load_transposed(const float* __restrict__ src,
                                                int row0,
                                                float* __restrict__ dst) {
  for (int t = threadIdx.x; t < kBlockRows * kD; t += blockDim.x) {
    const int r = t / kD, d = t % kD;
    dst[d * kBlockRows + r] = src[(size_t)(row0 + r) * kD + d];
  }
}

constexpr size_t kRowsSmem =
    sizeof(float) * (2 * kD * kBlockRows + kStream * kPadded +
                     kStream * kStride);

__global__ void __launch_bounds__(kThreads)
    ms_bwd_rows_kernel(const float* __restrict__ q,
                       const float* __restrict__ x,
                       const float* __restrict__ bw2,
                       const float* __restrict__ m,
                       const float* __restrict__ s,
                       const float* __restrict__ g,
                       float* __restrict__ c_out, float* __restrict__ dq,
                       int n) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                       // [kD][32] this block's q rows
  float* gT = qT + kD * kBlockRows;       // [kD][32] this block's g rows
  float* xs = gT + kD * kBlockRows;       // [32][kD + 1] tile of x
  float* tT = xs + kStream * kPadded;     // [32 tile rows][kStride]: t[r][c]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBlockRows;
  const size_t base = (size_t)b * n;
  const float* xb = x + base * kD;
  const float inv_bw2 = 1.0f / bw2[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kRowsPerWarp;

  load_transposed(q + base * kD, row0, qT);
  load_transposed(g + base * kD, row0, gT);

  // Row statistics of this warp's rows: 1 / (s b^2) and c / (s b^2).
  float rs2[kRowsPerWarp], cs2[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const size_t row = base + row0 + r0 + i;
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < kD / 32; ++k)
      c = fmaf(g[row * kD + lane + 32 * k], m[row * kD + lane + 32 * k], c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0) c_out[row] = c;
    rs2[i] = inv_bw2 / s[row];
    cs2[i] = c * rs2[i];
  }

  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

  for (int col0 = 0; col0 < n; col0 += kStream) {
    __syncthreads();  // qT, gT written / previous tile consumed
    load_rows_padded(xb, col0, kStream, xs);
    __syncthreads();

    // sim and <g, x> of this warp's 4 rows against tile row `lane`.
    float sim[kRowsPerWarp], gx[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sim[i] = gx[i] = 0.0f;
    const float* xc = xs + lane * kPadded;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float xv = xc[d];
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * kBlockRows + r0);
      const float4 gv = *reinterpret_cast<const float4*>(gT + d * kBlockRows + r0);
      sim[0] = fmaf(qv.x, xv, sim[0]);
      sim[1] = fmaf(qv.y, xv, sim[1]);
      sim[2] = fmaf(qv.z, xv, sim[2]);
      sim[3] = fmaf(qv.w, xv, sim[3]);
      gx[0] = fmaf(gv.x, xv, gx[0]);
      gx[1] = fmaf(gv.y, xv, gx[1]);
      gx[2] = fmaf(gv.z, xv, gx[2]);
      gx[3] = fmaf(gv.w, xv, gx[3]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool live;
      const float K = kernel_value(sim[i], inv_bw2, live);
      tT[lane * kStride + r0 + i] = live ? K * (gx[i] * rs2[i] - cs2[i]) : 0.0f;
    }
    __syncwarp();

    // acc[i][k] += sum_c t[r0 + i][c] * x[c][lane + 32 k]
#pragma unroll 4
    for (int c = 0; c < kStream; ++c) {
      const float4 tv = *reinterpret_cast<const float4*>(tT + c * kStride + r0);
      const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
      const float* xr = xs + c * kPadded + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(tt[i], xr[32 * k], acc[i][k]);
    }
    __syncwarp();  // this warp's t consumed before the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float* out = dq + (base + row0 + r0 + i) * kD;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[lane + 32 * k] = acc[i][k];
  }
}

constexpr size_t kColsSmem =
    sizeof(float) * (kD * kBlockRows + 2 * kStream * kPadded +
                     2 * kStream * kStride + 3 * kStream);

__global__ void __launch_bounds__(kThreads)
    ms_bwd_cols_kernel(const float* __restrict__ q,
                       const float* __restrict__ x,
                       const float* __restrict__ bw2,
                       const float* __restrict__ s,
                       const float* __restrict__ g,
                       const float* __restrict__ c_in,
                       float* __restrict__ dx, int n) {
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;                      // [kD][32] this block's x rows
  float* qs = xT + kD * kBlockRows;      // [32][kD + 1] tile of q
  float* gs = qs + kStream * kPadded;    // [32][kD + 1] tile of g
  float* tT = gs + kStream * kPadded;    // [32 tile rows][kStride]: t[i][j]
  float* wT = tT + kStream * kStride;    // [32 tile rows][kStride]: K/s
  float* rs = wT + kStream * kStride;    // [32] 1 / s_i of the tile
  float* rs2 = rs + kStream;             // [32] 1 / (s_i b^2)
  float* cs2 = rs2 + kStream;            // [32] c_i / (s_i b^2)

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * kBlockRows;
  const size_t base = (size_t)b * n;
  const float* qb = q + base * kD;
  const float* gb = g + base * kD;
  const float inv_bw2 = 1.0f / bw2[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = warp * kRowsPerWarp;

  load_transposed(x + base * kD, col0, xT);

  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  for (int i0 = 0; i0 < n; i0 += kStream) {
    __syncthreads();  // xT written / previous tile consumed
    load_rows_padded(qb, i0, kStream, qs);
    load_rows_padded(gb, i0, kStream, gs);
    if (threadIdx.x < kStream) {
      const size_t row = base + i0 + threadIdx.x;
      const float r = 1.0f / s[row];
      rs[threadIdx.x] = r;
      rs2[threadIdx.x] = inv_bw2 / s[row];
      cs2[threadIdx.x] = c_in[row] * (inv_bw2 / s[row]);
    }
    __syncthreads();

    // sim and <g, x> of tile row `lane` against this warp's 4 x rows.
    float sim[kRowsPerWarp], gx[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) sim[j] = gx[j] = 0.0f;
    const float* qr = qs + lane * kPadded;
    const float* gr = gs + lane * kPadded;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float qv = qr[d], gv = gr[d];
      const float4 xv = *reinterpret_cast<const float4*>(xT + d * kBlockRows + c0);
      sim[0] = fmaf(qv, xv.x, sim[0]);
      sim[1] = fmaf(qv, xv.y, sim[1]);
      sim[2] = fmaf(qv, xv.z, sim[2]);
      sim[3] = fmaf(qv, xv.w, sim[3]);
      gx[0] = fmaf(gv, xv.x, gx[0]);
      gx[1] = fmaf(gv, xv.y, gx[1]);
      gx[2] = fmaf(gv, xv.z, gx[2]);
      gx[3] = fmaf(gv, xv.w, gx[3]);
    }
    const float r_s = rs[lane], r_s2 = rs2[lane], c_s2 = cs2[lane];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      bool live;
      const float K = kernel_value(sim[j], inv_bw2, live);
      tT[lane * kStride + c0 + j] = live ? K * (gx[j] * r_s2 - c_s2) : 0.0f;
      wT[lane * kStride + c0 + j] = K * r_s;
    }
    __syncwarp();

    // acc[j][k] += sum_i t[i][c0 + j] q[i][lane + 32 k]
    //                   + (K/s)[i][c0 + j] g[i][lane + 32 k]
#pragma unroll 2
    for (int i = 0; i < kStream; ++i) {
      const float4 tv = *reinterpret_cast<const float4*>(tT + i * kStride + c0);
      const float4 wv = *reinterpret_cast<const float4*>(wT + i * kStride + c0);
      const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
      const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
      const float* qrow = qs + i * kPadded + lane;
      const float* grow = gs + i * kPadded + lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float qv = qrow[32 * k], gv = grow[32 * k];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j)
          acc[j][k] = fmaf(tt[j], qv, fmaf(ww[j], gv, acc[j][k]));
      }
    }
    __syncwarp();  // this warp's t and K/s consumed before the next tile
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    float* out = dx + (base + col0 + c0 + j) * kD;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[lane + 32 * k] = acc[j][k];
  }
}

}  // namespace

// q, x, m, g [b, n, 128] f32, bw2 [b] f32, s [b, n] f32 -> dq, dx
// [b, n, 128] f32; c [b, n] f32 is scratch (<g_i, m_i>, written by the first
// pass, read by the second).  n must be a multiple of 32.
PRIFIT_API int mean_shift_backward(const void* q, const void* x,
                                   const void* bw2, const void* m,
                                   const void* s, const void* g, void* c,
                                   void* dq, void* dx, int b, int n,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(ms_bwd_rows_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRowsSmem);
  cudaFuncSetAttribute(ms_bwd_cols_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kColsSmem);
  const dim3 grid(n / kBlockRows, b);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bw2);
  const float* sf = static_cast<const float*>(s);
  const float* gf = static_cast<const float*>(g);
  ms_bwd_rows_kernel<<<grid, kThreads, kRowsSmem, st>>>(
      qf, xf, bf, static_cast<const float*>(m), sf, gf,
      static_cast<float*>(c), static_cast<float*>(dq), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ms_bwd_cols_kernel<<<grid, kThreads, kColsSmem, st>>>(
      qf, xf, bf, sf, gf, static_cast<const float*>(c),
      static_cast<float*>(dx), n);
  return (int)cudaGetLastError();
}
