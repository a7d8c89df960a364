// One Gaussian mean-shift step, flash-style: nothing [n, n] is stored.
//
//   K_ij = exp(clip((<q_i, x_j> - 1) / b^2, -13, 75))
//   s_i  = sum_j K_ij,   m_i = (sum_j K_ij x_j) * (1 / s_i)
//
// Replaces the forward TPU kernel prifit_tpu/ops/pallas/mean_shift.py::
// _fwd_kernel (_pallas_fwd, reached through mean_shift_step_pallas).  The
// renormalization of m stays outside, in PyTorch, as in the JAX package.
// Unlike the TPU kernel (bf16 operands), both products are full f32.
//
// Bound on the H100: operations, 4 n^2 D flops per shape (two products) at
// the f32 rate, plus n^2 exponentials.  A block owns 32 query rows of one
// shape and walks over X in 32-row tiles staged in shared memory.  Each warp
// computes the 4 x 32 kernel values of its own 4 rows, keeps them in shared
// memory for itself only (no block barrier between the two products), then
// accumulates its 4 rows x 128 columns of K X in registers, 16 a thread.
// No running maximum is needed: for unit vectors the exponent is at most 0,
// and it is clipped at 75 anyway.
#include "common.cuh"

namespace {

constexpr int kMsRows = 32;
constexpr int kMsTile = 32;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kMsRows / kWarps;  // 4
// kT row stride: +4 keeps float4 alignment and spreads a warp's 32 stores of
// one row set over 8 banks instead of 1.
constexpr int kKStride = kMsRows + 4;
constexpr float kClampLo = -13.0f;
constexpr float kClampHi = 75.0f;

__global__ void __launch_bounds__(kThreads)
    mean_shift_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ x,
                          const float* __restrict__ bw2,
                          float* __restrict__ m, float* __restrict__ s_out,
                          int n) {
  __shared__ float qT[kD * kMsRows];                    // 16 KB
  __shared__ float xs[kMsTile * (kD + 1)];              // 16.1 KB
  __shared__ __align__(16) float kT[kMsTile * kKStride];  // 4.5 KB, kT[c][r]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kMsRows;
  const float* qb = q + (size_t)b * n * kD;
  const float* xb = x + (size_t)b * n * kD;
  const float inv_bw2 = 1.0f / bw2[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kRowsPerWarp;

  for (int t = threadIdx.x; t < kMsRows * kD; t += blockDim.x) {
    const int r = t / kD, d = t % kD;
    qT[d * kMsRows + r] = qb[(size_t)(row0 + r) * kD + d];
  }

  float acc[kRowsPerWarp][4];
  float s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    s[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int col0 = 0; col0 < n; col0 += kMsTile) {
    __syncthreads();  // qT written / previous tile consumed
    load_rows_padded(xb, col0, kMsTile, xs);
    __syncthreads();

    // K for this warp's 4 rows against tile column `lane`.
    float sim[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sim[i] = 0.0f;
    const float* xc = xs + lane * (kD + 1);
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float xv = xc[d];
      const float* qd = qT + d * kMsRows + r0;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) sim[i] = fmaf(qd[i], xv, sim[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float e = fminf(fmaxf((sim[i] - 1.0f) * inv_bw2, kClampLo), kClampHi);
      kT[lane * kKStride + r0 + i] = expf(e);
    }
    __syncwarp();

    // acc[i][j] += sum_c K[r0 + i][c] * x[c][lane + 32 j]
#pragma unroll 4
    for (int c = 0; c < kMsTile; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(kT + c * kKStride + r0);
      const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
      const float* xr = xs + c * (kD + 1) + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] += kk[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kk[i], xr[32 * j], acc[i][j]);
      }
    }
    __syncwarp();  // kT of this warp consumed before the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + r0 + i;
    const float inv = 1.0f / s[i];
    float* mrow = m + ((size_t)b * n + row) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) mrow[lane + 32 * j] = acc[i][j] * inv;
    if (lane == 0) s_out[(size_t)b * n + row] = s[i];
  }
}

}  // namespace

// q, x [b, n, 128] f32, bw2 [b] f32 -> m [b, n, 128] f32, s [b, n] f32.
// n must be a multiple of 32.
PRIFIT_API int mean_shift_forward(const void* q, const void* x,
                                  const void* bw2, void* m, void* s, int b,
                                  int n, void* stream) {
  dim3 grid(n / kMsRows, b);
  mean_shift_fwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(bw2), static_cast<float*>(m),
      static_cast<float*>(s), n);
  return (int)cudaGetLastError();
}
