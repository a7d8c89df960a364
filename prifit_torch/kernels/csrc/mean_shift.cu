// One Gaussian mean-shift step, flash-style on the tensor cores: nothing
// [n, n] is stored.
//
//   K_ij = exp(clip((<q_i, x_j> - 1) / b^2, -13, 75))
//   s_i  = sum_j K_ij,   m_i = (sum_j K_ij x_j) * (1 / s_i)
//
// Replaces the forward TPU kernel prifit_tpu/ops/pallas/mean_shift.py::
// _fwd_kernel (_pallas_fwd, reached through mean_shift_step_pallas).  The
// renormalization of m stays outside, in PyTorch, as in the JAX package.
//
// Bound on the H100: operations, two products of 2 n^2 D flops a shape plus
// n^2 exponentials.  Both products run on the tensor cores in 3xTF32
// (tf32_mma.cuh: three TF32 products each, about f32 accuracy; the TPU
// kernel's single bf16 pass would miss the port's f32 limits), so the bound
// is 3 x 4 n^2 D flops at the TF32 rate (3.14 ms for the 10 launches of a
// forward at b = 24, n = 2048).
//
// A block of 4 warps owns 64 query rows of one shape, 16 a warp, held in
// shared memory as f32 A fragments and split into hi and lo as they are
// read.  It streams X in 64-row tiles through a two-stage cp.async ring, so
// the next tile's copy overlaps this tile's products.  Per tile a warp
// computes S = Q X^T (16 x 64), P = exp(clip((S - 1) / b^2)) in registers,
// adds P's row sums to s and P X to its 16 x 128 f32 accumulator; P feeds
// the second product straight from the first one's accumulator fragments
// (tf32_mma.cuh).  No running maximum is needed: for unit vectors the
// exponent is at most 0, and it is clipped at 75 anyway.
//
// Any width d <= 128 and any n: rows are held padded with zeros to DP (32,
// 64 or 128, the kernel's template width; tf32_mma.cuh), and m gets only
// its d columns.  Rows and columns past n are zeros in shared memory, P is
// set to exactly 0 in the columns past n (a zero row would give
// exp(clip(-1 / b^2)) > 0), and rows past n write nothing.
#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 64;                 // query rows a block owns
constexpr int kCols = 64;                 // X rows per streamed tile
constexpr int kWarpsF = kRows / 16;       // 4
constexpr int kThreadsF = 32 * kWarpsF;
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * DP + 2 * kCols * DP);
}

template <int DP, bool kFull>
__global__ void __launch_bounds__(kThreadsF, 2)
    mean_shift_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ x,
                          const float* __restrict__ bw2,
                          float* __restrict__ m, float* __restrict__ s_out,
                          int n, int d) {
  if (kFull) d = DP;  // a constant from here on
  constexpr int kTileFloats = kCols * DP;
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                 // [kRows * DP] A fragments of q
  float* xs = smem + kRows * DP;    // [2][kCols][DP] tiles of x

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const float* qb = q + (size_t)b * n * d;
  const float* xb = x + (size_t)b * n * d;
  const float inv_bw2 = 1.0f / bw2[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ntiles = (n + kCols - 1) / kCols;

  auto stage = [&](int tile) {
    const int col0 = tile * kCols;
    stage_rows<DP>(xs + (tile & 1) * kTileFloats, xb, d, kCols,
               [&](int r) { return col0 + r < n ? col0 + r : -1; });
    cp_async_commit();
  };
  stage(0);
  load_frag_rows<DP>(qf, qb, d, kRows,
                 [&](int r) { return row0 + r < n ? row0 + r : -1; });
  const float4* qw =
      reinterpret_cast<const float4*>(qf) + warp * (DP / 8) * 32;

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float srow[2] = {0.0f, 0.0f};  // rows grp, grp + 8: this thread's columns

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and the q fragments) visible to all
    const float* xt = xs + (it & 1) * kTileFloats;

    // S = Q X^T: 16 rows x 64 columns, 8 n-tiles.
    float sc[kCols / 8][4];
#pragma unroll
    for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      FragA a;
      a.set(qw[kk * 32 + lane]);
      FragB bx[kCols / 8];
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
        bx[nt] = frag_bt<DP>(xt, nt * 8, kk, grp, tig);
      mma_3xtf32_row<kCols / 8>(sc, a, bx);
    }

    // P in place of S; its row sums.
    const int col0 = it * kCols;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = col0 + nt * 8 + 2 * tig + (r & 1);
        bool inside;
        const float p = kernel_value(sc[nt][r] - 1.0f, inv_bw2, inside);
        sc[nt][r] = col < n ? p : 0.0f;
        srow[r >> 1] += sc[nt][r];
      }

    // acc += P X: k over the tile's 64 rows (8 steps), n over DP / 8 tiles.
#pragma unroll
    for (int ks = 0; ks < kCols / 8; ++ks) {
      FragA a;
      a.from_c(sc[ks]);
      mma_3xtf32_rows_of<DP>(acc, a, xt, ks * 8, grp, tig);
    }
    __syncthreads();  // tile it consumed before its stage is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    srow[h] += __shfl_xor_sync(0xffffffffu, srow[h], 1);
    srow[h] += __shfl_xor_sync(0xffffffffu, srow[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + grp + 8 * h;
    if (row >= n) continue;
    const float inv = 1.0f / srow[h];
    float* mrow = m + ((size_t)b * n + row) * d;
#pragma unroll
    for (int p = 0; p < DP / 16; ++p)
      store_cols(mrow, 16 * p + 4 * tig, pair_row<DP>(acc, p, h, inv), d);
    if (tig == 0) s_out[(size_t)b * n + row] = srow[h];
  }
}

template <int DP, bool kFull>
int launch(const float* q, const float* x, const float* bw2, float* m,
           float* s, int b, int n, int d, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<DP>();
  cudaFuncSetAttribute(mean_shift_fwd_kernel<DP, kFull>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kSmem);
  dim3 grid((n + kRows - 1) / kRows, b);
  mean_shift_fwd_kernel<DP, kFull><<<grid, kThreadsF, kSmem, stream>>>(
      q, x, bw2, m, s, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, x [b, n, d] f32, bw2 [b] f32 -> m [b, n, d] f32, s [b, n] f32, with
// dp the padded width (32, 64 or 128, at least d).
PRIFIT_API int mean_shift_forward(const void* q, const void* x,
                                  const void* bw2, void* m, void* s, int b,
                                  int n, int d, int dp, void* stream) {
  return with_width(d, dp, [&](auto w, auto full) {
    return launch<decltype(w)::value, decltype(full)::value>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const float*>(bw2), static_cast<float*>(m),
        static_cast<float*>(s), b, n, d, static_cast<cudaStream_t>(stream));
  });
}
