// Per-row K-th smallest squared chordal distance by counting bisection.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/bandwidth.py::_bw_kernel
// (kth_nn_distance_pallas).  Same algorithm as its oracle
// prifit_tpu/clustering/mean_shift.py::_kth_smallest_bisect: for each rank K,
// 24 halvings of [0, 4] keeping count(d <= mid) >= K, returning hi.  Unlike
// the TPU kernel (bf16 operands), the distances here are full f32.
//
// Bound on the H100: operations.  The distance rows cost 2 n^2 D flops per
// shape in f32 (no tensor-core path at f32); the bisection adds 24 n^2
// compares per rank.  The TPU kernel keeps a [512, n] distance tile in 16 MB
// of VMEM; a block here has at most 227 KB of shared memory, so a block owns
// 16 rows: their distance rows (16 x n f32, 128 KB at n = 2048) are computed
// once into shared memory from 64-row tiles of X, then each warp runs all
// the bisection steps for two rows with warp-reduced counts, with no further
// device-memory traffic.
#include "common.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kIters = 24;
constexpr int kMaxRanks = 4;

struct Ranks {
  int k[kMaxRanks];
};

__global__ void __launch_bounds__(kThreads)
    kth_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
               int num_ranks, Ranks ranks) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* xs = qT + kD * kRows;
  float* dist = xs + kTile * (kD + 1);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  chordal_rows<kRows>(x + (size_t)b * n * kD, row0, n, qT, xs, dist);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const float* drow = dist + rr * n;
    for (int c = 0; c < num_ranks; ++c) {
      const int K = ranks.k[c];
      float lo = 0.0f, hi = 4.0f;
      for (int it = 0; it < kIters; ++it) {
        const float mid = (lo + hi) / 2.0f;
        int cnt = 0;
        for (int j = lane; j < n; j += 32) cnt += drow[j] <= mid;
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (cnt >= K) {
          hi = mid;
        } else {
          lo = mid;
        }
      }
      if (lane == 0) out[((size_t)b * num_ranks + c) * n + row0 + rr] = hi;
    }
  }
}

}  // namespace

// x [b, n, 128] f32 unit rows -> out [b, num_ranks, n] f32.
// n must be a multiple of 64; 1 <= num_ranks <= 4.
PRIFIT_API int kth_nn_distance(const void* x, void* out, int b, int n,
                               int num_ranks, int k0, int k1, int k2, int k3,
                               void* stream) {
  Ranks ranks = {{k0, k1, k2, k3}};
  const size_t smem = chordal_smem_bytes<kRows>(n);
  cudaFuncSetAttribute(kth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(n / kRows, b);
  kth_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, num_ranks,
      ranks);
  return (int)cudaGetLastError();
}
