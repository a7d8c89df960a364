// Helpers shared by the port's CUDA kernels.  Each .cu file is built on its
// own into a shared library with a plain C interface (kernels/build.py) and
// includes this header once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PRIFIT_API extern "C" __attribute__((visibility("default")))

// Lets the Python wrapper name the error a launch returned.
PRIFIT_API const char* prifit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (value, index) merges with a total order: ties go to the LOWER index, as
// jnp.argmax / jnp.argmin (first occurrence) do.  Being a total order makes
// the butterfly reductions below leave the same answer in every lane.
__device__ __forceinline__ void merge_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void merge_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    merge_max(v, i, ov, oi);
  }
}

// ---------------------------------------------------------------------------
// Distance rows of the bandwidth kernel.
//
// The embeddings are [n, kD] f32 unit vectors.  A block owns ROWS query rows
// and writes dist[r][j] = 2 - 2 <x_{row0+r}, x_j> for every j into shared
// memory, in full f32 (fmaf over d = 0..kD-1 in order, the same order for
// every (r, j), so exact-duplicate rows get bit-identical distances).
//
// Shared layout: qT[kD][ROWS] (query rows, transposed so a warp reads one
// broadcast vector per d), xs[kTile][kD + 1] (a tile of X; the +1 pad puts
// the 32 lanes' columns in 32 distinct banks), dist[ROWS][n].
constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kTile = 64;

// xs[r][*] = x[row0 + r][*] for r < nrows (float4 global loads).
__device__ __forceinline__ void load_rows_padded(const float* __restrict__ x,
                                                 int row0, int nrows,
                                                 float* __restrict__ xs) {
  constexpr int kV = kD / 4;
  for (int t = threadIdx.x; t < nrows * kV; t += blockDim.x) {
    const int r = t / kV, c4 = t % kV;
    const float4 v =
        reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * kD)[c4];
    float* dst = xs + r * (kD + 1) + c4 * 4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

template <int ROWS>
__device__ void chordal_rows(const float* __restrict__ x, int row0, int n,
                             float* __restrict__ qT, float* __restrict__ xs,
                             float* __restrict__ dist) {
  static_assert(ROWS * kTile % kThreads == 0, "tile does not split evenly");
  constexpr int kRpt = ROWS * kTile / kThreads;  // rows per thread
  for (int t = threadIdx.x; t < ROWS * kD; t += blockDim.x) {
    const int r = t / kD, d = t % kD;
    qT[d * ROWS + r] = x[(size_t)(row0 + r) * kD + d];
  }
  const int c = threadIdx.x % kTile;
  const int rbase = (threadIdx.x / kTile) * kRpt;  // warp-uniform
  for (int col0 = 0; col0 < n; col0 += kTile) {
    __syncthreads();  // qT written / previous tile consumed
    load_rows_padded(x, col0, kTile, xs);
    __syncthreads();
    float acc[kRpt];
#pragma unroll
    for (int k = 0; k < kRpt; ++k) acc[k] = 0.0f;
    const float* xc = xs + c * (kD + 1);
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float xv = xc[d];
      const float* qd = qT + d * ROWS + rbase;
#pragma unroll
      for (int k = 0; k < kRpt; ++k) acc[k] = fmaf(qd[k], xv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kRpt; ++k)
      dist[(rbase + k) * n + col0 + c] = 2.0f - 2.0f * acc[k];
  }
  __syncthreads();
}

// Dynamic shared memory of a chordal_rows block.
template <int ROWS>
constexpr size_t chordal_smem_bytes(int n) {
  return sizeof(float) *
         ((size_t)kD * ROWS + (size_t)kTile * (kD + 1) + (size_t)ROWS * n);
}
