// The three distance-dependent passes of mode NMS, recomputing distance rows
// per row tile so that no [n, n] matrix is ever stored.
//
//   counts:  assign_i = argmin_j d_ij;            counts[assign_i] += 1
//   centers: for occupied i (counts_i > 0),
//            rep_i = argmax_j [d_ij < bw] counts_j;  is_center[rep_i] = 1
//   used:    label_i = argmin_j (is_center_j ? d_ij : inf);  used[label_i] = 1
//
// with d_ij = 2 - 2 <m_i, m_j>.  bw is compared UNSQUARED against the squared
// distance, a quirk of the reference kept on purpose.  Every arg-reduction
// takes the lowest index on ties, as jnp.argmin / jnp.argmax do.
//
// Replaces the TPU kernels prifit_tpu/ops/pallas/nms.py::_counts_kernel,
// _rep_kernel and _used_kernel (nms_passes_pallas).  Unlike those (bf16
// operands), the distances here are full f32.
//
// Bound on the H100: operations, 2 n^2 D flops per pass per shape at the f32
// rate to rebuild the distance rows.  A block owns 16 rows: their distance
// rows go to shared memory (common.cuh chordal_rows), then each warp reduces
// two rows.  Counts use integer atomics (exact, order-free); is_center and
// used are plain stores of 1, so concurrent writers agree.
#include "common.cuh"

namespace {

constexpr int kRows = 16;

__global__ void __launch_bounds__(kThreads)
    nms_counts_kernel(const float* __restrict__ modes, int* __restrict__ counts,
                      int n) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* xs = qT + kD * kRows;
  float* dist = xs + kTile * (kD + 1);
  const int b = blockIdx.y, row0 = blockIdx.x * kRows;
  chordal_rows<kRows>(modes + (size_t)b * n * kD, row0, n, qT, xs, dist);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const float* drow = dist + rr * n;
    float v = INFINITY;
    int i = n;
    for (int j = lane; j < n; j += 32) merge_min(v, i, drow[j], j);
    warp_argmin(v, i);
    if (lane == 0) atomicAdd(counts + (size_t)b * n + i, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    nms_centers_kernel(const float* __restrict__ modes,
                       const int* __restrict__ counts,
                       const float* __restrict__ bw,
                       int* __restrict__ is_center, int n) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* xs = qT + kD * kRows;
  float* dist = xs + kTile * (kD + 1);
  const int b = blockIdx.y, row0 = blockIdx.x * kRows;
  chordal_rows<kRows>(modes + (size_t)b * n * kD, row0, n, qT, xs, dist);

  const int* cnt = counts + (size_t)b * n;
  const float bwb = bw[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    if (cnt[row0 + rr] == 0) continue;  // warp-uniform: only occupied modes vote
    const float* drow = dist + rr * n;
    float v = -INFINITY;
    int i = n;
    for (int j = lane; j < n; j += 32)
      merge_max(v, i, drow[j] < bwb ? (float)cnt[j] : 0.0f, j);
    warp_argmax(v, i);
    if (lane == 0) is_center[(size_t)b * n + i] = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
    nms_used_kernel(const float* __restrict__ modes,
                    const int* __restrict__ is_center, int* __restrict__ used,
                    int n) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* xs = qT + kD * kRows;
  float* dist = xs + kTile * (kD + 1);
  const int b = blockIdx.y, row0 = blockIdx.x * kRows;
  chordal_rows<kRows>(modes + (size_t)b * n * kD, row0, n, qT, xs, dist);

  const int* isc = is_center + (size_t)b * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const float* drow = dist + rr * n;
    float v = INFINITY;
    int i = n;
    for (int j = lane; j < n; j += 32)
      merge_min(v, i, isc[j] ? drow[j] : INFINITY, j);
    warp_argmin(v, i);
    if (lane == 0) used[(size_t)b * n + i] = 1;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// modes [b, n, 128] f32 unit rows; n a multiple of 64.  Outputs are i32
// [b, n] and must be zeroed by the caller.
PRIFIT_API int nms_counts(const void* modes, void* counts, int b, int n,
                          void* stream) {
  const size_t smem = chordal_smem_bytes<kRows>(n);
  prepare(nms_counts_kernel, smem);
  nms_counts_kernel<<<dim3(n / kRows, b), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(modes), static_cast<int*>(counts), n);
  return (int)cudaGetLastError();
}

PRIFIT_API int nms_centers(const void* modes, const void* counts,
                           const void* bw, void* is_center, int b, int n,
                           void* stream) {
  const size_t smem = chordal_smem_bytes<kRows>(n);
  prepare(nms_centers_kernel, smem);
  nms_centers_kernel<<<dim3(n / kRows, b), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(modes), static_cast<const int*>(counts),
      static_cast<const float*>(bw), static_cast<int*>(is_center), n);
  return (int)cudaGetLastError();
}

PRIFIT_API int nms_used(const void* modes, const void* is_center, void* used,
                        int b, int n, void* stream) {
  const size_t smem = chordal_smem_bytes<kRows>(n);
  prepare(nms_used_kernel, smem);
  nms_used_kernel<<<dim3(n / kRows, b), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(modes), static_cast<const int*>(is_center),
      static_cast<int*>(used), n);
  return (int)cudaGetLastError();
}
