// Farthest point sampling, one block per shape.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/fps.py::_fps_kernel
// (farthest_point_sample_pallas).  Output is bit-identical to the serial
// scan of prifit_tpu/ops/sampling.py::farthest_point_sample and to the plain
// PyTorch version in kernels/fps.py: the squared distance is computed as
// (dx*dx + dy*dy) + dz*dz with explicitly rounded operations (no FMA
// contraction), the running minimum starts at 1e10, and every argmax takes
// the lowest index on ties.
//
// Bound on the H100: latency.  npoint steps are serially dependent and each
// is a 3-flop-per-point sweep plus a block-wide argmax, so the arithmetic
// (a few microseconds for the whole sample) is far below the cost of the
// npoint barrier round trips.  The design keeps the whole cloud and the
// running distances in shared memory (16 bytes a point) so a step touches no
// device memory, and uses two barriers a step: warp shuffles reduce inside
// each warp, then one warp reduces the per-warp winners.
#include "common.cuh"

namespace {

constexpr int kFpsThreads = 512;
constexpr int kFpsWarps = kFpsThreads / 32;

__global__ void __launch_bounds__(kFpsThreads)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ out, int n, int npoint) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* dist = pz + n;
  __shared__ float warp_v[kFpsWarps];
  __shared__ int warp_i[kFpsWarps];
  __shared__ int far_s;

  const int b = blockIdx.x;
  const float* p = xyz + (size_t)b * n * 3;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    px[j] = p[3 * j];
    py[j] = p[3 * j + 1];
    pz[j] = p[3 * j + 2];
    dist[j] = 1e10f;
  }
  if (threadIdx.x == 0) far_s = start[b];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* out_b = out + (size_t)b * npoint;
  for (int i = 0; i < npoint; ++i) {
    const int far = far_s;
    if (threadIdx.x == 0) out_b[i] = far;
    const float cx = px[far], cy = py[far], cz = pz[far];
    float bv = -INFINITY;
    int bi = n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[j], d);
      dist[j] = m;
      merge_max(bv, bi, m, j);
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kFpsWarps ? warp_v[lane] : -INFINITY;
      bi = lane < kFpsWarps ? warp_i[lane] : n;
      warp_argmax(bv, bi);
      if (lane == 0) far_s = bi;
    }
    __syncthreads();
  }
}

}  // namespace

// xyz [b, n, 3] f32, start [b] i32 -> out [b, npoint] i32.
PRIFIT_API int fps_forward(const void* xyz, const void* start, void* out,
                           int b, int n, int npoint, void* stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)n;
  cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fps_kernel<<<b, kFpsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(start),
      static_cast<int*>(out), n, npoint);
  return (int)cudaGetLastError();
}
