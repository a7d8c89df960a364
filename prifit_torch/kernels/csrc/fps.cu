// Farthest point sampling, one block per cloud, writing the sampled
// points' indices and their coordinates in one launch.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/fps.py::_fps_kernel
// (farthest_point_sample_pallas) and the gather of the centroids that
// follows it in the SA layer.  Output is bit-identical to the serial scan of
// prifit_tpu/ops/sampling.py::farthest_point_sample and to the plain PyTorch
// version in kernels/fps.py: the squared distance is (dx*dx + dy*dy) + dz*dz
// with explicitly rounded operations (no FMA contraction), the running
// minimum starts at 1e10, and every argmax takes the lowest index on ties.
// The coordinates written are the chosen point's, copied bit for bit.
//
// Bound on the H100: latency.  The npoint - 1 steps are serially dependent;
// each is a sweep of about 12 instructions a point and a block-wide argmax,
// so the arithmetic (a few microseconds for the whole sample) is far below
// the cost of the steps' dependent reductions and barrier.  The design
// shortens a step's critical path:
//
//  - Points and running minima live in registers.  Thread t of T owns the
//    points k*T + t for k < P (P a compile-time constant, so the sweep is
//    unrolled into independent registers).  The points past n hold a
//    running minimum of 0 and an index >= n: a real point's distance is
//    >= +0 and its index lower, so one of them always wins.  No shared copy
//    of the cloud.  A thread's maximum is a tree of fmaxf, and its lowest k
//    at that maximum a tree of integer minima, both log2(P) deep.
//  - Argmax without a shuffle ladder.  Distances are >= +0, so their f32
//    bits order as unsigned integers: a warp's maximum is one redux.sync,
//    and the lowest index at it one more.
//  - One barrier a step.  With 128 or 256 threads, every thread writes its
//    {distance, index} to entry[i & 1][t]; after one __syncthreads every
//    warp reads all T entries (T / 32 a lane, as float4s), reduces its
//    lane's share in registers and the warp's with the two redux.sync, so
//    every thread has the winner without a second barrier or a warp-level
//    reduction before it.  With 512 or 1024 threads (clouds over 4096
//    points) each warp first reduces its own 32 threads with the same two
//    redux.sync and writes one entry, so that each warp reads T / 32
//    entries, not T.  The double buffer makes one barrier enough: a thread
//    writes an entry set again two steps later, after a barrier that every
//    warp passes only once it has read that set.
//  - The winner's coordinates are one load from the cloud, which stays in
//    L1 (each block reads only its own cloud).
//  - Outputs off the critical path: thread 0 lists the chosen indices in
//    shared memory, and after the last step the block writes the indices
//    as int64 and gathers their coordinates, coalesced.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
constexpr int kMaxPerThread = 16;
// shared memory a block may use without opting in to more
constexpr int kDefaultSmem = 48 * 1024;

// entries a step exchanges: one a thread, or one a warp from 512 threads
template <int T>
constexpr int kEntries = T > 256 ? T / 32 : T;

// a step's entries, double-buffered; a lane reduces R consecutive ones (R =
// 4 or 8 from 128 or 256 threads; 1 from 512 or 1024, lanes past E idle)
template <int E>
struct Entries {
  static constexpr int R = E > 32 ? E / 32 : 1;
  float d[2][E > 32 ? E : 32];
  unsigned idx[2][E > 32 ? E : 32];

  __device__ __forceinline__ void read(int buf, int lane, float (&b)[R],
                                       unsigned (&ix)[R]) const {
    if constexpr (R == 1) {
      const bool real = lane < E;
      b[0] = real ? d[buf][lane] : 0.0f;
      ix[0] = real ? idx[buf][lane] : kNoIndex;
    } else {
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 vb = *reinterpret_cast<const float4*>(&d[buf][lane * R + r]);
        const uint4 vi = *reinterpret_cast<const uint4*>(&idx[buf][lane * R + r]);
        b[r] = vb.x, b[r + 1] = vb.y, b[r + 2] = vb.z, b[r + 3] = vb.w;
        ix[r] = vi.x, ix[r + 1] = vi.y, ix[r + 2] = vi.z, ix[r + 3] = vi.w;
      }
    }
  }
};

// the greatest of v[0..R) and the least index at it, by trees log2(R) deep
template <int R>
__device__ __forceinline__ void local_argmax(const float (&v)[R],
                                             const unsigned (&ix)[R],
                                             float& m, unsigned& at) {
  float t[R];
  unsigned c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = v[r];
#pragma unroll
  for (int s = 1; s < R; s <<= 1)
#pragma unroll
    for (int r = 0; r + s < R; r += 2 * s) t[r] = fmaxf(t[r], t[r + s]);
  m = t[0];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = v[r] == m ? ix[r] : kNoIndex;
#pragma unroll
  for (int s = 1; s < R; s <<= 1)
#pragma unroll
    for (int r = 0; r + s < R; r += 2 * s) c[r] = min(c[r], c[r + s]);
  at = c[0];
}

// the warp's greatest distance and least index at it, in every lane
__device__ __forceinline__ void warp_argmax(float m, unsigned at,
                                            unsigned& wm, unsigned& wi) {
  wm = __reduce_max_sync(kFull, __float_as_uint(m));
  wi = __reduce_min_sync(kFull, __float_as_uint(m) == wm ? at : kNoIndex);
}

template <int T, int P>
__global__ void __launch_bounds__(T)
    fps_kernel(const float* __restrict__ xyz,
               const long long* __restrict__ start,
               long long* __restrict__ out_idx, float* __restrict__ out_xyz,
               int n, int npoint) {
  constexpr bool kWarpFirst = kEntries<T> < T;
  constexpr int E = kEntries<T>;
  constexpr int R = Entries<E>::R;
  __shared__ __align__(16) Entries<E> ent;
  extern __shared__ unsigned chosen[];  // npoint indices

  const int t = threadIdx.x, lane = t & 31;
  const float* p = xyz + (size_t)blockIdx.x * n * 3;
  float px[P], py[P], pz[P], md[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = k * T + t;
    const bool real = j < n;
    px[k] = real ? p[3 * j] : 0.0f;
    py[k] = real ? p[3 * j + 1] : 0.0f;
    pz[k] = real ? p[3 * j + 2] : 0.0f;
    md[k] = real ? 1e10f : 0.0f;
  }

  unsigned far = start ? (unsigned)start[blockIdx.x] : 0u;
  if (t == 0) chosen[0] = far;
  for (int i = 1; i < npoint; ++i) {
    const float cx = __ldg(p + 3 * far), cy = __ldg(p + 3 * far + 1),
                cz = __ldg(p + 3 * far + 2);
    float v[P];
    unsigned kk[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dx = __fsub_rn(px[k], cx);
      const float dy = __fsub_rn(py[k], cy);
      const float dz = __fsub_rn(pz[k], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      v[k] = md[k] = fminf(md[k], d);
      kk[k] = k * T + t;
    }
    float m;
    unsigned at;
    local_argmax<P>(v, kk, m, at);

    const int buf = i & 1;
    if constexpr (kWarpFirst) {
      unsigned wm, wi;
      warp_argmax(m, at, wm, wi);
      if (lane == 0) {
        ent.d[buf][t >> 5] = __uint_as_float(wm);
        ent.idx[buf][t >> 5] = wi;
      }
    } else {
      ent.d[buf][t] = m;
      ent.idx[buf][t] = at;
    }
    __syncthreads();
    float b[R];
    unsigned ix[R];
    ent.read(buf, lane, b, ix);
    local_argmax<R>(b, ix, m, at);
    unsigned wm;
    warp_argmax(m, at, wm, far);
    if (t == 0) chosen[i] = far;
  }

  __syncthreads();
  long long* oi = out_idx + (size_t)blockIdx.x * npoint;
  float* ox = out_xyz + (size_t)blockIdx.x * npoint * 3;
  for (int j = t; j < npoint; j += T) {
    const unsigned f = chosen[j];
    oi[j] = f;
    ox[3 * j] = p[3 * f];
    ox[3 * j + 1] = p[3 * f + 1];
    ox[3 * j + 2] = p[3 * f + 2];
  }
}

struct Args {
  const float* xyz;
  const long long* start;
  long long* out_idx;
  float* out_xyz;
  int b, n, npoint;
  cudaStream_t stream;
};

template <int T, int P = 1>
int launch(int per_thread, const Args& a) {
  if constexpr (P > kMaxPerThread) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (per_thread != P) return launch<T, P + 1>(per_thread, a);
    const size_t smem = sizeof(unsigned) * (size_t)a.npoint;
    if (smem > kDefaultSmem - sizeof(Entries<kEntries<T>>)) {
      const cudaError_t err = cudaFuncSetAttribute(
          fps_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    fps_kernel<T, P><<<a.b, T, smem, a.stream>>>(a.xyz, a.start, a.out_idx,
                                                 a.out_xyz, a.n, a.npoint);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// xyz [b, n, 3] f32, start [b] i64 (null: every cloud starts at 0) ->
// out_idx [b, npoint] i64, out_xyz [b, npoint, 3] f32.  threads (T) is one
// of 128, 256, 512, 1024 and per_thread (P) 1..16 with T * P >= n
// (kernels/fps.py::launch_shape picks them).
PRIFIT_API int fps_forward(const void* xyz, const void* start, void* out_idx,
                           void* out_xyz, int b, int n, int npoint,
                           int threads, int per_thread, void* stream) {
  if ((long long)threads * per_thread < n || npoint < 1 || npoint > n)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(xyz),
               static_cast<const long long*>(start),
               static_cast<long long*>(out_idx), static_cast<float*>(out_xyz),
               b, n, npoint, static_cast<cudaStream_t>(stream)};
  switch (threads) {
    case 128: return launch<128>(per_thread, a);
    case 256: return launch<256>(per_thread, a);
    case 512: return launch<512>(per_thread, a);
    case 1024: return launch<1024>(per_thread, a);
  }
  return (int)cudaErrorInvalidValue;
}
