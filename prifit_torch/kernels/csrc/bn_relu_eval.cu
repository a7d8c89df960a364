// The eval-mode epilogue of a PointNet++ dense layer in one pass: the dense
// bias, batch norm with running statistics, the cast to the storage dtype,
// the relu and, where the layer ends an SA scale or the group-all layer,
// the max over the K rows of each [K, F] group.
//
// No TPU kernel: in the JAX package this chain is one XLA fusion
// (prifit_tpu/nn/pointnet2.py, PointMLP's eval chain with
// prifit_tpu/nn/norm.py::BatchNorm).  Done as PyTorch ops it is seven or
// eight passes a layer (bias add, subtract, two products, add, cast, relu,
// max), about 44-46 bytes moved for each activation element.
//
// Bit for bit the op chain of prifit_torch/nn/pointnet2.py's point_mlp and
// grouped_first_layer in eval mode, element by element in f32:
//   x = round(z)                                  (f32 grouped input only)
//   x = round(x + round(dense_bias))              (with a dense bias)
//   y = round(((x - mean) * inv) * weight + bias)
//   y = max(y, 0), a NaN kept                     (torch.relu)
//   out = max over K of y, NaN propagating        (torch.amax)
// where round is to the storage dtype (bf16: round to nearest even; f32:
// none) and inv = torch.rsqrt(running_var + eps) comes from the wrapper.
// Each product and sum is its own ATen op there, so here each is an
// explicitly rounded intrinsic (__fsub_rn, __fmul_rn, __fadd_rn), which
// nvcc never contracts into an FMA.
//
// Bound on the H100: bytes.  The work is 6-7 flops an element against
// 4-8 bytes moved, far below the 295 flops a byte where bf16 tensor cores
// would become the limit.  The least traffic is each input element read
// once at its dtype, each output element written once (only [groups, F]
// for the max), and the per-feature parameters.  One MSG eval forward at
// B=24, N=2048 moves 3.77 GB that way: 1.12 ms at 3.35 TB/s.  The
// instruction rate is the second limit: at 2 bytes an element, 12
// instructions an element take about half the byte time, so the chain is
// kept short (no rounding of an input already in the storage dtype, pairs
// rounded by one conversion, the relu and the max one max.NaN each).
//
// Design: a thread owns VEC consecutive features of a row, so that it loads
// and stores 16 bytes along the contiguous feature axis where the width
// allows (VEC = 8; 4 for sa2's width 196, whose bf16 rows are 392 bytes and
// not 16-byte aligned), holds its features' parameters in registers,
// loaded once, and keeps about 128 bytes of rows in flight, packed as
// loaded.  Without the max, a block covers C = F / VEC columns and 256 / C
// rows and walks the rows in a grid-stride loop.  With the max, a warp
// takes one group's K x (up to 32 columns) tile at a time: its row lanes
// each keep a running max in registers and fold them by shuffles, with no
// block-wide barrier, so the tile is read once and only the group's maxima
// are written; where the groups are few (sa3: 24), the chunks narrow
// until the card has 32 warps an SM.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Round VEC values to the storage dtype in place (bf16: to nearest even,
// as ATen's cast does, two values a conversion; f32: nothing).
template <bool BF16, int VEC>
__device__ __forceinline__ void to_storage(float* v) {
  if constexpr (BF16) {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[j], v[j + 1]);
      const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
      v[j] = __uint_as_float(u << 16);
      v[j + 1] = __uint_as_float(u & 0xFFFF0000u);
    }
  }
}

// The larger of a and b, or the canonical NaN where either is a NaN.  For
// the relu, max(y, 0) with a NaN y gives the NaN that torch.relu keeps
// (every NaN here is the canonical one that arithmetic and the bf16
// conversion give); for the K-max, it is torch.amax's combine on the
// relu's outputs, where no -0.0 is left to tie with +0.0.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The bf16 bits of two values that bf16 represents exactly.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xFFFF0000u);
}

// VEC (8 or 4) consecutive values as loaded, to be unpacked later, so
// that a thread keeps several rows in flight in few registers: 16 bytes of
// bf16 are 4 registers, not 8.  The caller aligns the address to min(16,
// VEC x the element size) bytes.
template <typename T, int VEC>
struct Raw;

template <int VEC>
struct Raw<uint16_t, VEC> {
  uint32_t w[VEC / 2];

  __device__ __forceinline__ void load(const uint16_t* __restrict__ p) {
    if constexpr (VEC == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    }
  }

  __device__ __forceinline__ void unpack(float* o) const {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

template <int VEC>
struct Raw<float, VEC> {
  float v[VEC];

  __device__ __forceinline__ void load(const float* __restrict__ p) {
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + c);
      v[4 * c] = a.x;
      v[4 * c + 1] = a.y;
      v[4 * c + 2] = a.z;
      v[4 * c + 3] = a.w;
    }
  }

  __device__ __forceinline__ void unpack(float* o) const {
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = v[j];
  }
};

// rows in flight a thread: about 128 bytes of input
template <typename TIn>
constexpr int kUnroll = sizeof(TIn) == 2 ? 8 : 4;

template <int VEC>
__device__ __forceinline__ void store_vec(uint16_t* __restrict__ p,
                                          const float* v) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float* v) {
#pragma unroll
  for (int c = 0; c < VEC / 4; ++c) {
    reinterpret_cast<float4*>(p)[c] =
        make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

struct Params {
  const float* mean;
  const float* inv;
  const float* weight;
  const float* bias;
  const float* dense_bias;  // null without a dense bias
};

// One thread's features' parameters, and the chain on VEC values of them;
// ROUND_IN rounds an f32 input to a bf16 storage first (a bf16 input is
// exact, and its NaNs become the canonical NaN at the first operation).
template <int VEC, bool BF16, bool BIAS, bool ROUND_IN>
struct Epilogue {
  float mean[VEC], inv[VEC], weight[VEC], bias[VEC], dense_bias[VEC];

  __device__ __forceinline__ void load(const Params& p, int f0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] = __ldg(p.mean + f0 + j);
      inv[j] = __ldg(p.inv + f0 + j);
      weight[j] = __ldg(p.weight + f0 + j);
      bias[j] = __ldg(p.bias + f0 + j);
      if constexpr (BIAS) dense_bias[j] = __ldg(p.dense_bias + f0 + j);
    }
    // dense() casts its bias to the storage dtype before adding it
    if constexpr (BIAS) to_storage<BF16, VEC>(dense_bias);
  }

  __device__ __forceinline__ void apply(float* v) const {
    if constexpr (ROUND_IN) to_storage<BF16, VEC>(v);
    if constexpr (BIAS) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(v[j], dense_bias[j]);
      to_storage<BF16, VEC>(v);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[j] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[j], mean[j]), inv[j]), weight[j]),
          bias[j]);
    }
    to_storage<BF16, VEC>(v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = max_nan(v[j], 0.0f);
  }
};

// x [rows, F] -> y [rows, F]; block (C columns, THREADS / C rows).
template <typename TIn, typename TOut, int VEC, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    rows_kernel(const TIn* __restrict__ x, TOut* __restrict__ y, Params p,
                long long rows, int f) {
  constexpr bool BF16 = sizeof(TOut) == 2;
  constexpr int U = kUnroll<TIn>;
  const int cols = f / VEC;
  const int cx = threadIdx.x % cols;
  const int ry = threadIdx.x / cols;
  const int rows_per_block = blockDim.x / cols;
  Epilogue<VEC, BF16, BIAS, BF16 && sizeof(TIn) == 4> e;
  e.load(p, cx * VEC);
  const long long stride = (long long)gridDim.x * rows_per_block;
  for (long long r0 = (long long)blockIdx.x * rows_per_block + ry; r0 < rows;
       r0 += stride * U) {
    Raw<TIn, VEC> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * stride;
      if (r < rows) raw[u].load(x + r * f + cx * VEC);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * stride;
      if (r < rows) {
        float v[VEC];
        raw[u].unpack(v);
        e.apply(v);
        store_vec<VEC>(y + r * f + cx * VEC, v);
      }
    }
  }
}

// x [groups, K, F] -> y [groups, F], the max over K.  A warp takes one
// (group, chunk of cb columns) at a time: cb columns (a power of two, at
// most 32) x 32 / cb row lanes, folded by shuffles; work item w is chunk
// w / groups of group w % groups, so a warp's column seldom changes and its
// parameters are loaded again only then.
template <typename TIn, typename TOut, int VEC, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    max_kernel(const TIn* __restrict__ x, TOut* __restrict__ y, Params p,
               long long groups, int k, int f, int cb) {
  constexpr bool BF16 = sizeof(TOut) == 2;
  constexpr int U = kUnroll<TIn>;
  const int lane = threadIdx.x % 32;
  const int cx = lane % cb;
  const int ry = lane / cb;
  const int n_lanes = 32 / cb;
  const int cols = f / VEC;
  const long long chunks = (cols + cb - 1) / cb;
  const long long n_warps = (long long)gridDim.x * WARPS;
  Epilogue<VEC, BF16, BIAS, BF16 && sizeof(TIn) == 4> e;
  long long loaded = -1;
  for (long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       w < groups * chunks; w += n_warps) {
    const long long chunk = w / groups;
    const long long g = w - chunk * groups;
    const int col = (int)chunk * cb + cx;
    const bool live = col < cols;
    if (live && chunk != loaded) {
      e.load(p, col * VEC);
      loaded = chunk;
    }
    float m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = -INFINITY;
    if (live) {
      const TIn* base = x + g * k * f + col * VEC;
      for (int r0 = ry; r0 < k; r0 += n_lanes * U) {
        Raw<TIn, VEC> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = r0 + u * n_lanes;
          if (r < k) raw[u].load(base + (long long)r * f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r0 + u * n_lanes < k) {
            float v[VEC];
            raw[u].unpack(v);
            e.apply(v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) m[j] = max_nan(m[j], v[j]);
          }
        }
      }
    }
    for (int off = cb; off < 32; off *= 2) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        m[j] = max_nan(m[j], __shfl_xor_sync(0xFFFFFFFFu, m[j], off));
      }
    }
    if (ry == 0 && live) store_vec<VEC>(y + g * f + col * VEC, m);
  }
}

template <typename TIn, typename TOut, int VEC, bool BIAS>
int launch(const void* x, void* y, const Params& p, long long rows, int k,
           int f, int kmax, cudaStream_t stream) {
  const TIn* xi = static_cast<const TIn*>(x);
  TOut* yo = static_cast<TOut*>(y);
  const int cols = f / VEC;
  const long long cap = 132LL * 16;
  if (kmax) {
    // the widest chunk (up to 32 columns, at least 2: 32 bytes a row of a
    // warp) that still gives the card 32 warps an SM
    const long long groups = rows / k;
    int cb = 1;
    while (cb < cols && cb < 32) cb *= 2;
    while (cb > 2 && groups * ((cols + cb - 1) / cb) < 132LL * 32) cb /= 2;
    const long long work = groups * ((cols + cb - 1) / cb);
    long long blocks = (work + WARPS - 1) / WARPS;
    if (blocks > cap) blocks = cap;
    if (blocks > 0) {
      max_kernel<TIn, TOut, VEC, BIAS><<<(int)blocks, THREADS, 0, stream>>>(
          xi, yo, p, groups, k, f, cb);
    }
  } else {
    const int rows_per_block = THREADS / cols;
    long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > cap) blocks = cap;
    if (blocks > 0) {
      rows_kernel<TIn, TOut, VEC, BIAS><<<(int)blocks,
                                          cols * rows_per_block, 0,
                                          stream>>>(xi, yo, p, rows, f);
    }
  }
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, int VEC>
int with_bias(const void* x, void* y, const Params& p, long long rows, int k,
              int f, int kmax, cudaStream_t stream) {
  if (p.dense_bias) {
    return launch<TIn, TOut, VEC, true>(x, y, p, rows, k, f, kmax, stream);
  }
  return launch<TIn, TOut, VEC, false>(x, y, p, rows, k, f, kmax, stream);
}

template <typename TIn, typename TOut>
int with_vec(const void* x, void* y, const Params& p, long long rows, int k,
             int f, int kmax, cudaStream_t stream) {
  // VEC 8 where it divides F, else 4 (sa2's 196); both pointers aligned to
  // min(16, VEC x the element size) bytes
  const int vec = f % 8 == 0 ? 8 : 4;
  const uintptr_t bx = vec * sizeof(TIn) < 16 ? vec * sizeof(TIn) : 16;
  const uintptr_t by = vec * sizeof(TOut) < 16 ? vec * sizeof(TOut) : 16;
  if (f % vec != 0 || f / vec > THREADS ||
      reinterpret_cast<uintptr_t>(x) % bx != 0 ||
      reinterpret_cast<uintptr_t>(y) % by != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 8) {
    return with_bias<TIn, TOut, 8>(x, y, p, rows, k, f, kmax, stream);
  }
  return with_bias<TIn, TOut, 4>(x, y, p, rows, k, f, kmax, stream);
}

}  // namespace

// x [rows, f] (f32 if x_f32, else bf16 bits) -> y in the storage dtype
// (bf16 bits if store_bf16, else f32): [rows, f], or with kmax the max over
// each k consecutive rows, [rows / k, f].  The pairs taken: bf16 -> bf16,
// f32 -> bf16 and f32 -> f32.  mean, inv, weight, bias and dense_bias
// (null: none) are f32 [f]; f is a multiple of 4, and f / VEC <= 256.
PRIFIT_API int bn_relu_eval(const void* x, void* y, const void* mean,
                            const void* inv, const void* weight,
                            const void* bias, const void* dense_bias,
                            long long rows, int k, int f, int x_f32,
                            int store_bf16, int kmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{static_cast<const float*>(mean),
                 static_cast<const float*>(inv),
                 static_cast<const float*>(weight),
                 static_cast<const float*>(bias),
                 static_cast<const float*>(dense_bias)};
  if (x_f32 && store_bf16) {
    return with_vec<float, uint16_t>(x, y, p, rows, k, f, kmax, s);
  }
  if (x_f32) return with_vec<float, float>(x, y, p, rows, k, f, kmax, s);
  if (store_bf16) {
    return with_vec<uint16_t, uint16_t>(x, y, p, rows, k, f, kmax, s);
  }
  return (int)cudaErrorInvalidValue;
}
