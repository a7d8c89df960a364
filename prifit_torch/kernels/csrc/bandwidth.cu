// Per-row K-th smallest squared chordal distance, d_ij = 2 - 2 <x_i, x_j>,
// for up to 4 ranks K a launch.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/bandwidth.py::_bw_kernel
// (kth_nn_distance_pallas).  Its oracle, prifit_tpu/clustering/
// mean_shift.py::_kth_smallest_bisect, runs 24 halvings of [0, 4] keeping
// count(d <= mid) >= K and returns hi.  Every mid is a multiple of 2^-22 that
// f32 holds exactly, and d <= k 2^-22 holds exactly when ceil(d 2^22) <= k,
// so hi is the K-th smallest of the integer keys
//   key(d) = clamp(ceil(d 2^22), 1, 2^24)
// times 2^-22 (tests/test_torch_bandwidth_select.py holds this bit for bit).
// The kernel finds that key by a radix select over u = key - 1 (24 bits),
// 8 bits a pass, and returns the bisection's value over its own distances.
//
// Bound on the H100: operations, the products.  2 n^2 D flops a shape, here
// on the tensor cores in 3xTF32 (three TF32 products each, about f32
// accuracy; the TPU kernel's bf16 operands would miss the port's f32
// limits), plus a few operations a distance for the keys and the counts.
// What holds it above that bound is the products' rate through mma.sync
// TF32, far below the dense TF32 peak on an H100, as in NMS pass 1
// (PERF.md section 6); wgmma is the step after.
//
// A block of 8 warps owns R <= 16 rows of one shape (R from n at launch, so
// that R keys rows fit: 16 at n <= 2048, 4 at n = 8192; the m16 tile's
// rows past R are zeros and unused).  Their A fragments sit in registers,
// split into TF32 hi and lo once.  X streams through a two-stage cp.async
// ring of 64-row tiles (tf32_mma.cuh, rows padded with zeros to DP); a warp
// takes 8 columns of each tile, in three independent accumulators (lo hi,
// hi lo, hi hi) so that the tensor cores see three chains a warp.  Each
// distance becomes its key u, stored once in shared memory (a row of keys
// is padded by 8 words so a warp's 8-byte stores hit every bank once), and
// counted into the row's 256-bin histogram of u >> 16.  Then a warp a row,
// for each rank: the bin of the K-th key from that histogram, and one pass
// over the stored row that lists the keys of that bin (in the ring, free
// after the products).  At most 256 of them (the usual case) go to
// registers, 8 a lane, and the answer's low 16 bits follow from 16
// warp-wide counts.  More (as when every distance is equal) are counted
// instead, the next 8 bits over the row and the last 8 over the list (or
// the row again, past the list's room).  So a row is read once or twice a
// rank after the products, against 24 counting passes a rank before.
// Columns past n are never stored or counted: for the count they are
// +inf.
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxRows = 16;       // rows a block owns, at most
constexpr int kCols = 64;          // X rows per streamed tile
constexpr int kWarps = kCols / 8;  // 8: one n-tile of each tile a warp
constexpr int kThreadsB = 32 * kWarps;
constexpr int kBins = 256;
constexpr int kMaxRanks = 4;
constexpr int kKeyWords = kMaxRows * (2048 + 8);  // keys of a block, at most

struct Ranks {
  int k[kMaxRanks];
};

// Words a row of keys takes: n rounded up to 32, plus 8.
__host__ __device__ inline int key_stride(int n) {
  return (n + 31) / 32 * 32 + 8;
}

template <int DP>
size_t smem_bytes(int rows, int n) {
  return sizeof(float) * 2 * kCols * DP +
         sizeof(uint32_t) * (size_t)rows * key_stride(n) +
         sizeof(int) * kMaxRows * kBins;
}

// u = key(d) - 1 of the distance from the product s.
__device__ __forceinline__ uint32_t dist_key(float s) {
  const float dist = 2.0f - 2.0f * s;
  const float c = ceilf(dist * 4194304.0f);  // 2^22: exact
  return (uint32_t)fminf(fmaxf(c, 1.0f), 16777216.0f) - 1u;
}

// The bin of the K-th smallest entry (1 <= K <= the histogram's total) of a
// 256-bin histogram, lane l reading bins 8 l..8 l + 7, and K's rank within
// that bin.  Returns the same in every lane.
__device__ __forceinline__ void kth_bin(const int* h, int K, int lane,
                                        int& bin, int& rank) {
  int c[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = h[8 * lane + i];
    sum += c[i];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, incl >= K)) - 1;
  int b = 0, r = 0;
  if (lane == src) {
    int acc = incl - sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (r == 0 && acc + c[i] >= K) {
        b = 8 * lane + i;
        r = K - acc;
      }
      acc += c[i];
    }
  }
  bin = __shfl_sync(0xffffffffu, b, src);
  rank = __shfl_sync(0xffffffffu, r, src);
}

// h = the histogram of (u >> shift) & 255 over the keys u of src[0, len)
// whose u >> (shift + 8) is prefix, and when list is not null those keys
// copied to it (in no particular order); either may be null.  One warp, 4
// keys a lane and step (one 16-byte load, the next step's issued before
// this step's stores; src is 16-byte aligned, and the words past len up to
// the next multiple of 128 lie in shared memory and are not counted).
__device__ __forceinline__ void count_bins(const uint32_t* src, int len,
                                           uint32_t prefix, int shift,
                                           int* h, uint32_t* list,
                                           int lane) {
  if (h != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[8 * lane + i] = 0;
  }
  __syncwarp();
  int listed = 0;
  uint4 next = *reinterpret_cast<const uint4*>(src + 4 * lane);
  for (int base = 0; base < len; base += 128) {
    const int j = base + 4 * lane;
    const uint32_t e[4] = {next.x, next.y, next.z, next.w};
    if (base + 128 < len)
      next = *reinterpret_cast<const uint4*>(src + j + 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool match = j + i < len && (e[i] >> (shift + 8)) == prefix;
      if (h != nullptr && match) atomicAdd(h + ((e[i] >> shift) & 255), 1);
      if (list != nullptr) {
        const unsigned m = __ballot_sync(0xffffffffu, match);
        if (match) list[listed + __popc(m & ((1u << lane) - 1u))] = e[i];
        listed += __popc(m);
      }
    }
  }
  __syncwarp();
}

// The k-th smallest (1 <= k <= len) of list[0, len), len <= 256, keys that
// share their bits 16..23 (top): 8 keys a lane in registers, and the low 16
// bits of the answer from the top down, each from one warp-wide count.
constexpr int kRegKeys = 256;

__device__ __forceinline__ uint32_t kth_in_list(const uint32_t* list,
                                                int len, int k, uint32_t top,
                                                int lane) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = lane + 32 * i < len ? list[lane + 32 * i] : 0xffffffffu;
  uint32_t low = 0;
#pragma unroll
  for (int bit = 15; bit >= 0; --bit) {
    const uint32_t probe = (top << 16) | low | ((1u << bit) - 1u);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) cnt += v[i] <= probe;
    if (__reduce_add_sync(0xffffffffu, cnt) < k) low |= 1u << bit;
  }
  return (top << 16) | low;
}

template <int DP, bool kFull>
__global__ void __launch_bounds__(kThreadsB, 1)
    kth_kernel(const float* __restrict__ x, float* __restrict__ out,
               int out_stride, int n, int d, int rows, int num_ranks,
               Ranks ranks) {
  if (kFull) d = DP;  // a constant from here on
  constexpr int kTileFloats = kCols * DP;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // [2][kCols][DP]
  const int ks = key_stride(n);
  uint32_t* keys = reinterpret_cast<uint32_t*>(xs + 2 * kTileFloats);
  int* hist = reinterpret_cast<int*>(keys + (size_t)rows * ks);  // [16][256]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, n - row0);
  const float* xb = x + (size_t)b * n * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ntiles = (n + kCols - 1) / kCols;

  auto stage = [&](int tile) {
    const int c0 = tile * kCols;
    stage_rows<DP>(xs + (tile & 1) * kTileFloats, xb, d, kCols,
                   [&](int r) { return c0 + r < n ? c0 + r : -1; });
    cp_async_commit();
  };
  stage(0);
  for (int e = threadIdx.x; e < kMaxRows * kBins; e += blockDim.x)
    hist[e] = 0;

  // A fragments of the block's rows (grp, grp + 8), split once
  FragA a[DP / 8];
  {
    const bool lo_ok = grp < nrows, hi_ok = grp + 8 < nrows;
    const float* r_lo = xb + (size_t)(row0 + grp) * d;
    const float* r_hi = xb + (size_t)(row0 + grp + 8) * d;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int c = 8 * kk + 2 * tig;
      a[kk].set(lo_ok && c < d ? r_lo[c] : 0.0f,
                hi_ok && c < d ? r_hi[c] : 0.0f,
                lo_ok && c + 1 < d ? r_lo[c + 1] : 0.0f,
                hi_ok && c + 1 < d ? r_hi[c + 1] : 0.0f);
    }
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and the zeroed histograms) visible to all
    const float* xt = xs + (it & 1) * kTileFloats;

    // <x_i, x_j> for the 16 rows and this warp's 8 columns
    float lh[4] = {}, hl[4] = {}, hh[4] = {};
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const FragB bx = frag_bt<DP>(xt, warp * 8, kk, grp, tig);
      mma_tf32(lh, a[kk].lo, bx.hi);
      mma_tf32(hl, a[kk].hi, bx.lo);
      mma_tf32(hh, a[kk].hi, bx.hi);
    }
    const int col = it * kCols + warp * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = grp + 8 * h;
      if (r >= nrows || col >= n) continue;
      const uint32_t u0 = dist_key((lh[2 * h] + hl[2 * h]) + hh[2 * h]);
      const uint32_t u1 =
          dist_key((lh[2 * h + 1] + hl[2 * h + 1]) + hh[2 * h + 1]);
      uint32_t* kr = keys + (size_t)r * ks + col;
      atomicAdd(hist + r * kBins + (u0 >> 16), 1);
      if (col + 1 < n) {
        *reinterpret_cast<uint2*>(kr) = make_uint2(u0, u1);
        atomicAdd(hist + r * kBins + (u1 >> 16), 1);
      } else {
        kr[0] = u0;
      }
    }
    __syncthreads();  // tile it consumed before its stage is refilled
  }

  // the selection, a warp a row, with the ring as scratch: a warp's 256-bin
  // histogram and a list of the keys in the first pass's bin
  constexpr int kScratch = 2 * kTileFloats / kWarps;
  constexpr int kListCap = kScratch - kBins;
  int* h2 = reinterpret_cast<int*>(xs) + warp * kScratch;
  uint32_t* list = reinterpret_cast<uint32_t*>(h2 + kBins);
  for (int r = warp; r < nrows; r += kWarps) {
    const uint32_t* row = keys + (size_t)r * ks;
    for (int c = 0; c < num_ranks; ++c) {
      const int K = ranks.k[c];
      uint32_t u;
      if (K < 1) {
        u = 0;  // every mid counts >= K: hi halves down to 2^-22
      } else if (K > n) {
        u = (1u << 24) - 1;  // no mid counts K: hi stays 4
      } else {
        int b1, k1, b2, k2, b3, k3;
        kth_bin(hist + r * kBins, K, lane, b1, k1);
        const int nb = hist[r * kBins + b1];
        if (nb <= kRegKeys) {
          // few keys in bin b1: list them, select in registers
          count_bins(row, n, b1, 8, nullptr, list, lane);
          u = kth_in_list(list, nb, k1, b1, lane);
        } else {
          // the next 8 bits counted over the row (the keys of bin b1
          // listed while counted, where they fit), the last 8 over that
          // list or the row again
          const bool fits = nb <= kListCap;
          count_bins(row, n, b1, 8, h2, fits ? list : nullptr, lane);
          kth_bin(h2, k1, lane, b2, k2);
          count_bins(fits ? list : row, fits ? nb : n, (b1 << 8) | b2, 0,
                     h2, nullptr, lane);
          kth_bin(h2, k2, lane, b3, k3);
          u = (b1 << 16) | (b2 << 8) | b3;
        }
      }
      if (lane == 0)
        out[(size_t)b * out_stride + (size_t)c * n + row0 + r] =
            (float)(u + 1) / 4194304.0f;  // key 2^-22, exact
    }
  }
}

template <int DP, bool kFull>
int launch(const float* x, float* out, int out_stride, int b, int n, int d,
           int num_ranks, Ranks ranks, cudaStream_t stream) {
  const int fit = kKeyWords / key_stride(n);
  const int rows = fit < kMaxRows ? fit : kMaxRows;
  // the kernel's dynamic shared-memory limit, raised once per process (and
  // again only for a larger need)
  static size_t allowed = 0;
  const size_t smem = smem_bytes<DP>(rows, n);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kth_kernel<DP, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  kth_kernel<DP, kFull>
      <<<dim3((n + rows - 1) / rows, b), kThreadsB, smem, stream>>>(
          x, out, out_stride, n, d, rows, num_ranks, ranks);
  return (int)cudaGetLastError();
}

}  // namespace

// x [b, n, d] f32 unit rows -> out[b * out_stride + c * n + i], the value
// for rank k_c of row i, c < num_ranks (1..4).  dp is the padded width (32,
// 64 or 128, at least d); n <= 8192.
PRIFIT_API int kth_nn_distance(const void* x, void* out, int out_stride,
                               int b, int n, int d, int dp, int num_ranks,
                               int k0, int k1, int k2, int k3, void* stream) {
  if (num_ranks < 1 || num_ranks > kMaxRanks)
    return (int)cudaErrorInvalidValue;
  const Ranks ranks = {{k0, k1, k2, k3}};
  return with_width(d, dp, [&](auto w, auto full) {
    return launch<decltype(w)::value, decltype(full)::value>(
        static_cast<const float*>(x), static_cast<float*>(out), out_stride,
        b, n, d, num_ranks, ranks, static_cast<cudaStream_t>(stream));
  });
}
