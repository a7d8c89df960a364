// The three distance-dependent passes of mode NMS on the tensor cores,
// with nothing [n, n] stored, not even a distance row:
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
// _rep_kernel and _used_kernel (nms_passes_pallas), which take bf16 operands;
// here the products are 3xTF32 (about f32 accuracy).
//
// Any width d <= 128 and any n: rows are held padded with zeros to DP (the
// kernel's template width, tf32_mma.cuh).  Columns past ncols (a zero row
// in the last tile) are skipped before any merge, so none can win an
// argmin or argmax, and rows past nrows write nothing.
//
// Bound on the H100: operations.  Pass 1 needs every distance, n^2 D
// multiply-adds a shape.  Passes 2 and 3 need far fewer, and do only those:
// a nonzero score needs counts_j > 0, so pass 2's argmax over the occupied
// columns in ascending order is the oracle's, except that it is index 0 when
// every score is 0 (the running best starts at (0, 0)), and only occupied
// rows vote; pass 3 needs only the center columns.  Each block lists its
// shape's occupied modes (or centers) in shared memory with a block-wide
// ballot scan, in ascending order, and a block whose rows lie past the
// list's end exits: the grid is sized for every mode occupied, and no count
// is read on the host.
//
// One tile routine serves the three passes.  A block of 4 warps owns 64 rows
// (16 a warp, held in shared memory as f32 A fragments and split into TF32
// hi and lo as they are read, tf32_mma.cuh) and streams 64-column tiles of
// the modes through a two-stage cp.async ring.  Per tile a warp computes its
// 16 x 64 block of <m_i, m_j> with mma.sync in 3xTF32 and folds d_ij into a
// running (value, index) per row in registers (common.cuh merge_min /
// merge_max, a total order, so the merge order does not matter).  Every
// (i, j) goes through the same split and the same k order whatever its place
// in a tile, so exact-duplicate modes get bit-identical distances, which the
// tie semantics rest on.  Counts are f32 atomic adds of 1 (exact below 2^24,
// so order-free); is_center and used are byte stores of 1, so concurrent
// writers agree.  The kernels write the outputs' final types (f32, bool).
#include "tf32_mma.cuh"

namespace {

constexpr int kRowsN = 64;  // rows a block owns
constexpr int kColsN = 64;  // columns per streamed tile
constexpr int kWarpsN = kRowsN / 16;
constexpr int kThreadsN = 32 * kWarpsN;

enum Pass { kCounts, kCenters, kUsed };

// Dynamic shared memory: the row fragments, two column tiles and, for
// passes 2 and 3, the list of n ints.
template <int DP>
size_t smem_bytes(int pass, int n) {
  return sizeof(float) * (kRowsN * DP + 2 * kColsN * DP) +
         (pass == kCounts ? 0 : sizeof(int) * (size_t)n);
}

// list[0, count) = the j < n with flag(j), ascending; returns count.  All
// threads of the block take part.
template <typename Flag>
__device__ int compact(int n, Flag flag, int* list) {
  __shared__ int warp_count[kWarpsN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int j0 = 0; j0 < n; j0 += kThreadsN) {
    const int j = j0 + threadIdx.x;
    const bool f = j < n && flag(j);
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int off = base, total = 0;
#pragma unroll
    for (int w = 0; w < kWarpsN; ++w) {
      off += w < warp ? warp_count[w] : 0;
      total += warp_count[w];
    }
    if (f) list[off + __popc(m & ((1u << lane) - 1u))] = j;
    base += total;
    __syncthreads();  // warp_count read by all before it is rewritten
  }
  return base;
}

template <int kPass, int DP, bool kFull>
__global__ void __launch_bounds__(kThreadsN, 2)
    nms_kernel(const float* __restrict__ modes, float* __restrict__ counts,
               const float* __restrict__ bw, uint8_t* __restrict__ is_center,
               uint8_t* __restrict__ used, int n, int d) {
  if (kFull) d = DP;  // a constant from here on
  constexpr int kTileN = kColsN * DP;
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                 // [kRowsN * DP] A fragments of the rows
  float* xs = smem + kRowsN * DP;   // [2][kColsN][DP] tiles of the columns
  int* list = reinterpret_cast<int*>(xs + 2 * kTileN);  // [n], passes 2, 3

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRowsN;
  const float* mb = modes + (size_t)b * n * d;
  float* cnt = counts + (size_t)b * n;
  uint8_t* isc = is_center + (size_t)b * n;

  // rows: all (passes 1, 3) or the occupied modes (pass 2); columns: all
  // (pass 1), the occupied modes (pass 2) or the centers (pass 3)
  int nrows = n, ncols = n;
  if (kPass == kCenters)
    nrows = ncols = compact(n, [&](int j) { return cnt[j] > 0.0f; }, list);
  if (kPass == kUsed)
    ncols = compact(n, [&](int j) { return isc[j] != 0; }, list);
  if (row0 >= nrows) return;  // block-uniform
  auto row_of = [&](int r) { return kPass == kCenters ? list[r] : r; };
  auto col_of = [&](int c) { return kPass == kCounts ? c : list[c]; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ntiles = max(1, (ncols + kColsN - 1) / kColsN);

  auto stage = [&](int tile) {
    const int c0 = tile * kColsN;
    stage_rows<DP>(xs + (tile & 1) * kTileN, mb, d, kColsN, [&](int r) {
      return c0 + r < ncols ? col_of(c0 + r) : -1;
    });
    cp_async_commit();
  };
  stage(0);
  load_frag_rows<DP>(qf, mb, d, kRowsN, [&](int r) {
    return row0 + r < nrows ? row_of(row0 + r) : -1;
  });
  const float4* qw =
      reinterpret_cast<const float4*>(qf) + warp * (DP / 8) * 32;

  // running best of rows grp and grp + 8 over this thread's columns; pass 2
  // starts at (0, 0): the oracle's argmax when every score is 0
  float best[2];
  int at[2] = {0, 0};
  best[0] = best[1] = kPass == kCenters ? 0.0f : INFINITY;
  const float bwb = kPass == kCenters ? bw[b] : 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and the row fragments) visible to all
    const float* xt = xs + (it & 1) * kTileN;

    // <m_i, m_j>: 16 rows x 64 columns, 8 n-tiles
    float sc[kColsN / 8][4];
#pragma unroll
    for (int i = 0; i < kColsN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      FragA a;
      a.set(qw[kk * 32 + lane]);
      FragB bx[kColsN / 8];
#pragma unroll
      for (int nt = 0; nt < kColsN / 8; ++nt)
        bx[nt] = frag_bt<DP>(xt, nt * 8, kk, grp, tig);
      mma_3xtf32_row<kColsN / 8>(sc, a, bx);
    }

    const int c0 = it * kColsN;
#pragma unroll
    for (int nt = 0; nt < kColsN / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + nt * 8 + 2 * tig + (r & 1);
        if (c >= ncols) continue;
        const int j = col_of(c);
        const float d = 2.0f - 2.0f * sc[nt][r];
        if (kPass == kCenters)
          merge_max(best[r >> 1], at[r >> 1], d < bwb ? cnt[j] : 0.0f, j);
        else
          merge_min(best[r >> 1], at[r >> 1], d, j);
      }
    __syncthreads();  // tile it consumed before its stage is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the 4 lanes of a row (tig) hold its columns between them
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, at[h], off);
      if (kPass == kCenters)
        merge_max(best[h], at[h], ov, oi);
      else
        merge_min(best[h], at[h], ov, oi);
    }
    if (tig != 0 || row0 + warp * 16 + grp + 8 * h >= nrows) continue;
    if (kPass == kCounts) atomicAdd(cnt + at[h], 1.0f);
    if (kPass == kCenters) isc[at[h]] = 1;
    if (kPass == kUsed) used[(size_t)b * n + at[h]] = 1;
  }
}

template <int kPass, int DP, bool kFull>
int launch_dp(const void* modes, void* counts, const void* bw,
              void* is_center, void* used, int b, int n, int d,
              cudaStream_t stream) {
  // the kernel's dynamic shared-memory limit, raised once per process (and
  // again only for a larger n)
  static size_t allowed = 0;
  const size_t smem = smem_bytes<DP>(kPass, n);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel<kPass, DP, kFull>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  nms_kernel<kPass, DP, kFull><<<dim3((n + kRowsN - 1) / kRowsN, b),
                                 kThreadsN, smem, stream>>>(
      static_cast<const float*>(modes), static_cast<float*>(counts),
      static_cast<const float*>(bw), static_cast<uint8_t*>(is_center),
      static_cast<uint8_t*>(used), n, d);
  return (int)cudaGetLastError();
}

template <int kPass>
int launch(const void* modes, void* counts, const void* bw, void* is_center,
           void* used, int b, int n, int d, int dp, void* stream) {
  return with_width(d, dp, [&](auto w, auto full) {
    return launch_dp<kPass, decltype(w)::value, decltype(full)::value>(
        modes, counts, bw, is_center, used, b, n, d,
        static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// modes [b, n, d] f32 unit rows; bw [b] f32; dp the padded width (32, 64
// or 128, at least d).  counts [b, n] f32, is_center and used [b, n] bool,
// zeroed by the caller; the passes run in this order on one stream.
PRIFIT_API int nms_counts(const void* modes, void* counts, int b, int n,
                          int d, int dp, void* stream) {
  return launch<kCounts>(modes, counts, nullptr, nullptr, nullptr, b, n, d,
                         dp, stream);
}

PRIFIT_API int nms_centers(const void* modes, const void* counts,
                           const void* bw, void* is_center, int b, int n,
                           int d, int dp, void* stream) {
  return launch<kCenters>(modes, const_cast<void*>(counts), bw, is_center,
                          nullptr, b, n, d, dp, stream);
}

PRIFIT_API int nms_used(const void* modes, const void* is_center, void* used,
                        int b, int n, int d, int dp, void* stream) {
  return launch<kUsed>(modes, nullptr, nullptr, const_cast<void*>(is_center),
                       used, b, n, d, dp, stream);
}
