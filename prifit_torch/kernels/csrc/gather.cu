// Batched row gather: out[b, r, :] = table[b, idx[b, r], :], bit-exact.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/gather.py::_gather_kernel
// (gather_rows_pallas / index_points_dg), whose lane-shuffle design exists
// because the TPU has no fast row gather.  Here a row gather is a plain copy.
//
// Bound on the H100: bytes.  Each index is read once, each output word is
// read once from the table (through L2, where the [n, C] table of a shape
// stays resident) and written once.  The design:
//   - the index is read in the caller's type (int32 or int64: two entry
//     points), so the wrapper makes no cast copy;
//   - the batch is blockIdx.y and every offset inside a shape is 32-bit (the
//     wrapper checks that rows and n times the row bytes fit in 31 bits), so
//     no thread divides a 64-bit number;
//   - a group of G lanes owns one output row: its first lane loads the
//     index once and shuffles it to the others, and each lane copies the
//     row's units lane, lane + G, ...  A narrow row (16 bytes or less: the
//     12-byte xyz rows) takes G = 1, one thread a row; a wider one G up to
//     32, so a 512-byte row is one 16-byte unit a lane of a warp;
//   - the unit is the widest of 16, 8, 4 and 2 bytes that divides the row
//     and both pointers' alignment.
// It never converts a value, so it serves f32 and bf16 tables alike.  An
// index outside [0, n) writes all-one bits (a NaN in f32 and in bf16), like
// jnp.take's fill mode, instead of reading out of bounds.
#include "common.cuh"

namespace {

constexpr int kThreadsG = 256;

template <typename I, typename T, int G>
__global__ void __launch_bounds__(kThreadsG)
    gather_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                  T* __restrict__ out, int n, int rows, int width) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * (kThreadsG / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  long long src = 0;
  if (lane == 0 && r < rows) src = (long long)idx[(size_t)b * rows + r];
  if (G > 1) src = __shfl_sync(0xffffffffu, src, 0, G);
  if (r >= rows) return;
  T* dst = out + ((size_t)b * rows) * width + r * width;
  if (src >= 0 && src < n) {
    const T* row = table + ((size_t)b * n) * width + (int)src * width;
    for (int w = lane; w < width; w += G) dst[w] = row[w];
  } else {
    T ones;
    memset(&ones, 0xff, sizeof(T));
    for (int w = lane; w < width; w += G) dst[w] = ones;
  }
}

template <typename I, typename T, int G>
int launch_g(const void* table, const void* idx, void* out, int b, int n,
             int rows, int width, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreadsG / G;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, b);
  gather_kernel<I, T, G><<<grid, kThreadsG, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const I*>(idx),
      static_cast<T*>(out), n, rows, width);
  return (int)cudaGetLastError();
}

template <typename I, typename T>
int launch(const void* table, const void* idx, void* out, int b, int n,
           int rows, int row_bytes, cudaStream_t s) {
  const int width = row_bytes / (int)sizeof(T);
  if (b == 0 || rows == 0) return (int)cudaGetLastError();
  if (row_bytes <= 16)
    return launch_g<I, T, 1>(table, idx, out, b, n, rows, width, s);
  if (width >= 32)
    return launch_g<I, T, 32>(table, idx, out, b, n, rows, width, s);
  if (width >= 16)
    return launch_g<I, T, 16>(table, idx, out, b, n, rows, width, s);
  if (width >= 8)
    return launch_g<I, T, 8>(table, idx, out, b, n, rows, width, s);
  if (width >= 4)
    return launch_g<I, T, 4>(table, idx, out, b, n, rows, width, s);
  return launch_g<I, T, 2>(table, idx, out, b, n, rows, width, s);
}

template <typename I>
int gather_rows(const void* table, const void* idx, void* out, int b, int n,
                int rows, int row_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
      (uintptr_t)row_bytes;
  if (align % 16 == 0)
    return launch<I, uint4>(table, idx, out, b, n, rows, row_bytes, s);
  if (align % 8 == 0)
    return launch<I, uint2>(table, idx, out, b, n, rows, row_bytes, s);
  if (align % 4 == 0)
    return launch<I, uint32_t>(table, idx, out, b, n, rows, row_bytes, s);
  return launch<I, uint16_t>(table, idx, out, b, n, rows, row_bytes, s);
}

}  // namespace

// table [b, n, row_bytes] (any element type), idx [b, rows] int32 or int64
// -> out [b, rows, row_bytes].  row_bytes must be even, and n * row_bytes
// and rows * row_bytes below 2^31.
PRIFIT_API int gather_rows_i32(const void* table, const void* idx, void* out,
                               int b, int n, int rows, int row_bytes,
                               void* stream) {
  return gather_rows<int>(table, idx, out, b, n, rows, row_bytes, stream);
}

PRIFIT_API int gather_rows_i64(const void* table, const void* idx, void* out,
                               int b, int n, int rows, int row_bytes,
                               void* stream) {
  return gather_rows<long long>(table, idx, out, b, n, rows, row_bytes,
                                stream);
}
