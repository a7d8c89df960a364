// Batched row gather: out[b, r, :] = table[b, idx[b, r], :], bit-exact.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/gather.py::_gather_kernel
// (gather_rows_pallas / index_points_dg), whose lane-shuffle design exists
// because the TPU has no fast row gather.  Here a row gather is a plain copy.
//
// Bound on the H100: bytes.  Each output word is read once from the table
// (through L2, where the [N, C] table of a shape stays resident) and written
// once.  The design copies in the widest unit that divides the row and both
// pointers' alignment (16, 4 or 2 bytes), one unit per thread in a
// grid-stride loop, so neighbouring threads touch neighbouring addresses of
// the output.  It never converts a value, so it serves f32 and bf16 tables
// alike.  An index outside [0, n) writes all-one bits (a NaN in f32 and in
// bf16), like jnp.take's fill mode, instead of reading out of bounds.
#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_kernel(const T* __restrict__ table,
                              const int* __restrict__ idx, T* __restrict__ out,
                              int n, long long rows, int width,
                              long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / width;  // b * rows + r
    const int w = (int)(t - row * width);
    const long long b = row / rows;
    const int src = idx[row];
    T v;
    if (src >= 0 && src < n) {
      v = table[((size_t)b * n + src) * width + w];
    } else {
      memset(&v, 0xff, sizeof(T));
    }
    out[t] = v;
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, int b, int n,
           long long rows, int row_bytes, cudaStream_t stream) {
  const int width = row_bytes / (int)sizeof(T);
  const long long total = (long long)b * rows * width;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  gather_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<T*>(out), n, rows, width, total);
  return (int)cudaGetLastError();
}

}  // namespace

// table [b, n, row_bytes] (any element type), idx [b, rows] i32
// -> out [b, rows, row_bytes].  row_bytes must be even.
PRIFIT_API int gather_rows(const void* table, const void* idx, void* out,
                           int b, int n, long long rows, int row_bytes,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
      (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch<uint4>(table, idx, out, b, n, rows, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(table, idx, out, b, n, rows, row_bytes, s);
  return launch<uint16_t>(table, idx, out, b, n, rows, row_bytes, s);
}
