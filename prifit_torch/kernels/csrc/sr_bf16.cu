// Stochastic rounding of an f32 tensor to bf16: y = sr(x) with counter-hash
// bits over the flat index (sr.cuh).
//
// No TPU kernel: in the JAX package this cast is an XLA fusion
// (prifit_tpu/nn/mixed.py::sr_bf16 with the default hash bits), applied to
// the mixed-precision region's inter-layer cotangents (dz, dx) and its exit
// cotangents.  Done as plain PyTorch it would be a dozen full passes of
// int64 temporaries over tensors of up to 200 M elements.
//
// Bound on the H100: bytes.  Each input value is read once (4 bytes) and
// each output written once (2 bytes); the hash is ~12 integer operations
// per element, far below the card's integer rate.  A thread takes 8
// consecutive values (two 16-byte loads, one 16-byte store) in a
// grid-stride loop, so neighbouring threads touch neighbouring addresses;
// a tensor whose size or address does not allow that takes one value per
// thread.
#include "common.cuh"
#include "sr.cuh"

namespace {

template <int VEC>
__global__ void sr_kernel(const float* __restrict__ x, uint16_t* __restrict__ y,
                          long long n_vec, uint32_t seed) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    float v[VEC];
    load_vec<VEC>(x + i * VEC, v);
    store_out<VEC>(y + i * VEC, v, (uint32_t)(i * VEC), seed);
  }
}

template <int VEC>
int launch(const float* x, uint16_t* y, long long n, uint32_t seed,
           cudaStream_t stream) {
  const long long n_vec = n / VEC;
  if (n_vec == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  sr_kernel<VEC><<<(int)blocks, threads, 0, stream>>>(x, y, n_vec, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n] f32 -> y [n] bf16 bits.  seed = key[0] * 0x85EBCA6B + key[1].
PRIFIT_API int sr_bf16(const void* x, void* y, long long n, unsigned int seed,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint16_t* yb = static_cast<uint16_t*>(y);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (n % 8 == 0 && align % 16 == 0) return launch<8>(xf, yb, n, seed, s);
  return launch<1>(xf, yb, n, seed, s);
}
