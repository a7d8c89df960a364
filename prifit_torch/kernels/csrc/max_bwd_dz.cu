// K-max backward, pass 2 of 2: the closed-form cotangent of z.
//
//   dz[r*K + k, f] = a[f] * (z == zsel[r, f] ? gsm[r, f] : 0) - c1[f]
//                    - (z - mean[f]) * c2[f]
// with dz stochastically rounded to bf16 (sr.cuh, flat index over
// [rows*K, F]) when the region rounds its cotangents (gsm is then bf16),
// f32 otherwise (gsm f32).  z and zsel are bf16, or f32 for the
// f32-storage K-max region, which never rounds.  a = inv * scale, c1 and c2 come from the
// caller's reductions of pass 1's outputs over all rows, which is why
// there are two passes.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/max_bwd.py::_dz_kernel
// (dz_pallas).  Its oracle is the jnp branch of
// prifit_tpu/nn/mixed.py::_max_bwd_core.  The arithmetic is written with
// __fmul_rn / __fsub_rn in the oracle's order, so nvcc cannot contract it
// into FMAs: the plain version rounds every product and difference, and a
// different f32 value would move a stochastic-rounding carry.
//
// Bound on the H100: bytes.  z is read once and dz written once (0.96 GB
// each in bf16 over the six regions of a train step at B=24, N=2048; z is
// twice that at f32 storage).  A
// thread owns 8 adjacent features (16-byte loads and stores) at a fixed
// column for the whole grid-stride loop over z rows, so its a, c1, mean
// and c2 live in registers, loaded once; zsel and gsm rows are re-read by
// the K z rows that share them, from L1/L2.  The [rows, K, F] broadcasts
// of gsm and zsel that XLA materialized on the TPU never exist.
#include <type_traits>

#include "common.cuh"
#include "sr.cuh"

namespace {

// gsm's element type: bf16 bits when dz is rounded to bf16, f32 otherwise.
template <typename OUT>
using GsmT = typename std::conditional<std::is_same<OUT, float>::value, float,
                                       uint16_t>::type;

template <int VEC, typename Z, typename OUT>
__global__ void dz_kernel(const Z* __restrict__ z,
                          const Z* __restrict__ zsel,
                          const GsmT<OUT>* __restrict__ gsm,
                          const float* __restrict__ a,
                          const float* __restrict__ c1,
                          const float* __restrict__ mean,
                          const float* __restrict__ c2, OUT* __restrict__ dz,
                          long long nz, int K, int F, uint32_t seed) {
  const int c0 = threadIdx.x * VEC;
  float av[VEC], c1v[VEC], mv[VEC], c2v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    av[i] = a[c0 + i];
    c1v[i] = c1[c0 + i];
    mv[i] = mean[c0 + i];
    c2v[i] = c2[c0 + i];
  }
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long zr = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       zr < nz; zr += step) {
    const size_t orow = (size_t)(zr / K) * F + c0;
    const size_t o = (size_t)zr * F + c0;
    float zs[VEC], gs[VEC], zv[VEC], d[VEC];
    load_vec<VEC>(zsel + orow, zs);
    load_vec<VEC>(gsm + orow, gs);
    load_vec<VEC>(z + o, zv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float sel = zv[i] == zs[i] ? gs[i] : 0.0f;
      d[i] = __fsub_rn(__fsub_rn(__fmul_rn(av[i], sel), c1v[i]),
                       __fmul_rn(__fsub_rn(zv[i], mv[i]), c2v[i]));
    }
    store_out<VEC>(dz + o, d, (uint32_t)o, seed);
  }
}

template <int VEC, typename Z, typename OUT>
int launch(const void* z, const void* zsel, const void* gsm, const float* a,
           const float* c1, const float* mean, const float* c2, void* dz,
           long long nz, int K, int F, uint32_t seed, cudaStream_t stream) {
  const int tx = F / VEC;
  if (tx > 1024) return (int)cudaErrorInvalidValue;
  const int ty = tx >= 256 ? 1 : 256 / tx;
  long long blocks = (nz + ty - 1) / ty;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  dz_kernel<VEC, Z, OUT><<<(int)blocks, dim3(tx, ty), 0, stream>>>(
      static_cast<const Z*>(z), static_cast<const Z*>(zsel),
      static_cast<const GsmT<OUT>*>(gsm), a, c1, mean, c2,
      static_cast<OUT*>(dz), nz, K, F, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// z [rows*K, F] and zsel [rows, F], both bf16 or both f32 (z_f32); gsm
// [rows, F] bf16 (sr, bf16 storage only) or f32; a, c1, mean, c2 [F] f32 ->
// dz [rows*K, F] bf16 (sr) or f32.  seed = key[0] * 0x85EBCA6B + key[1].
// vec8: F % 8 == 0 and every [.., F] pointer 16-byte aligned.
PRIFIT_API int max_bwd_dz(const void* z, const void* zsel, const void* gsm,
                          const void* a, const void* c1, const void* mean,
                          const void* c2, void* dz, int sr, int z_f32,
                          long long rows, int K, int F, unsigned int seed,
                          int vec8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* av = static_cast<const float*>(a);
  const float* c1v = static_cast<const float*>(c1);
  const float* mv = static_cast<const float*>(mean);
  const float* c2v = static_cast<const float*>(c2);
  const long long nz = rows * K;
  if (z_f32) {
    // f32 storage never rounds: gsm and dz are f32
    if (sr) return (int)cudaErrorInvalidValue;
    return vec8 ? launch<8, float, float>(z, zsel, gsm, av, c1v, mv, c2v, dz,
                                          nz, K, F, seed, s)
                : launch<1, float, float>(z, zsel, gsm, av, c1v, mv, c2v, dz,
                                          nz, K, F, seed, s);
  }
  if (vec8) {
    return sr ? launch<8, uint16_t, uint16_t>(z, zsel, gsm, av, c1v, mv, c2v,
                                              dz, nz, K, F, seed, s)
              : launch<8, uint16_t, float>(z, zsel, gsm, av, c1v, mv, c2v, dz,
                                           nz, K, F, seed, s);
  }
  return sr ? launch<1, uint16_t, uint16_t>(z, zsel, gsm, av, c1v, mv, c2v, dz,
                                            nz, K, F, seed, s)
            : launch<1, uint16_t, float>(z, zsel, gsm, av, c1v, mv, c2v, dz,
                                         nz, K, F, seed, s);
}
