// K-max backward, pass 1 of 2: tie counts and the tie-shared cotangent.
//
// For each row r and feature f of the K-max region's last layer
// (relu(a * z + c), maxed over K neighbours):
//   cnt[r, f] = #{k : z[r*K + k, f] == zsel[r, f]}          (>= 1)
//   gsm[r, f] = (out[r, f] > 0 ? g[r, f] : 0) / cnt[r, f]
// with gsm stochastically rounded to bf16 (sr.cuh, flat index over
// [rows, F]) when the region rounds its cotangents, f32 otherwise.  The
// storage (z, zsel, out) is bf16, or f32 for the f32-storage K-max region
// (nn/mixed.py::mx_chain(storage=float32)), which never rounds: there gsm
// is f32.
//
// Replaces the TPU kernel prifit_tpu/ops/pallas/max_bwd.py::_cnt_gsm_kernel
// (cnt_gsm_pallas), which walks VMEM row tiles of z.  Its oracle is the jnp
// branch of prifit_tpu/nn/mixed.py::_max_bwd_core.
//
// Bound on the H100: bytes.  z [rows*K, F] bf16 is read once (0.96 GB
// summed over the six regions of a train step at B=24, N=2048; twice that
// at f32 storage); zsel, g, out and the two outputs are K times smaller.  A thread owns 8 adjacent
// features of one row (16-byte loads, so a warp reads whole 128-byte lines
// of each z row) and walks the K rows of its group with the loads
// unrolled, counting ties in registers: the [rows, K, F] mask never
// exists.  blockDim.x covers F, blockDim.y stacks rows.  The quotient is
// IEEE division (__fdiv_rn), as the plain version's is.
#include "common.cuh"
#include "sr.cuh"

namespace {

template <int VEC, typename Z, typename G, typename OUT>
__global__ void cnt_gsm_kernel(const Z* __restrict__ z,
                               const Z* __restrict__ zsel,
                               const G* __restrict__ g,
                               const Z* __restrict__ out_bf,
                               float* __restrict__ cnt, OUT* __restrict__ gsm,
                               long long rows, int K, int F, uint32_t seed) {
  const int c0 = threadIdx.x * VEC;
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < rows; r += step) {
    const size_t o = (size_t)r * F + c0;
    float zs[VEC];
    load_vec<VEC>(zsel + o, zs);
    int n[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) n[i] = 0;
    const Z* zr = z + (size_t)r * K * F + c0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float zv[VEC];
      load_vec<VEC>(zr + (size_t)k * F, zv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) n[i] += zv[i] == zs[i];
    }
    float ob[VEC], gv[VEC], c[VEC], q[VEC];
    load_vec<VEC>(out_bf + o, ob);
    load_vec<VEC>(g + o, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      c[i] = (float)n[i];
      q[i] = __fdiv_rn(ob[i] > 0.0f ? gv[i] : 0.0f, c[i]);
    }
    store_vec<VEC>(cnt + o, c);
    store_out<VEC>(gsm + o, q, (uint32_t)o, seed);
  }
}

template <int VEC, typename Z, typename G, typename OUT>
int launch(const void* z, const void* zsel, const void* g, const void* out_bf,
           void* cnt, void* gsm, long long rows, int K, int F, uint32_t seed,
           cudaStream_t stream) {
  const int tx = F / VEC;
  if (tx > 1024) return (int)cudaErrorInvalidValue;
  const int ty = tx >= 256 ? 1 : 256 / tx;
  long long blocks = (rows + ty - 1) / ty;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  cnt_gsm_kernel<VEC, Z, G, OUT><<<(int)blocks, dim3(tx, ty), 0, stream>>>(
      static_cast<const Z*>(z), static_cast<const Z*>(zsel),
      static_cast<const G*>(g), static_cast<const Z*>(out_bf),
      static_cast<float*>(cnt), static_cast<OUT*>(gsm), rows, K, F, seed);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch(const void* z, const void* zsel, const void* g, int g_f32,
             const void* out_bf, void* cnt, void* gsm, int sr, int z_f32,
             long long rows, int K, int F, uint32_t seed, cudaStream_t s) {
  if (z_f32) {
    // f32 storage never rounds: gsm is f32
    if (sr) return (int)cudaErrorInvalidValue;
    return g_f32 ? launch<VEC, float, float, float>(z, zsel, g, out_bf, cnt,
                                                     gsm, rows, K, F, seed, s)
                 : launch<VEC, float, uint16_t, float>(
                       z, zsel, g, out_bf, cnt, gsm, rows, K, F, seed, s);
  }
  if (g_f32) {
    return sr ? launch<VEC, uint16_t, float, uint16_t>(
                    z, zsel, g, out_bf, cnt, gsm, rows, K, F, seed, s)
              : launch<VEC, uint16_t, float, float>(z, zsel, g, out_bf, cnt,
                                                    gsm, rows, K, F, seed, s);
  }
  return sr ? launch<VEC, uint16_t, uint16_t, uint16_t>(
                  z, zsel, g, out_bf, cnt, gsm, rows, K, F, seed, s)
            : launch<VEC, uint16_t, uint16_t, float>(z, zsel, g, out_bf, cnt,
                                                     gsm, rows, K, F, seed, s);
}

}  // namespace

// z [rows*K, F]; zsel, out_bf [rows, F], all bf16, or all f32 (z_f32);
// g [rows, F] bf16 or f32 (g_f32) -> cnt [rows, F] f32, gsm [rows, F] bf16
// (sr, bf16 storage only) or f32.  seed = key[0] * 0x85EBCA6B + key[1].
// vec8: F % 8 == 0 and every pointer 16-byte aligned.
PRIFIT_API int max_bwd_cnt_gsm(const void* z, const void* zsel, const void* g,
                               int g_f32, const void* out_bf, void* cnt,
                               void* gsm, int sr, int z_f32, long long rows,
                               int K, int F, unsigned int seed, int vec8,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec8)
    return dispatch<8>(z, zsel, g, g_f32, out_bf, cnt, gsm, sr, z_f32, rows,
                       K, F, seed, s);
  return dispatch<1>(z, zsel, g, g_f32, out_bf, cnt, gsm, sr, z_f32, rows, K,
                     F, seed, s);
}
