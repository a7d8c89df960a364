// Stochastic rounding f32 -> bf16 with counter-hash bits, shared by the
// kernels that round (max_bwd_cnt_gsm.cu, max_bwd_dz.cu, sr_bf16.cu) so that
// all of them produce the same bits.
//
// The bits are those of prifit_tpu/nn/mixed.py::_hash_bits16: a Weyl step
// and a splitmix32 finalizer over the element's GLOBAL linear index in the
// tensor's row-major order (uint32, wrapping), seeded with
// seed = key[0] * 0x85EBCA6B + key[1] (computed by the caller).  A
// tile-local index would give other bits.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t hash_bits16(uint32_t lin, uint32_t seed) {
  uint32_t x = lin * 0x9E3779B9u + seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return x >> 16;
}

// The bf16 bit pattern of sr(v): add 16 random low bits to the f32 pattern
// and keep the top half (the carry fires with the truncated fraction's
// probability).
__device__ __forceinline__ uint16_t sr_bf16_bits(float v, uint32_t lin,
                                                 uint32_t seed) {
  return (uint16_t)((__float_as_uint(v) + hash_bits16(lin, seed)) >> 16);
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t u) {
  return __uint_as_float((uint32_t)u << 16);
}

// VEC consecutive values as floats: bf16 (uint16_t bits) or f32.  VEC == 8
// reads 16 bytes (bf16) or 32 bytes (f32), so the caller guarantees 16-byte
// alignment; VEC == 1 reads one value.
template <int VEC>
__device__ __forceinline__ void load_vec(const uint16_t* __restrict__ p,
                                         float* out) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = bf16_bits_to_float(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float* out) {
  if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float* v) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(uint16_t* __restrict__ p,
                                          const uint16_t* v) {
  if constexpr (VEC == 8) {
    uint4 u;
    u.x = v[0] | ((uint32_t)v[1] << 16);
    u.y = v[2] | ((uint32_t)v[3] << 16);
    u.z = v[4] | ((uint32_t)v[5] << 16);
    u.w = v[6] | ((uint32_t)v[7] << 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// VEC results to the output: f32 as they are, or bf16 stochastically rounded
// with the linear indices lin0 .. lin0 + VEC - 1.
template <int VEC>
__device__ __forceinline__ void store_out(float* __restrict__ p,
                                          const float* v, uint32_t, uint32_t) {
  store_vec<VEC>(p, v);
}

template <int VEC>
__device__ __forceinline__ void store_out(uint16_t* __restrict__ p,
                                          const float* v, uint32_t lin0,
                                          uint32_t seed) {
  uint16_t b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) b[i] = sr_bf16_bits(v[i], lin0 + i, seed);
  store_vec<VEC>(p, b);
}
