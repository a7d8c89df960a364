// Helpers shared by the port's CUDA kernels.  Each .cu file is built on its
// own into a shared library with a plain C interface (kernels/build.py) and
// includes this header once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PRIFIT_API extern "C" __attribute__((visibility("default")))

// Lets the Python wrapper name the error a launch returned.
PRIFIT_API const char* prifit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (value, index) merges with a total order: ties go to the LOWER index, as
// jnp.argmax / jnp.argmin (first occurrence) do.  Being a total order makes
// a reduction's answer independent of its merge order.
__device__ __forceinline__ void merge_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void merge_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}
