// Pieces shared by the sweep kernels (gmm_sweep.cu: B1/B2,
// gmm_grouped.cu: B4): the metric transform of a dot product, the top-p
// order, and the warp-level sums of the row-streaming dot loops.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

enum Mode { kSqEuclidean = 0, kEuclidean = 1, kDot = 2, kCosine = 3 };

template <int MODE>
__device__ __forceinline__ float transform(float dot, float xs, float cs) {
  if (MODE == kSqEuclidean || MODE == kEuclidean) {
    const float d2 = fmaxf((xs + cs) - 2.0f * dot, 0.0f);
    return MODE == kEuclidean ? sqrtf(d2) : d2;
  } else if (MODE == kDot) {
    return -dot;
  } else {
    return acosf(fminf(fmaxf(dot, -1.0f), 1.0f));
  }
}

// the top-p order: larger value first, ties to the lower index
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
