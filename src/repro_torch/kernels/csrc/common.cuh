// Shared device helpers of the point kernels (fp32, int32 indices).
//
// Every float operation that the plain PyTorch versions spell out as a
// separate tensor op is written here with an `__f*_rn` intrinsic, so nvcc
// cannot contract it into an FMA and the kernels round exactly as the plain
// versions do (see repro_torch/kernels/common.py for the order).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FC_NEG (-3.0e38f)
#define FC_INF (3.0e38f)

namespace fc {

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// Expanded form: (|a|^2 + |b|^2) - 2 a.b.
__device__ __forceinline__ float expanded_d2(float a2, float b2, float cross) {
  return __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, cross));
}

// (value, index) pair order for a maximum: larger value, then lower index.
__device__ __forceinline__ bool max_before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (max_before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

}  // namespace fc
