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

// Launch geometry of one kernel call: the launch entry computes it, and
// the entry's query twin returns it without launching (variant -1: the
// shapes need no launch).
struct Geometry {
  int variant = -1;
  int grid[3] = {0, 0, 0};
  int threads = 0;
  int smem = 0;  // dynamic shared memory, bytes
};

// out[0..6) = variant, grid x, y, z, threads, dynamic shared memory.
inline void write_geometry(const Geometry& g, int* out) {
  out[0] = g.variant;
  out[1] = g.grid[0];
  out[2] = g.grid[1];
  out[3] = g.grid[2];
  out[4] = g.threads;
  out[5] = g.smem;
}

// cudaFuncGetAttributes of kernel `fn`, and how many CTAs of `threads`
// threads and `smem` dynamic bytes fit an SM.  out[0..5) = registers a
// thread, local bytes a thread, static shared memory, the function's most
// threads a block, CTAs an SM (0 where the launch would be refused).
// Raises the dynamic limit above 48 KB as the launch entries do.
inline cudaError_t func_attributes(const void* fn, int threads, int smem,
                                   int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  const bool fits = threads > 0 && threads <= a.maxThreadsPerBlock &&
                    (long long)smem + (long long)a.sharedSizeBytes <= optin;
  if (fits) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      (size_t)smem);
    if (e != cudaSuccess) return e;
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = ctas;
  return cudaSuccess;
}

}  // namespace fc
