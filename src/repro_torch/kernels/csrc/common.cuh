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

// (value, index) pair order for a minimum: smaller value, then lower index.
__device__ __forceinline__ bool min_before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// (value, index) pair order for a maximum: larger value, then lower index.
__device__ __forceinline__ bool max_before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (min_before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (max_before(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Window of one leaf block in shared memory, structure of arrays.
struct Window {
  float* x;
  float* y;
  float* z;
  float* n2;     // |w|^2
  uint8_t* ok;   // lane is a valid point
};

// Bytes of shared memory for a window of w lanes plus one distance row of
// w floats per warp.
__host__ __device__ inline size_t window_smem_bytes(int w, int warps) {
  return (size_t)w * (4 * sizeof(float)) + (size_t)warps * w * sizeof(float) +
         (((size_t)w + 15) / 16) * 16;
}

// Carve the window and the per-warp rows out of dynamic shared memory
// (floats first, so every float array stays 4-byte aligned).
__device__ inline Window carve_window(unsigned char* smem, int w, int warps,
                                      float** rows) {
  float* f = reinterpret_cast<float*>(smem);
  Window win;
  win.x = f;
  win.y = f + w;
  win.z = f + 2 * w;
  win.n2 = f + 3 * w;
  *rows = f + 4 * w;
  win.ok = reinterpret_cast<uint8_t*>(f + 4 * w + (size_t)warps * w);
  return win;
}

// Load block b's window (w, 3) and mask (w,) into shared memory.  Returns,
// to every thread, whether any lane is valid.
__device__ inline bool load_window(Window win, const float* __restrict__ pts,
                                   const uint8_t* __restrict__ mask, int w) {
  int any = 0;
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
    win.x[j] = x;
    win.y[j] = y;
    win.z[j] = z;
    win.n2[j] = sqnorm3(x, y, z);
    uint8_t ok = mask[j] != 0;
    win.ok[j] = ok;
    any |= ok;
  }
  return __syncthreads_or(any) != 0;
}

// One warp: distances of the query (qx, qy, qz) to every window lane into
// `row`, INF on invalid lanes.  Returns the lane count with d <= r2 among
// valid lanes (only when `count` is set), summed over the warp.
__device__ inline int fill_row(Window win, float* row, int w, float qx,
                               float qy, float qz, bool count, float r2) {
  const int lane = threadIdx.x & 31;
  const float q2 = sqnorm3(qx, qy, qz);
  int cnt = 0;
  for (int j = lane; j < w; j += 32) {
    float d = expanded_d2(q2, win.n2[j],
                          dot3(qx, qy, qz, win.x[j], win.y[j], win.z[j]));
    d = win.ok[j] ? d : FC_INF;
    row[j] = d;
    if (count) cnt += (win.ok[j] && d <= r2) ? 1 : 0;
  }
  if (count) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  __syncwarp();
  return cnt;
}

// One warp: `num` rounds of masked argmin over `row`; lane 0 writes the
// picks to out_idx/out_d2.  An exhausted row (every lane INF) gives lane 0
// with INF, as repeated argmin does.
__device__ inline void extract_row(float* row, int w, int num,
                                   int32_t* __restrict__ out_idx,
                                   float* __restrict__ out_d2) {
  const int lane = threadIdx.x & 31;
  for (int s = 0; s < num; ++s) {
    float bv = __int_as_float(0x7f800000);  // +inf: every lane beats it
    int bi = 0x7fffffff;
    for (int j = lane; j < w; j += 32) {
      float v = row[j];
      if (v < bv) { bv = v; bi = j; }
    }
    warp_argmin(bv, bi);
    if (lane == 0) {
      out_idx[s] = bi;
      out_d2[s] = bv;
    }
    if ((bi & 31) == lane) row[bi] = FC_INF;
    __syncwarp();
  }
}

}  // namespace fc
