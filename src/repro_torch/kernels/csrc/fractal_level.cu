// One fractal partition level per block, one block per warp.
//
// Replaces the Pallas TPU kernel `fractal_level_blocks` / `_level_kernel`
// of src/repro/kernels/fractal_engine.py (oracle: `fractal_level_blocks` in
// src/repro/kernels/ref.py).
//
// Contract: side = (x[da] > mid) & valid, strictly greater, so a lane at
// mid goes left; the left count counts valid lanes not on the side; the
// child stats are [min, max] of x[db] over the left lanes, then over the
// side lanes, INF / NEG where a side is empty.  Minimum, maximum and count
// are exact in any order, so the result equals the plain version's.
//
// What bounds it: bytes.  A lane costs a compare and four min/max against
// 8 bytes of coordinates, 1 of mask and 4 of side bits.
//
// Design: the TPU kernel holds a whole node in VMEM as (3, BS) lanes.
// Here one warp takes a block, eight blocks a CTA, so ~1.2 waves of warps
// cover the main path's 10,204 blocks where one CTA a block took ~10 waves
// of short CTAs, each ending in a __syncthreads and a serial fold.  The
// lanes stride over the block 256 lanes at a time: first every mask byte
// of the stretch, then the two coordinates of its valid lanes only (all
// loads of a stretch in flight together), then the side bits, written as
// coalesced rows.  Count and the four extrema fold by warp reductions
// only; every lane feeds its value or the INF / NEG sentinel to fminf /
// fmaxf, as the plain version's masked amin / amax do, so the two agree on
// every input.  No shared memory, no barrier, no atomics.
#include "common.cuh"

namespace {

using namespace fc;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

constexpr int kLevelWarps = 8;   // blocks a CTA works on at once
constexpr int kStretch = 8;      // lanes a thread loads before it computes

__global__ void __launch_bounds__(kLevelWarps * 32)
fractal_level_kernel(const float* __restrict__ coords,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ mid, int32_t* __restrict__ side,
                     int32_t* __restrict__ lcnt, float* __restrict__ stats,
                     int nb, int bs, int da, int db) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  const int b = blockIdx.x * kLevelWarps + (threadIdx.x >> 5);
  if (b >= nb) return;
  const float* c = coords + (size_t)b * bs * 3;
  const uint8_t* m = mask + (size_t)b * bs;
  int32_t* s = side + (size_t)b * bs;
  const float split = mid[b];
  int cnt = 0;
  float lmin = inf, lmax = -inf, rmin = inf, rmax = -inf;
  for (int base = 0; base < bs; base += 32 * kStretch) {
    bool ok[kStretch];
    float xa[kStretch], xb[kStretch];
#pragma unroll
    for (int u = 0; u < kStretch; ++u) {
      const int j = base + lane + 32 * u;
      ok[u] = j < bs && m[j] != 0;
    }
#pragma unroll
    for (int u = 0; u < kStretch; ++u) {
      const int j = base + lane + 32 * u;
      xa[u] = ok[u] ? c[3 * j + da] : 0.0f;
      xb[u] = ok[u] ? c[3 * j + db] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStretch; ++u) {
      const int j = base + lane + 32 * u;
      const bool right = ok[u] && xa[u] > split;
      const bool left = ok[u] && !right;
      if (j < bs) s[j] = right ? 1 : 0;
      cnt += left ? 1 : 0;
      lmin = fminf(lmin, left ? xb[u] : FC_INF);
      lmax = fmaxf(lmax, left ? xb[u] : FC_NEG);
      rmin = fminf(rmin, right ? xb[u] : FC_INF);
      rmax = fmaxf(rmax, right ? xb[u] : FC_NEG);
    }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  lmin = warp_min(lmin);
  lmax = warp_max(lmax);
  rmin = warp_min(rmin);
  rmax = warp_max(rmax);
  if (lane == 0) {
    lcnt[b] = cnt;
    float* st = stats + (size_t)b * 4;
    st[0] = lmin;
    st[1] = lmax;
    st[2] = rmin;
    st[3] = rmax;
  }
}

// The launch of one call: one warp a block, kLevelWarps blocks a CTA.
cudaError_t fractal_level_geometry(int nb, int bs, fc::Geometry* g) {
  if (nb == 0) return cudaSuccess;
  if (bs < 1) return cudaErrorInvalidValue;
  g->variant = 0;
  g->threads = kLevelWarps * 32;
  g->grid[0] = (nb + kLevelWarps - 1) / kLevelWarps;
  g->grid[1] = g->grid[2] = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int fc_fractal_level_blocks(const float* coords,
                                       const uint8_t* mask, const float* mid,
                                       int32_t* side, int32_t* lcnt,
                                       float* stats, int nb, int bs, int da,
                                       int db, void* stream) {
  fc::Geometry g;
  const cudaError_t e = fractal_level_geometry(nb, bs, &g);
  if (e != cudaSuccess || g.variant < 0) return (int)e;
  if (da < 0 || da > 2 || db < 0 || db > 2) return (int)cudaErrorInvalidValue;
  fractal_level_kernel<<<g.grid[0], g.threads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      coords, mask, mid, side, lcnt, stats, nb, bs, da, db);
  return (int)cudaGetLastError();
}

// fc_fractal_level_blocks's geometry for these shapes, without a launch.
extern "C" int fc_fractal_level_geometry(int nb, int bs, int* out) {
  fc::Geometry g;
  const cudaError_t e = fractal_level_geometry(nb, bs, &g);
  fc::write_geometry(g, out);
  return (int)e;
}

// Attributes of the one variant (0) at that launch.
extern "C" int fc_fractal_level_attributes(int variant, int threads,
                                           int smem, int* out) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return (int)fc::func_attributes(
      reinterpret_cast<const void*>(&fractal_level_kernel), threads, smem,
      out);
}
