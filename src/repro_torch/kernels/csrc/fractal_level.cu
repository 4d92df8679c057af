// One fractal partition level per block, one block per CTA.
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
// Design: the TPU kernel holds a whole node in VMEM as (3, BS) lanes; here
// a CTA takes one block, its threads stride over the BS lanes (one lane a
// thread at the main path's BS=256), write the side bits, and keep a count
// and four extrema in registers, reduced by warp shuffles and then across
// the CTA's warps through shared memory.  No atomics, nothing carried
// between CTAs.
#include "common.cuh"

namespace {

using namespace fc;

constexpr int kMaxWarps = 8;

__global__ void __launch_bounds__(kMaxWarps * 32)
fractal_level_kernel(const float* __restrict__ coords,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ mid, int32_t* __restrict__ side,
                     int32_t* __restrict__ lcnt, float* __restrict__ stats,
                     int bs, int da, int db) {
  __shared__ int s_cnt[kMaxWarps];
  __shared__ float s_ext[kMaxWarps][4];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* c = coords + (size_t)b * bs * 3;
  const uint8_t* m = mask + (size_t)b * bs;
  int32_t* s = side + (size_t)b * bs;
  const float split = mid[b];
  const float inf = __int_as_float(0x7f800000);

  // Every lane contributes its value or the sentinel, as the plain
  // version's masked min/max does, so the two agree on every input.
  int cnt = 0;
  float lmin = inf, lmax = -inf, rmin = inf, rmax = -inf;
  for (int j = threadIdx.x; j < bs; j += blockDim.x) {
    const float xa = c[3 * j + da];
    const float xb = c[3 * j + db];
    const bool ok = m[j] != 0;
    const bool right = ok && xa > split;
    const bool left = ok && !right;
    s[j] = right ? 1 : 0;
    cnt += left ? 1 : 0;
    lmin = fminf(lmin, left ? xb : FC_INF);
    lmax = fmaxf(lmax, left ? xb : FC_NEG);
    rmin = fminf(rmin, right ? xb : FC_INF);
    rmax = fmaxf(rmax, right ? xb : FC_NEG);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, off));
    lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    rmin = fminf(rmin, __shfl_xor_sync(0xffffffffu, rmin, off));
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_ext[warp][0] = lmin;
    s_ext[warp][1] = lmax;
    s_ext[warp][2] = rmin;
    s_ext[warp][3] = rmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w) {
      cnt += s_cnt[w];
      lmin = fminf(lmin, s_ext[w][0]);
      lmax = fmaxf(lmax, s_ext[w][1]);
      rmin = fminf(rmin, s_ext[w][2]);
      rmax = fmaxf(rmax, s_ext[w][3]);
    }
    lcnt[b] = cnt;
    float* st = stats + (size_t)b * 4;
    st[0] = lmin;
    st[1] = lmax;
    st[2] = rmin;
    st[3] = rmax;
  }
}

}  // namespace

extern "C" int fc_fractal_level_blocks(const float* coords,
                                       const uint8_t* mask, const float* mid,
                                       int32_t* side, int32_t* lcnt,
                                       float* stats, int nb, int bs, int da,
                                       int db, void* stream) {
  if (nb == 0) return 0;
  if (bs < 1 || da < 0 || da > 2 || db < 0 || db > 2)
    return (int)cudaErrorInvalidValue;
  // One warp per 32 lanes, at most kMaxWarps: a 33-lane block takes two.
  int warps = (bs + 31) / 32;
  if (warps > kMaxWarps) warps = kMaxWarps;
  fractal_level_kernel<<<nb, warps * 32, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      coords, mask, mid, side, lcnt, stats, bs, da, db);
  return (int)cudaGetLastError();
}
