// Block-parallel farthest-point sampling, one leaf block per CTA.
//
// Replaces the Pallas TPU kernel `fps_blocks` / `_fps_kernel` of
// src/repro/kernels/fps.py (oracle: `_fps_one` in src/repro/kernels/ref.py).
//
// Contract: start at the first valid lane (lane 0 of an empty block); keep a
// running min-d^2 with invalid and picked lanes pinned to NEG; k-1 argmax
// steps, lowest lane on ties; once every valid lane is picked (max <= NEG)
// repeat the previous pick.
//
// What bounds it: the k-1 steps are sequential and each needs a block-wide
// argmax, so it is latency-bound (two __syncthreads and a shuffle tree per
// step), not bound by bytes (a block reads 13 bytes a point once) or by
// operations (9 flops a point a step).
//
// Design: one thread per point (up to 8 per thread for blocks wider than
// 1024), coordinates and min-d^2 in registers for the whole loop; the pick's
// coordinates come from the L1-resident input; a (value, index) shuffle
// reduction per warp then one warp across warps.  An empty block writes its
// zeros and leaves at once, since most slots of a static leaf layout are
// empty.  A block wider than 8192 lanes keeps min-d^2 in a scratch row that
// the wrapper allocates (fps_wide_kernel), with the same arithmetic, and
// rereads its coordinates each step from the L2-resident input.
#include "common.cuh"

namespace {

using namespace fc;

// Every thread's first valid lane -> the block's (bs if none).
__device__ inline int block_first(int first, int* red_i, int* s_pick) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
  if (lane == 0) red_i[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int f = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      f = min(f, __shfl_xor_sync(0xffffffffu, f, off));
    if (lane == 0) *s_pick = f;
  }
  __syncthreads();
  return *s_pick;
}

// Every thread's (max min-d^2, lane) -> the block's pick, or `prev` once
// every lane is NEG.
__device__ inline int block_pick(float bv, int bi, int prev, float* red_v,
                                 int* red_i, int* s_pick) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  warp_argmax(bv, bi);
  if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? red_v[lane] : FC_NEG;
    int i = lane < nwarps ? red_i[lane] : 0x7fffffff;
    warp_argmax(v, i);
    if (lane == 0) *s_pick = (v > FC_NEG) ? i : prev;
  }
  __syncthreads();
  return *s_pick;
}

// Bounded at 1024 threads so that every variant fits the register file
// (64K registers an SM): the wider ones would otherwise take up to 80 a
// thread and fail to launch.
template <int PPT>
__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ coords,
               const uint8_t* __restrict__ mask, int32_t* __restrict__ idx,
               int bs, int k) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const float* c = coords + (size_t)b * bs * 3;
  const uint8_t* m = mask + (size_t)b * bs;
  int32_t* out = idx + (size_t)b * k;

  float px[PPT], py[PPT], pz[PPT], mind[PPT];
  bool ok[PPT];
  int first = bs;
#pragma unroll
  for (int t = 0; t < PPT; ++t) {
    int i = threadIdx.x + t * blockDim.x;
    ok[t] = false;
    px[t] = py[t] = pz[t] = 0.0f;
    if (i < bs) {
      px[t] = c[3 * i];
      py[t] = c[3 * i + 1];
      pz[t] = c[3 * i + 2];
      ok[t] = m[i] != 0;
      if (ok[t] && i < first) first = i;
    }
  }
  first = block_first(first, red_i, &s_pick);
  if (first >= bs) {  // empty block: start 0, every step repeats it
    for (int j = threadIdx.x; j < k; j += blockDim.x) out[j] = 0;
    return;
  }

  int prev = first;
  if (threadIdx.x == 0) out[0] = first;
  for (int j = 1; j < k; ++j) {
    // Fold the last pick into min-d^2 and pin it.
    const float qx = c[3 * prev], qy = c[3 * prev + 1], qz = c[3 * prev + 2];
    float bv = FC_NEG;
    int bi = 0x7fffffff;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      int i = threadIdx.x + t * blockDim.x;
      float dx = __fsub_rn(px[t], qx), dy = __fsub_rn(py[t], qy),
            dz = __fsub_rn(pz[t], qz);
      float d = ok[t] ? sqnorm3(dx, dy, dz) : FC_NEG;
      float mv = (j == 1) ? d : fminf(mind[t], d);
      if (i == prev || i >= bs) mv = FC_NEG;
      mind[t] = mv;
      if (mv > bv) { bv = mv; bi = i; }
    }
    prev = block_pick(bv, bi, prev, red_v, red_i, &s_pick);
    if (threadIdx.x == 0) out[j] = prev;
  }
}

// Blocks wider than 8 lanes a thread: min-d^2 in the scratch row `mind`
// (NB, BS), coordinates reread each step.  After the first step an invalid
// or picked lane holds NEG, and fminf(NEG, d) is NEG, so the mask is read
// once, as the register variant's `ok` does.
__global__ void __launch_bounds__(1024)
    fps_wide_kernel(const float* __restrict__ coords,
                    const uint8_t* __restrict__ mask,
                    int32_t* __restrict__ idx, float* __restrict__ mind,
                    int bs, int k) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const float* c = coords + (size_t)b * bs * 3;
  const uint8_t* m = mask + (size_t)b * bs;
  float* md = mind + (size_t)b * bs;
  int32_t* out = idx + (size_t)b * k;

  int first = bs;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) {
    if (m[i]) {
      first = i;
      break;
    }
  }
  first = block_first(first, red_i, &s_pick);
  if (first >= bs) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) out[j] = 0;
    return;
  }

  int prev = first;
  if (threadIdx.x == 0) out[0] = first;
  for (int j = 1; j < k; ++j) {
    const float qx = c[3 * prev], qy = c[3 * prev + 1], qz = c[3 * prev + 2];
    float bv = FC_NEG;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < bs; i += blockDim.x) {
      float dx = __fsub_rn(c[3 * i], qx), dy = __fsub_rn(c[3 * i + 1], qy),
            dz = __fsub_rn(c[3 * i + 2], qz);
      float d = sqnorm3(dx, dy, dz);
      float mv = (j == 1) ? (m[i] ? d : FC_NEG) : fminf(md[i], d);
      if (i == prev) mv = FC_NEG;
      md[i] = mv;
      if (mv > bv) { bv = mv; bi = i; }
    }
    prev = block_pick(bv, bi, prev, red_v, red_i, &s_pick);
    if (threadIdx.x == 0) out[j] = prev;
  }
}

template <int PPT>
cudaError_t launch(const float* coords, const uint8_t* mask, int32_t* idx,
                   int nb, int bs, int k, int threads, cudaStream_t stream) {
  fps_kernel<PPT><<<nb, threads, 0, stream>>>(coords, mask, idx, bs, k);
  return cudaGetLastError();
}

}  // namespace

// `scratch`: (NB, BS) floats, needed only when BS > 8192.
extern "C" int fc_fps_blocks(const float* coords, const uint8_t* mask,
                             int32_t* idx, float* scratch, int nb, int bs,
                             int k, void* stream) {
  if (nb == 0 || k == 0) return 0;
  if (bs < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bs > 8 * 1024) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    fps_wide_kernel<<<nb, 1024, 0, s>>>(coords, mask, idx, scratch, bs, k);
    return (int)cudaGetLastError();
  }
  int threads = bs < 1024 ? ((bs + 31) / 32) * 32 : 1024;
  int ppt = (bs + threads - 1) / threads;
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(coords, mask, idx, nb, bs, k, threads, s);
  else if (ppt <= 2) err = launch<2>(coords, mask, idx, nb, bs, k, threads, s);
  else if (ppt <= 4) err = launch<4>(coords, mask, idx, nb, bs, k, threads, s);
  else err = launch<8>(coords, mask, idx, nb, bs, k, threads, s);
  return (int)err;
}
