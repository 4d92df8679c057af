// Block-parallel farthest-point sampling, one leaf block per warp (blocks
// of at most 512 lanes) or per CTA (wider blocks).
//
// Replaces the Pallas TPU kernel `fps_blocks` / `_fps_kernel` of
// src/repro/kernels/fps.py (oracle: `_fps_one` in src/repro/kernels/ref.py).
//
// Contract: start at the first valid lane (lane 0 of an empty block); keep a
// running min-d^2 with invalid and picked lanes pinned to NEG; k-1 argmax
// steps, lowest lane on ties; once every valid lane is picked (max <= NEG)
// repeat the previous pick.
//
// What bounds it: the k-1 steps are sequential and each needs an argmax
// over the block, so it is bound by the latency of a step (and, where many
// blocks are live on one SM, by the instructions a step issues), not by
// bytes (a block reads 13 bytes a point once) or by operations.
//
// Design.  Blocks of at most 512 lanes, which every path of the port uses
// (th = 256), run `fps_warp_kernel`: one warp a block, a CTA of one warp,
// so no step waits on a block-wide barrier and an empty block frees its
// slot at once.  Lane l keeps points l, l+32, ... (its slots) and their
// min-d^2 in registers; invalid lanes start at NEG and stay there (fminf),
// valid ones at +inf.  A step folds the pick into every slot, takes the
// lane's best slot by a tree, then the warp's pick by two redux.sync
// reductions (the largest value as an unsigned key, then the lowest index
// holding it), which leave it in every lane; the pick's coordinates come
// from the warp's copy of the block in shared memory (one broadcast load).  An empty block is found with one ballot over its mask
// and only writes its zeros.  The first design, one CTA of up to 1024
// threads a block with two __syncthreads, a second shuffle tree and a
// global load of the pick on every step, stays for blocks of 513 to 8192
// lanes (`fps_kernel`); wider blocks keep min-d^2 in a scratch row that the
// wrapper allocates (`fps_wide_kernel`), with the same arithmetic, and
// reread their coordinates each step from the L2-resident input.  The
// wrapper picks the variant (repro_torch/kernels/fps.py: `variant`).
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

// The best of a lane's S slots (S a power of two): the largest value, the
// lowest slot on ties.  A tree over neighbouring ranges, log2(S) deep,
// where the right range (the higher slots) wins only if strictly larger.
template <int S>
__device__ __forceinline__ void slot_argmax(const float (&v)[S], float& bv,
                                            int& bt) {
  float w[S];
  int ti[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    w[t] = v[t];
    ti[t] = t;
  }
#pragma unroll
  for (int step = 1; step < S; step *= 2) {
#pragma unroll
    for (int t = 0; t + step < S; t += 2 * step) {
      if (w[t + step] > w[t]) {
        w[t] = w[t + step];
        ti[t] = ti[t + step];
      }
    }
  }
  bv = w[0];
  bt = ti[0];
}

// (value, index) argmax over the warp for values that are >= 0 or NEG, as
// FPS's min-d^2 are: the largest value, then the lowest index; every lane
// gets it.  Two warp reductions (redux.sync) instead of five shuffle
// rounds: the bits of a non-negative float order as the float does, so
// the largest value is the largest key (NEG is key 0), and the pick is the
// lowest index among the lanes that hold it.  An all-NEG warp gives NEG.
__device__ __forceinline__ void warp_argmax_nonneg(float& v, int& i) {
  const unsigned key =
      v > FC_NEG ? (__float_as_uint(v) & 0x7fffffffu) + 1u : 0u;
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  i = __reduce_min_sync(0xffffffffu, key == top ? i : 0x7fffffff);
  v = top ? __uint_as_float(top - 1u) : FC_NEG;
}

constexpr int kWarpSlots = 16;   // points a lane: blocks of <= 512 lanes

// One warp (one CTA) a block of at most 32 * S lanes; slot t of lane l is
// lane l + 32 t of the block.
template <int S>
__global__ void __launch_bounds__(32)
    fps_warp_kernel(const float* __restrict__ coords,
                    const uint8_t* __restrict__ mask,
                    int32_t* __restrict__ idx, int bs, int k) {
  __shared__ float4 pts[32 * S];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const float* c = coords + (size_t)b * bs * 3;
  const uint8_t* m = mask + (size_t)b * bs;
  int32_t* out = idx + (size_t)b * k;

  unsigned ok = 0;  // bit t: slot t is a valid lane
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int i = lane + 32 * t;
    if (i < bs && m[i]) ok |= 1u << t;
  }
  if (__ballot_sync(0xffffffffu, ok != 0) == 0) {  // empty: start 0, repeat
    for (int j = lane; j < k; j += 32) out[j] = 0;
    return;
  }
  const int first = __reduce_min_sync(
      0xffffffffu, ok ? lane + 32 * (__ffs(ok) - 1) : 0x7fffffff);

  float px[S], py[S], pz[S], mind[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int i = lane + 32 * t;
    const bool v = (ok >> t) & 1u;
    px[t] = v ? c[3 * i] : 0.0f;
    py[t] = v ? c[3 * i + 1] : 0.0f;
    pz[t] = v ? c[3 * i + 2] : 0.0f;
    mind[t] = v ? __int_as_float(0x7f800000) : FC_NEG;
    pts[i] = make_float4(px[t], py[t], pz[t], 0.0f);
  }
  __syncwarp();

  int prev = first;
  if (lane == 0) out[0] = first;
  for (int j = 1; j < k; ++j) {
    // Fold the last pick into min-d^2 and pin it; then this lane's
    // best slot, the lowest on ties.
    const float4 q = pts[prev];
    const int rel = prev - lane;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const float dx = __fsub_rn(px[t], q.x), dy = __fsub_rn(py[t], q.y),
                  dz = __fsub_rn(pz[t], q.z);
      const float mv = fminf(mind[t], sqnorm3(dx, dy, dz));
      mind[t] = rel == 32 * t ? FC_NEG : mv;
    }
    float bv;
    int bt;
    slot_argmax(mind, bv, bt);
    int bi = lane + 32 * bt;
    warp_argmax_nonneg(bv, bi);
    if (bv > FC_NEG) prev = bi;
    if (lane == 0) out[j] = prev;
  }
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

  // Invalid lanes start at NEG and stay there (fminf), valid ones at
  // +inf, as in fps_warp_kernel.
  float px[PPT], py[PPT], pz[PPT], mind[PPT];
  int first = bs;
#pragma unroll
  for (int t = 0; t < PPT; ++t) {
    const int i = threadIdx.x + t * blockDim.x;
    const bool v = i < bs && m[i] != 0;
    px[t] = v ? c[3 * i] : 0.0f;
    py[t] = v ? c[3 * i + 1] : 0.0f;
    pz[t] = v ? c[3 * i + 2] : 0.0f;
    mind[t] = v ? __int_as_float(0x7f800000) : FC_NEG;
    if (v && i < first) first = i;
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
    const int rel = prev - threadIdx.x;
    float bv = FC_NEG;
    int bi = 0x7fffffff;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      float dx = __fsub_rn(px[t], qx), dy = __fsub_rn(py[t], qy),
            dz = __fsub_rn(pz[t], qz);
      float mv = fminf(mind[t], sqnorm3(dx, dy, dz));
      if (rel == t * (int)blockDim.x) mv = FC_NEG;
      mind[t] = mv;
      if (mv > bv) { bv = mv; bi = threadIdx.x + t * blockDim.x; }
    }
    prev = block_pick(bv, bi, prev, red_v, red_i, &s_pick);
    if (threadIdx.x == 0) out[j] = prev;
  }
}

// Blocks wider than 8 lanes a thread: min-d^2 in the scratch row `mind`
// (NB, BS), coordinates reread each step.  After the first step an invalid
// or picked lane holds NEG, and fminf(NEG, d) is NEG, so the mask is read
// once, as the register variants' NEG start does.
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

template <int S>
cudaError_t launch_warp(const float* coords, const uint8_t* mask,
                        int32_t* idx, int nb, int bs, int k,
                        cudaStream_t stream) {
  fps_warp_kernel<S><<<nb, 32, 0, stream>>>(coords, mask, idx, bs, k);
  return cudaGetLastError();
}

}  // namespace

// The three variants, one entry each; the wrapper picks by the block width
// (repro_torch/kernels/fps.py `variant`).  Each refuses widths it cannot
// take.

// Blocks of at most 512 lanes, one warp each.
extern "C" int fc_fps_warp_blocks(const float* coords, const uint8_t* mask,
                                  int32_t* idx, int nb, int bs, int k,
                                  void* stream) {
  if (nb == 0 || k == 0) return 0;
  if (bs < 1 || bs > 32 * kWarpSlots || k < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int slots = (bs + 31) / 32;
  if (slots <= 1) return (int)launch_warp<1>(coords, mask, idx, nb, bs, k, s);
  if (slots <= 2) return (int)launch_warp<2>(coords, mask, idx, nb, bs, k, s);
  if (slots <= 4) return (int)launch_warp<4>(coords, mask, idx, nb, bs, k, s);
  if (slots <= 8) return (int)launch_warp<8>(coords, mask, idx, nb, bs, k, s);
  return (int)launch_warp<16>(coords, mask, idx, nb, bs, k, s);
}

// Blocks of at most 8192 lanes, one CTA each, min-d^2 in registers.
extern "C" int fc_fps_cta_blocks(const float* coords, const uint8_t* mask,
                                 int32_t* idx, int nb, int bs, int k,
                                 void* stream) {
  if (nb == 0 || k == 0) return 0;
  if (bs < 1 || bs > 8 * 1024 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // One, two or eight points a thread.  Four would spill: ptxas keeps that
  // variant at 32 registers so that two CTAs of 1024 threads fit an SM.
  const int ppt = bs <= 1024 ? 1 : bs <= 2048 ? 2 : 8;
  const int threads = ((bs + ppt - 1) / ppt + 31) / 32 * 32;
  cudaError_t err;
  if (ppt == 1) err = launch<1>(coords, mask, idx, nb, bs, k, threads, s);
  else if (ppt == 2) err = launch<2>(coords, mask, idx, nb, bs, k, threads, s);
  else err = launch<8>(coords, mask, idx, nb, bs, k, threads, s);
  return (int)err;
}

// Blocks of any width, one CTA each; `scratch`: (NB, BS) floats.
extern "C" int fc_fps_wide_blocks(const float* coords, const uint8_t* mask,
                                  int32_t* idx, float* scratch, int nb,
                                  int bs, int k, void* stream) {
  if (nb == 0 || k == 0) return 0;
  if (bs < 1 || k < 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  fps_wide_kernel<<<nb, 1024, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      coords, mask, idx, scratch, bs, k);
  return (int)cudaGetLastError();
}
