// Block-wise ball query: the window top-k of csrc/topk.cuh, with counts.
//
// Replaces the Pallas TPU kernel `ball_query_blocks` / `_bq_kernel` of
// src/repro/kernels/ball_query.py (oracle: `ball_query_blocks` in
// src/repro/kernels/ref.py).
//
// Contract: expanded-form d^2 of every center to every window lane, INF on
// invalid lanes; cnt = valid lanes with d^2 <= r2, for valid centers only;
// the num smallest lanes of each center by (d^2, lane) (lowest lane on
// ties; an exhausted row pads with lane 0 and INF), as repeated masked
// argmin gives them.
//
// What bounds it: bytes at the serving shapes.  The idx and d2 rows of
// every block, dead ones included, are 85 of the 102 MB that a 4 x 65,536
// microbatch's stage-0 call must move (NB=10204, KC=65, W=512, num=16);
// the distances and ranks of live blocks (~1.0 Gop as chip_smoke.py's
// work() counts them) would take half that time at the fp32 rate.
//
// Design (see topk.cuh): mask first, so a dead block (84 % of them at
// stage 0) reads one 512-byte mask and writes its exhausted rows; the
// valid lanes of a live window compacted into shared memory; one leaf
// block a CTA and one thread a center (KC=65: 96 threads), one pass with a
// sorted register list of 16 (d^2, lane) pairs and the count in the same
// pass; the block's 65 rows of 16 picks staged in shared memory and
// written as one contiguous range of 16-byte stores.  Three blocks a CTA
// (224 threads) measured 0.2389 / 0.1694 ms at the two stages against one
// block's 0.2453 / 0.1427: small CTAs spread stage 1's few live blocks
// over more SMs.
//
// Why one thread a center, and not a few threads a center whose sorted
// lists merge by shuffles: the serving path's time is in the selection
// (the parent design's num=16 took 4.5x its num=0 time) and a row's list
// takes a candidate at ~20 % of its lanes (a warp of rows at ~49 %;
// kernel_bench.py rates).  Splitting a row over 2, 4 or 8
// threads that share a reject bound every 8 steps and merge at the end
// gives the latency-bound stage 1 (459 live blocks, ~2 warps a scheduler)
// more warps, 0.1577 -> 0.1240 ms at 4 threads, but each slice fills its
// own list, and stage 0 went 0.2460 -> 0.3726 / 0.4420 / 0.5150 ms at 2 /
// 4 / 8 threads (H100 80GB HBM3, 700 W; PERF.md).  Tensor cores are not
// used: K=3, and fp32 `__f*_rn` rounding is the contract.
//
// What holds it back: the insertion, ~64 ALU instructions at C=16 (half
// the FP32 rate), taken by a warp whenever one of its rows takes a
// candidate; stage 0 runs at ~13 % of its byte bound, stage 1 at ~6 %,
// where dead blocks also take a third of the time (not understood).
//
// First design (PR 11): the whole window and one distance row a warp in
// shared memory (49 bytes a lane: windows above ~4700 lanes were refused),
// a warp a row, 16 rounds of a shuffle argmin over the row, a 4-byte store
// a pick; 0.4870 / 0.2309 ms at the two serving stages on the same card,
// timed in the same way.
#include "topk.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(fc::TOPK_THREADS)
    ball_query_kernel(fc::TopkArgs a) {
  fc::topk_rows<C, true>(a);
}

template <int C>
cudaError_t launch(const fc::TopkArgs& a, const fc::Geometry& g,
                   cudaStream_t s) {
  return fc::topk_launch(ball_query_kernel<C>, a, g, s);
}

// The kernel of a variant (log2 of its list length), nullptr for none.
const void* kernel_of(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(&ball_query_kernel<1>);
    case 1: return reinterpret_cast<const void*>(&ball_query_kernel<2>);
    case 2: return reinterpret_cast<const void*>(&ball_query_kernel<4>);
    case 3: return reinterpret_cast<const void*>(&ball_query_kernel<8>);
    case 4: return reinterpret_cast<const void*>(&ball_query_kernel<16>);
    case 5: return reinterpret_cast<const void*>(&ball_query_kernel<32>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int fc_ball_query_blocks(const float* centers, const uint8_t* cmask,
                                    const float* window, const uint8_t* wmask,
                                    int32_t* idx, float* d2, int32_t* cnt,
                                    int nb, int kc, int w, int num, float r2,
                                    void* stream) {
  fc::TopkArgs a{centers, cmask, window, wmask, idx, d2, cnt, nb, kc, w, num,
                 r2};
  fc::Geometry g;
  const cudaError_t e = fc::topk_geometry(a, &g);
  if (e != cudaSuccess || g.variant < 0) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (g.variant) {
    case 0: return (int)launch<1>(a, g, s);
    case 1: return (int)launch<2>(a, g, s);
    case 2: return (int)launch<4>(a, g, s);
    case 3: return (int)launch<8>(a, g, s);
    case 4: return (int)launch<16>(a, g, s);
    default: return (int)launch<32>(a, g, s);
  }
}

// fc_ball_query_blocks's geometry for these shapes, without a launch.
extern "C" int fc_ball_query_geometry(int nb, int kc, int w, int num,
                                      int* out) {
  fc::TopkArgs a{};
  a.nb = nb;
  a.nq = kc;
  a.w = w;
  a.num = num;
  fc::Geometry g;
  const cudaError_t e = fc::topk_geometry(a, &g);
  fc::write_geometry(g, out);
  return (int)e;
}

// Attributes of a variant (log2 of its list length) at that launch.
extern "C" int fc_ball_query_attributes(int variant, int threads, int smem,
                                        int* out) {
  const void* fn = kernel_of(variant);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fc::func_attributes(fn, threads, smem, out);
}
