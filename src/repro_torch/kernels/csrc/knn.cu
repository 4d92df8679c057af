// Block-wise k nearest neighbours: the window top-k of csrc/topk.cuh.
//
// Replaces the Pallas TPU kernel `knn_blocks` / `_knn_kernel` of
// src/repro/kernels/knn.py (oracle: `knn_blocks` in
// src/repro/kernels/ref.py).
//
// Contract: expanded-form d^2 of every query to every window lane, INF on
// invalid lanes, the k smallest by (d^2, lane) (lowest lane on ties; an
// exhausted row pads with lane 0 and INF), as repeated masked argmin gives
// them.  No radius, no count.
//
// What bounds it: bytes at the serving shapes.  At FP stage 0 of a 4 x
// 65,536 microbatch (NB=10204, Q=256, W=128, k=3) the idx and d2 rows of
// every block are 63 of the 71 MB the call must move; the distances of
// live blocks are ~0.4 Gop, a third of that time.
//
// Design (see topk.cuh): mask first, so a dead block reads a 128-byte mask
// and writes its exhausted rows; the valid lanes of a live window
// compacted into shared memory and read by broadcast; one thread a query
// (Q=256 rows, one leaf block a CTA), one pass with a sorted register list
// of 4 (d^2, lane) pairs (k=3 keeps 4: the power of two at or above k);
// the block's 256 rows of 3 picks (3 KB of each output) staged in shared
// memory and written as one contiguous range of 16-byte stores.
//
// What holds it back: the dead blocks' output rows and the insertion (a
// warp takes the insertion at 49 / 63 % of lanes; kernel_bench.py rates);
// it runs at ~24 % / ~34 % of its byte bound at the two FP stages.
//
// First design (PR 11): the same shared-memory window plus one distance row
// a warp, a warp a row, k rounds of a shuffle argmin, a 4-byte store a
// pick; 0.1134 / 0.2840 ms at FP stages 1 and 0 on an H100 80GB HBM3 at
// 700 W (PERF.md), timed as this design is.
#include "topk.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(fc::TOPK_THREADS)
    knn_kernel(fc::TopkArgs a) {
  fc::topk_rows<C, false>(a);
}

template <int C>
cudaError_t launch(const fc::TopkArgs& a, int threads, size_t smem,
                   cudaStream_t s) {
  return fc::topk_launch(knn_kernel<C>, a, threads, smem, s);
}

}  // namespace

extern "C" int fc_knn_blocks(const float* queries, const float* window,
                             const uint8_t* wmask, int32_t* idx, float* d2,
                             int nb, int q, int w, int k, void* stream) {
  if (nb == 0 || q == 0) return 0;
  if (w < 1 || k < 0) return (int)cudaErrorInvalidValue;
  fc::TopkArgs a{queries, nullptr, window, wmask, idx, d2, nullptr, nb, q, w,
                 k, 0.0f};
  int threads;
  const size_t smem = fc::topk_shape(a, &threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (fc::topk_cap(k)) {
    case 1: return (int)launch<1>(a, threads, smem, s);
    case 2: return (int)launch<2>(a, threads, smem, s);
    case 4: return (int)launch<4>(a, threads, smem, s);
    case 8: return (int)launch<8>(a, threads, smem, s);
    case 16: return (int)launch<16>(a, threads, smem, s);
    default: return (int)launch<32>(a, threads, smem, s);
  }
}
