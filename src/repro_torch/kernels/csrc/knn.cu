// Block-wise k nearest neighbours, one leaf block per CTA.
//
// Replaces the Pallas TPU kernel `knn_blocks` / `_knn_kernel` of
// src/repro/kernels/knn.py (oracle: `knn_blocks` in
// src/repro/kernels/ref.py).
//
// Contract: expanded-form d^2 of every query to every window lane, INF on
// invalid lanes, the k smallest by repeated masked argmin (lowest lane on
// ties; an exhausted row repeats lane 0 with INF).  No radius, no count.
//
// What bounds it: operations.  Q x W distances a block, each about
// 12 + 2k operations, against 16 bytes a window lane and 12 a query.
//
// Design: the same shared-memory window as the ball query (W=128 coarse
// samples on the interpolation path, 2.5 KB), warps take query rows in
// turn, one shared-memory distance row per warp, k rounds of a (value,
// lane) warp argmin.  An all-invalid window writes the exhausted result.
#include "common.cuh"

namespace {

using namespace fc;

__global__ void knn_kernel(const float* __restrict__ queries,
                           const float* __restrict__ window,
                           const uint8_t* __restrict__ wmask,
                           int32_t* __restrict__ idx, float* __restrict__ d2,
                           int q, int w, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* rows;
  Window win = carve_window(smem, w, nwarps, &rows);
  const bool any = load_window(win, window + (size_t)b * w * 3,
                               wmask + (size_t)b * w, w);

  const float* p = queries + (size_t)b * q * 3;
  int32_t* oi = idx + (size_t)b * q * k;
  float* od = d2 + (size_t)b * q * k;
  if (!any) {
    for (int t = threadIdx.x; t < q * k; t += blockDim.x) {
      oi[t] = 0;
      od[t] = FC_INF;
    }
    return;
  }
  float* row = rows + (size_t)warp * w;
  for (int r = warp; r < q; r += nwarps) {
    fill_row(win, row, w, p[3 * r], p[3 * r + 1], p[3 * r + 2], false, 0.0f);
    extract_row(row, w, k, oi + (size_t)r * k, od + (size_t)r * k);
  }
}

}  // namespace

extern "C" int fc_knn_blocks(const float* queries, const float* window,
                             const uint8_t* wmask, int32_t* idx, float* d2,
                             int nb, int q, int w, int k, void* stream) {
  if (nb == 0 || q == 0) return 0;
  if (w < 1 || k < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  size_t smem = window_smem_bytes(w, threads / 32);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  knn_kernel<<<nb, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      queries, window, wmask, idx, d2, q, w, k);
  return (int)cudaGetLastError();
}
