// Block-wise ball query, one leaf block per CTA.
//
// Replaces the Pallas TPU kernel `ball_query_blocks` / `_bq_kernel` of
// src/repro/kernels/ball_query.py (oracle: `ball_query_blocks` in
// src/repro/kernels/ref.py).
//
// Contract: expanded-form d^2 of every center to every window lane, INF on
// invalid lanes; cnt = valid lanes with d^2 <= r2, for valid centers only;
// the num smallest lanes of each center by repeated masked argmin (lowest
// lane on ties; an exhausted row repeats lane 0 with INF).
//
// What bounds it: operations.  Each center reads the whole window, so a
// block does KC x W distances and num passes over each distance row (about
// 12 + 2*num operations a pair), against 16 bytes a window lane read once.
//
// Design: the window (3 x W f32 plus |w|^2 and the mask, 10.5 KB at W=512)
// sits in shared memory and every center of the block reuses it -- the
// paper's intra-block reuse.  Each warp takes center rows in turn, writes
// the row's distances to its own shared-memory row, counts in-radius lanes
// with a warp sum, then runs num rounds of a (value, lane) warp argmin.  A
// block whose window has no valid lane writes the exhausted result at once.
#include "common.cuh"

namespace {

using namespace fc;

__global__ void ball_query_kernel(const float* __restrict__ centers,
                                  const uint8_t* __restrict__ cmask,
                                  const float* __restrict__ window,
                                  const uint8_t* __restrict__ wmask,
                                  int32_t* __restrict__ idx,
                                  float* __restrict__ d2,
                                  int32_t* __restrict__ cnt, int kc, int w,
                                  int num, float r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* rows;
  Window win = carve_window(smem, w, nwarps, &rows);
  const bool any = load_window(win, window + (size_t)b * w * 3,
                               wmask + (size_t)b * w, w);

  const float* c = centers + (size_t)b * kc * 3;
  int32_t* oi = idx + (size_t)b * kc * num;
  float* od = d2 + (size_t)b * kc * num;
  int32_t* oc = cnt + (size_t)b * kc;
  if (!any) {
    for (int t = threadIdx.x; t < kc * num; t += blockDim.x) {
      oi[t] = 0;
      od[t] = FC_INF;
    }
    for (int t = threadIdx.x; t < kc; t += blockDim.x) oc[t] = 0;
    return;
  }
  float* row = rows + (size_t)warp * w;
  for (int r = warp; r < kc; r += nwarps) {
    int n_in = fill_row(win, row, w, c[3 * r], c[3 * r + 1], c[3 * r + 2],
                        true, r2);
    if (lane == 0) oc[r] = cmask[(size_t)b * kc + r] ? n_in : 0;
    extract_row(row, w, num, oi + (size_t)r * num, od + (size_t)r * num);
  }
}

}  // namespace

extern "C" int fc_ball_query_blocks(const float* centers, const uint8_t* cmask,
                                    const float* window, const uint8_t* wmask,
                                    int32_t* idx, float* d2, int32_t* cnt,
                                    int nb, int kc, int w, int num, float r2,
                                    void* stream) {
  if (nb == 0 || kc == 0) return 0;
  if (w < 1 || num < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  size_t smem = window_smem_bytes(w, threads / 32);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ball_query_kernel<<<nb, threads, smem,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      centers, cmask, window, wmask, idx, d2, cnt, kc, w, num, r2);
  return (int)cudaGetLastError();
}
