// Block-wise in-window feature gather.
//
// Replaces the Pallas TPU kernel `gather_blocks` / `_gather_kernel` of
// src/repro/kernels/gather.py (oracle: `gather_blocks` in
// src/repro/kernels/ref.py).
//
// Contract: out[b, m, :] = feats[b, idx[b, m], :]; an index outside [0, W)
// writes zeros.
//
// What bounds it: bytes.  It does no arithmetic; it reads the indices and
// one feature row for each output row and writes the output.
//
// Design: the TPU kernel turns the random fetch into a one-hot (M, W) x
// (W, C) matmul on the MXU; on this card a direct indexed load is the
// natural form.  One thread per 16-byte chunk of an output row (float4
// when C is a multiple of 4 and both buffers are 16-byte aligned, else one
// float), consecutive threads on consecutive chunks of a row.
#include "common.cuh"

namespace {

template <typename V>
__global__ void gather_kernel(const V* __restrict__ feats,
                              const int32_t* __restrict__ idx,
                              V* __restrict__ out, long long rows, int m,
                              int w, int cv) {
  const long long total = rows * cv;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / cv;          // output row: block * m + j
    const int c = (int)(t - r * cv);
    const long long b = r / m;
    const int i = idx[r];
    V v;
    if (i >= 0 && i < w) {
      v = feats[(b * w + i) * cv + c];
    } else {
      v = V{};
    }
    out[t] = v;
  }
}

}  // namespace

extern "C" int fc_gather_blocks(const float* feats, const int32_t* idx,
                                float* out, int nb, int w, int c, int m,
                                void* stream) {
  if (nb == 0 || m == 0 || c == 0) return 0;
  if (w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = (long long)nb * m;
  const bool vec = (c % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(feats) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int cv = vec ? c / 4 : c;
  const int threads = 256;
  long long want = (rows * cv + threads - 1) / threads;
  int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  if (vec) {
    gather_kernel<float4><<<blocks, threads, 0, s>>>(
        reinterpret_cast<const float4*>(feats), idx,
        reinterpret_cast<float4*>(out), rows, m, w, cv);
  } else {
    gather_kernel<float><<<blocks, threads, 0, s>>>(feats, idx, out, rows, m,
                                                    w, cv);
  }
  return (int)cudaGetLastError();
}
