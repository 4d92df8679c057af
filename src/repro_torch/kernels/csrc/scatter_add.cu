// Block-wise in-window scatter-add: the backward of the feature gather.
//
// Replaces the Pallas TPU kernel `scatter_add_blocks` /
// `_scatter_add_kernel` of src/repro/kernels/gather.py (oracle:
// `scatter_add_blocks` in src/repro/kernels/ref.py).
//
// Contract: out[b, w, :] = sum over m of [idx[b, m] == w] * g[b, m, :], for
// 0 <= w < W; a row whose index lies outside [0, W) (the -1 padding among
// them) is dropped, as its forward row fetched zeros.
//
// What bounds it: bytes.  It reads the indices and every cotangent row whose
// index is in range, writes the whole (NB, W, C) output, and does one add per
// in-range (row, channel).
//
// Design: the TPU kernel turns the random scatter into a transposed one-hot
// (W, M) x (M, C) matmul on the MXU; here each block's output tile lives in
// shared memory instead.  One CTA per (block, channel tile).  Thread t owns
// the tile's columns t, t + blockDim, ... and walks the rows m = 0..M-1 in
// order, adding g[b, m, c] into acc[idx[b, m], c]: loads of g are coalesced
// along c, no two threads ever touch one cell, so there are no atomics and
// every run gives the same bits.  The block's indices are staged in shared
// memory in chunks (padded with -1 to whole groups).  The channel tile is
// as wide as fits W x tile floats beside the index chunk in what one CTA
// may have (227 KB on an H100); a window too tall for even one column is
// refused.
//
// Shared memory caps an SM at ~14 warps here (W floats a column), too few
// to stream HBM with one load in flight each: a thread loads the next
// kAhead in-range rows into registers before it adds them, in order, so
// the sums stay those of the row-order plain version.
#include "common.cuh"

namespace {

constexpr int kMaxTile = 256;     // channels a CTA takes at most
constexpr int kIdxChunk = 1024;   // indices staged per pass
constexpr int kAhead = 16;        // rows loaded ahead of their adds

__global__ void scatter_add_kernel(const float* __restrict__ g,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int m, int c,
                                   int w, int tile, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);                  // w * tile
  int32_t* sidx = reinterpret_cast<int32_t*>(acc + (size_t)w * tile);
  const long long b = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int cw = min(tile, c - c0);

  for (int cl = threadIdx.x; cl < cw; cl += blockDim.x)
    for (int r = 0; r < w; ++r) acc[(size_t)r * tile + cl] = 0.0f;

  const float* gb = g + b * m * (long long)c + c0;
  const int32_t* ib = idx + b * m;
  for (int m0 = 0; m0 < m; m0 += chunk) {
    const int mm = min(chunk, m - m0);
    const int padded = (mm + kAhead - 1) / kAhead * kAhead;
    __syncthreads();                       // the last chunk is consumed
    for (int t = threadIdx.x; t < padded; t += blockDim.x)
      sidx[t] = t < mm ? ib[m0 + t] : -1;
    __syncthreads();
    for (int cl = threadIdx.x; cl < cw; cl += blockDim.x) {
      const float* gp = gb + (long long)m0 * c + cl;
      float* col = acc + cl;
      for (int j0 = 0; j0 < padded; j0 += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int i = sidx[j0 + u];
          v[u] = (i >= 0 && i < w) ? __ldg(gp + (long long)(j0 + u) * c)
                                   : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int i = sidx[j0 + u];
          if (i >= 0 && i < w) col[(size_t)i * tile] += v[u];
        }
      }
    }
  }

  float* ob = out + b * w * (long long)c + c0;
  for (int cl = threadIdx.x; cl < cw; cl += blockDim.x)
    for (int r = 0; r < w; ++r)
      ob[(long long)r * c + cl] = acc[(size_t)r * tile + cl];
}

}  // namespace

extern "C" int fc_scatter_add_blocks(const float* g, const int32_t* idx,
                                     float* out, int nb, int m, int c, int w,
                                     void* stream) {
  if (nb == 0 || c == 0 || w == 0) return 0;
  if (w < 0 || m < 0 || c < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const int rows = m < kIdxChunk ? (m > 0 ? m : 1) : kIdxChunk;
  const int chunk = (rows + kAhead - 1) / kAhead * kAhead;
  const long long room = (long long)optin - (long long)chunk * 4;
  long long fit = room / (4LL * w);
  if (fit < 1) return (int)cudaErrorInvalidValue;   // window too tall
  int tile = (int)(fit < kMaxTile ? fit : kMaxTile);
  if (tile > c) tile = c;
  if (tile < c && tile >= 32) tile -= tile % 32;     // whole warps
  const int threads = tile < 32 ? 32 : ((tile + 31) / 32) * 32;
  const size_t smem = (size_t)w * tile * 4 + (size_t)chunk * 4;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(scatter_add_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)nb, (unsigned)((c + tile - 1) / tile));
  scatter_add_kernel<<<grid, threads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      g, idx, out, m, c, w, tile, chunk);
  return (int)cudaGetLastError();
}
