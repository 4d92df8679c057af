// Window top-k, shared by the ball query (csrc/ball_query.cu) and kNN
// (csrc/knn.cu) kernels: for every query row of a leaf block, the `num`
// valid window lanes nearest to it by (d^2, lane), in that order, and for
// the ball query the count of valid lanes with d^2 <= r2.
//
// One pass over a compacted window with a register top-k, one leaf block a
// CTA and one thread a query row:
// * mask first: the CTA reads the block's mask (16 lanes a load) and a
//   block whose window has no valid lane writes its exhausted rows, (lane 0,
//   INF) and count 0, without reading a coordinate or a query;
// * the valid lanes of a live window go to shared memory in lane order, as
//   (x, y, z, |w|^2) float4s beside their lane numbers (a ballot and a
//   prefix count per 32 lanes), in tiles of at most TOPK_TILE lanes, so a
//   window of any width streams through a fixed amount of shared memory;
//   every row reads the same lane at once (a broadcast);
// * each row keeps a sorted (d^2, lane) list of C entries in registers
//   (every index static, the insertion unrolled); a candidate costs one
//   compare against the last entry, and one that beats it shifts the list.
//   Lanes arrive in increasing order, so inserting with a strict `<` puts a
//   later lane after an equal distance: the lowest lane comes first on
//   ties, as repeated argmin gives.  Slots never filled keep (lane 0, INF),
//   the exhaustion contract;
// * C is the power of two at or above `num`, at most TOPK_MAX_CAP; a larger
//   `num` runs ceil(num / C) passes, each keeping the C nearest lanes that
//   come after the last pick of the pass before in (d^2, lane) order;
// * a row's picks are staged in shared memory and the CTA writes the
//   block's rows, which are contiguous, in one coalesced pass (16 bytes a
//   store where aligned).
#pragma once

#include "common.cuh"

namespace fc {

constexpr int TOPK_THREADS = 256;  // rows a CTA takes at once, at most
constexpr int TOPK_TILE = 1024;    // window lanes a tile, at most
constexpr int TOPK_MAX_CAP = 32;   // longest register list

struct TopkArgs {
  const float* q;        // (nb, nq, 3) query rows
  const uint8_t* qmask;  // (nb, nq): cnt is 0 where false (ball query)
  const float* win;      // (nb, w, 3)
  const uint8_t* wmask;  // (nb, w)
  int32_t* idx;          // (nb, nq, num)
  float* d2;             // (nb, nq, num)
  int32_t* cnt;          // (nb, nq), ball query only
  int nb, nq, w, num;
  float r2;
  // launch geometry (topk_shape)
  int tile, nchunk, passes;
  int region;            // bytes of the tile / staging region
};

__host__ __device__ inline int topk_cap(int num) {
  const int m = num < TOPK_MAX_CAP ? num : TOPK_MAX_CAP;
  int c = 1;
  while (c < m) c <<= 1;
  return c;
}

// Fill the geometry of `a` (nq, w, num set); returns the dynamic shared
// memory and sets the thread count.
inline size_t topk_shape(TopkArgs& a, int* threads) {
  const int cap = topk_cap(a.num);
  a.passes = a.num > cap ? (a.num + cap - 1) / cap : 1;
  a.tile = a.w < TOPK_TILE ? a.w : TOPK_TILE;
  a.nchunk = (a.tile + 31) / 32;
  *threads = a.nq >= TOPK_THREADS ? TOPK_THREADS : (a.nq + 31) / 32 * 32;
  size_t tile = (size_t)a.tile * (sizeof(float4) + sizeof(int));
  size_t stage = (size_t)*threads * cap * (sizeof(int) + sizeof(float));
  a.region = (int)(((tile > stage ? tile : stage) + 15) / 16 * 16);
  return a.region + (size_t)(a.nchunk + 1) * sizeof(int);
}

// Insert (d, lane), known to beat D[C-1], into the sorted list.
template <int C>
__device__ __forceinline__ void topk_insert(float (&D)[C], int (&I)[C],
                                            float d, int lane) {
#pragma unroll
  for (int s = C - 1; s > 0; --s) {
    const bool up = d < D[s - 1];   // the new entry lands before slot s-1
    const bool here = d < D[s];
    D[s] = up ? D[s - 1] : (here ? d : D[s]);
    I[s] = up ? I[s - 1] : (here ? lane : I[s]);
  }
  if (d < D[0]) {
    D[0] = d;
    I[0] = lane;
  }
}

// One row against n compacted lanes.  AFTER: only lanes after (ld, ll) in
// (d^2, lane) order qualify.
template <int C, bool COUNT, bool AFTER>
__device__ __forceinline__ void topk_scan(const float4* pts, const int* lanes,
                                          int n, float qx, float qy, float qz,
                                          float q2, float r2, float (&D)[C],
                                          int (&I)[C], int& count, float ld,
                                          int ll) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 p = pts[j];
    const float d = expanded_d2(q2, p.w, dot3(qx, qy, qz, p.x, p.y, p.z));
    if (COUNT) count += d <= r2 ? 1 : 0;
    if (d < D[C - 1]) {
      const int lane = lanes[j];
      if (!AFTER || d > ld || (d == ld && lane > ll))
        topk_insert<C>(D, I, d, lane);
    }
  }
}

// Whether block b's window has a valid lane (every thread reads its share
// of the mask, 16 lanes a load where the row allows it).
__device__ inline bool topk_live(const TopkArgs& a, int b) {
  const uint8_t* m = a.wmask + (size_t)b * a.w;
  int any = 0;
  if ((a.w & 15) == 0 && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
    const uint4* m4 = reinterpret_cast<const uint4*>(m);
    for (int j = threadIdx.x; j < (a.w >> 4); j += blockDim.x) {
      const uint4 v = m4[j];
      any |= (v.x | v.y | v.z | v.w) != 0;
    }
  } else {
    for (int j = threadIdx.x; j < a.w; j += blockDim.x) any |= m[j];
  }
  return __syncthreads_or(any) != 0;
}

// Compact the valid lanes [t0, t0 + tile) of block b's window into
// pts/lanes, in lane order; *nv = their count.
__device__ inline void topk_fill(const TopkArgs& a, int b, int t0,
                                 float4* pts, int* lanes, int* coff,
                                 int* nv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int end = min(a.w, t0 + a.tile);
  const uint8_t* m = a.wmask + (size_t)b * a.w;
  for (int c = warp; c < a.nchunk; c += nwarps) {
    const int j = t0 + c * 32 + lane;
    const unsigned bal = __ballot_sync(0xffffffffu, j < end && m[j]);
    if (lane == 0) coff[c] = __popc(bal);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the chunk counts (nchunk <= 32)
    const int v = lane < a.nchunk ? coff[lane] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane < a.nchunk) coff[lane] = incl - v;
    if (lane == 31) *nv = incl;
  }
  __syncthreads();
  const float* w = a.win + (size_t)b * a.w * 3;
  for (int c = warp; c < a.nchunk; c += nwarps) {
    const int j = t0 + c * 32 + lane;
    const bool ok = j < end && m[j];
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int pos = coff[c] + __popc(bal & ((1u << lane) - 1u));
      const float x = w[3 * j], y = w[3 * j + 1], z = w[3 * j + 2];
      pts[pos] = make_float4(x, y, z, sqnorm3(x, y, z));
      lanes[pos] = j;
    }
  }
  __syncthreads();
}

// dst[0..n) = v, by the whole CTA, 16 bytes a store where aligned.
template <typename T>
__device__ inline void topk_fill_out(T* dst, size_t n, T v) {
  size_t head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    head = n & ~(size_t)3;
    const uint32_t b = *reinterpret_cast<const uint32_t*>(&v);
    const uint4 v4 = make_uint4(b, b, b, b);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t e = threadIdx.x; e < head / 4; e += blockDim.x) d4[e] = v4;
  }
  for (size_t e = head + threadIdx.x; e < n; e += blockDim.x) dst[e] = v;
}

// Write `rows` staged rows of `cols` picks (columns col0.. of rows `row`..)
// from shared memory, by the whole CTA.
__device__ inline void topk_write(const TopkArgs& a, size_t row, int rows,
                                  int col0, int cols, const int* s_oi,
                                  const float* s_od) {
  const int n = rows * cols;
  if (cols == a.num) {  // one contiguous range
    int32_t* di = a.idx + row * a.num;
    float* dd = a.d2 + row * a.num;
    int head = 0;
    if (((reinterpret_cast<uintptr_t>(di) | reinterpret_cast<uintptr_t>(dd))
         & 15) == 0) {
      head = n & ~3;
      const int4* si4 = reinterpret_cast<const int4*>(s_oi);
      const float4* sd4 = reinterpret_cast<const float4*>(s_od);
      for (int e = threadIdx.x; e < head / 4; e += blockDim.x) {
        reinterpret_cast<int4*>(di)[e] = si4[e];
        reinterpret_cast<float4*>(dd)[e] = sd4[e];
      }
    }
    for (int e = head + threadIdx.x; e < n; e += blockDim.x) {
      di[e] = s_oi[e];
      dd[e] = s_od[e];
    }
    return;
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int rr = e / cols;
    const size_t o = (row + rr) * a.num + col0 + (e - rr * cols);
    a.idx[o] = s_oi[e];
    a.d2[o] = s_od[e];
  }
}

template <int C, bool COUNT>
__device__ inline void topk_rows(const TopkArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  float4* pts = reinterpret_cast<float4*>(smem);
  int* lanes = reinterpret_cast<int*>(pts + a.tile);
  int* s_oi = reinterpret_cast<int*>(smem);  // staging, over the tile
  float* s_od = reinterpret_cast<float*>(s_oi + (size_t)blockDim.x * C);
  int* coff = reinterpret_cast<int*>(smem + a.region);
  int* nv = coff + a.nchunk;

  const size_t row0 = (size_t)b * a.nq;
  if (!topk_live(a, b)) {
    topk_fill_out<int32_t>(a.idx + row0 * a.num, (size_t)a.nq * a.num, 0);
    topk_fill_out<float>(a.d2 + row0 * a.num, (size_t)a.nq * a.num, FC_INF);
    if (COUNT) topk_fill_out<int32_t>(a.cnt + row0, (size_t)a.nq, 0);
    return;
  }
  const int ntile = (a.w + a.tile - 1) / a.tile;
  bool filled = false;  // the only tile is in shared memory (CTA-uniform)
  for (int r0 = 0; r0 < a.nq; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const bool act = r < a.nq;
    float qx = 0.0f, qy = 0.0f, qz = 0.0f;
    if (act) {
      const float* q = a.q + (row0 + r) * 3;
      qx = q[0];
      qy = q[1];
      qz = q[2];
    }
    const float q2 = sqnorm3(qx, qy, qz);
    float ld = FC_NEG;
    int ll = -1, count = 0;
    for (int p = 0; p < a.passes; ++p) {
      float D[C];
      int I[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        D[c] = FC_INF;
        I[c] = 0;
      }
      for (int t = 0; t < ntile; ++t) {
        if (!filled) {
          topk_fill(a, b, t * a.tile, pts, lanes, coff, nv);
          filled = ntile == 1;
        }
        if (act) {
          if (p == 0)
            topk_scan<C, COUNT, false>(pts, lanes, *nv, qx, qy, qz, q2, a.r2,
                                       D, I, count, ld, ll);
          else
            topk_scan<C, false, true>(pts, lanes, *nv, qx, qy, qz, q2, a.r2,
                                      D, I, count, ld, ll);
        }
        if (ntile > 1) __syncthreads();  // before the next tile lands
      }
      // Stage this pass's picks over the tile, then write them out.
      const int cols = min(C, a.num - p * C);
      __syncthreads();
      if (act) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c < cols) {
            s_oi[threadIdx.x * cols + c] = I[c];
            s_od[threadIdx.x * cols + c] = D[c];
          }
        }
      }
      filled = false;
      __syncthreads();
      topk_write(a, row0 + r0, min((int)blockDim.x, a.nq - r0), p * C, cols,
                 s_oi, s_od);
      if (COUNT && p == 0 && act)
        a.cnt[row0 + r] = a.qmask[row0 + r] ? count : 0;
      __syncthreads();
      ld = D[C - 1];
      ll = I[C - 1];
    }
  }
}

// Launch a top-k kernel, one leaf block a CTA, with the geometry
// topk_shape gave.
template <typename Kernel>
cudaError_t topk_launch(Kernel kernel, const TopkArgs& a, int threads,
                        size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.nb, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fc
