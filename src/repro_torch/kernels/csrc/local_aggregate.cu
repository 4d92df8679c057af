// PointNeXt's InvResMLP local aggregation, pooled in one pass.
//
// Replaces no TPU kernel: the JAX package has no InvResMLP block.  The
// port's block ran it as PyTorch ops over a grouped (B, m, ns, C + 3)
// tensor: a gather and a `cat` to build it, a dense layer over it, a ReLU,
// a mask and a max over the ns slots -- five passes over ~4.8 GB a block
// at PointNeXt-XL's stage 0 (4 rooms).  The layer is linear before its
// ReLU, so its feature half g = f @ W_f runs once a point outside (a
// plain fp32 matmul, ~1/32 of the grouped layer's FLOPs) and this kernel
// does the rest without building the grouped tensor.
//
// Contract: out[b, i, c] = max(0, max over slots s of centre i whose mask
// bit is set and whose index j = nidx[b, i, s] lies in [0, m) of
//   ((rel0 * w_r[0, c] + rel1 * w_r[1, c]) + rel2 * w_r[2, c])
//     + g[b, j, c]) + bias[c]),
// rel = rel[b, i, s, :], every operation rounded on its own (`__f*_rn`),
// as `local_aggregate_plain` spells it out; a centre with no such slot
// gives 0.  A slot that is masked or out of range is never read.
//
// What bounds it: bytes.  At XL's stage 0 (B=4, m=72,250, C=128, ns=32,
// ~11 valid slots a centre) a call must read g (148 MB), the valid slots'
// indices and offsets and the masks, and write the output (148 MB): 355
// MB, 0.106 ms at 3.35 TB/s; its 3.2 G operations (8 a valid slot and
// channel) take 0.048 ms at the fp32 rate.  It runs in 0.548 ms (H100,
// PERF.md): each g row is read from the caches once for every centre
// that names it.  The centres are in the partition's DFT order, so
// consecutive centres share most neighbour rows and those reads hit.
//
// Design: a CTA of 256 threads takes a run of up to 32 consecutive
// centres (fewer where that leaves under 4 CTAs an SM), so the rows they
// share stay in L1 and L2.  It stages the run's indices (a masked or
// out-of-range slot as -1) and offsets in shared memory, once.  Threads
// spread over channels, 16 bytes each (float4; floats where C is not a
// multiple of 4 or a pointer is not 16-byte aligned): a power of two of
// them, 32 to 256, cover a centre's row, so every warp works on one centre
// and a masked slot never diverges it; 256 / that many centres run at
// once.  A thread holds its channels' w_r and bias in registers and loads
// up to 8 neighbour rows before it folds them, to keep loads in flight.
#include "common.cuh"

namespace {

constexpr int LA_THREADS = 256;
constexpr int LA_MAX_RUN = 32;      // centres a CTA
constexpr int LA_UNROLL = 8;        // neighbour rows in flight a thread
constexpr int LA_SLOT_BYTES = 16;   // an index and three offsets
constexpr int LA_MAX_SMEM = 48 * 1024;

__device__ __forceinline__ float la_term(float r0, float r1, float r2,
                                         float w0, float w1, float w2,
                                         float gj, float b) {
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(r0, w0), __fmul_rn(r1, w1)),
                            __fmul_rn(r2, w2));
  return __fadd_rn(__fadd_rn(d, gj), b);
}

__device__ __forceinline__ void la_fold(float& acc, float r0, float r1,
                                        float r2, float w0, float w1,
                                        float w2, float gj, float b) {
  acc = fmaxf(acc, la_term(r0, r1, r2, w0, w1, w2, gj, b));
}

__device__ __forceinline__ void la_fold(float4& acc, float r0, float r1,
                                        float r2, const float4& w0,
                                        const float4& w1, const float4& w2,
                                        const float4& gj, const float4& b) {
  la_fold(acc.x, r0, r1, r2, w0.x, w1.x, w2.x, gj.x, b.x);
  la_fold(acc.y, r0, r1, r2, w0.y, w1.y, w2.y, gj.y, b.y);
  la_fold(acc.z, r0, r1, r2, w0.z, w1.z, w2.z, gj.z, b.z);
  la_fold(acc.w, r0, r1, r2, w0.w, w1.w, w2.w, gj.w, b.w);
}

// V: float4 or float; cv = channels / (elements of V); tc threads a row.
template <typename V>
__global__ void __launch_bounds__(LA_THREADS)
    local_aggregate_kernel(const V* __restrict__ g,
                           const int32_t* __restrict__ nidx,
                           const uint8_t* __restrict__ gmask,
                           const float* __restrict__ rel,
                           const V* __restrict__ w_r,
                           const V* __restrict__ bias, V* __restrict__ out,
                           long long rows, int m, int cv, int ns, int run,
                           int tc) {
  extern __shared__ __align__(16) unsigned char la_smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(la_smem);
  float* s_rel = reinterpret_cast<float*>(s_idx + run * ns);
  const long long r0 = (long long)blockIdx.x * run;
  const int nr = (int)(rows - r0 < run ? rows - r0 : run);
  const int slots = nr * ns;
  const long long first = r0 * ns;
  for (int t = threadIdx.x; t < slots; t += blockDim.x) {
    const int j = nidx[first + t];
    s_idx[t] = (gmask[first + t] && j >= 0 && j < m) ? j : -1;
  }
  for (int t = threadIdx.x; t < 3 * slots; t += blockDim.x) {
    s_rel[t] = rel[3 * first + t];
  }
  __syncthreads();
  const int per = blockDim.x / tc;     // centres at once
  const int sub = threadIdx.x / tc;
  for (int cc = threadIdx.x % tc; cc < cv; cc += tc) {
    const V w0 = w_r[cc], w1 = w_r[cv + cc], w2 = w_r[2 * cv + cc];
    const V b = bias[cc];
    for (int q = sub; q < nr; q += per) {
      const long long row = r0 + q;
      const V* gc = g + (row / m) * m * cv + cc;   // the centre's cloud
      const int32_t* qi = s_idx + q * ns;
      const float* qr = s_rel + 3 * q * ns;
      V acc{};
      for (int s0 = 0; s0 < ns; s0 += LA_UNROLL) {
        int j[LA_UNROLL];
        V gj[LA_UNROLL];
#pragma unroll
        for (int u = 0; u < LA_UNROLL; ++u) {
          j[u] = s0 + u < ns ? qi[s0 + u] : -1;
          if (j[u] >= 0) gj[u] = __ldg(gc + (long long)j[u] * cv);
        }
#pragma unroll
        for (int u = 0; u < LA_UNROLL; ++u) {
          if (j[u] < 0) continue;
          const float* r = qr + 3 * (s0 + u);
          la_fold(acc, r[0], r[1], r[2], w0, w1, w2, gj[u], b);
        }
      }
      out[row * cv + cc] = acc;
    }
  }
}

// The launch of one call: variant 0 (float4) where C is a multiple of 4
// and every float buffer is 16-byte aligned, else 1 (float); 256 threads,
// a run of centres a CTA, and its staging as dynamic shared memory.
// *run and *tc are the kernel's arguments of the same names.
cudaError_t la_geometry(int b, int m, int c, int ns, bool aligned,
                        fc::Geometry* g, int* run, int* tc) {
  if (b == 0 || m == 0 || c == 0) return cudaSuccess;
  if (b < 0 || m < 0 || c < 0 || ns < 0) return cudaErrorInvalidValue;
  if ((long long)ns * LA_SLOT_BYTES > LA_MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  const bool vec = (c % 4 == 0) && aligned;
  const int cv = vec ? c / 4 : c;
  int t = 32;
  while (t < cv && t < LA_THREADS) t *= 2;
  const int per = LA_THREADS / t;
  const long long rows = (long long)b * m;
  int r = LA_MAX_RUN;
  while (r > per && (rows + r - 1) / r < 132LL * 4) r /= 2;
  while (r > 1 && (long long)r * ns * LA_SLOT_BYTES > LA_MAX_SMEM) r /= 2;
  const long long grid = (rows + r - 1) / r;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  g->variant = vec ? 0 : 1;
  g->threads = LA_THREADS;
  g->grid[0] = (int)grid;
  g->grid[1] = g->grid[2] = 1;
  g->smem = r * ns * LA_SLOT_BYTES;
  *run = r;
  *tc = t;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int fc_local_aggregate(const float* g, const int32_t* nidx,
                                  const uint8_t* gmask, const float* rel,
                                  const float* w_r, const float* bias,
                                  float* out, int b, int m, int c, int ns,
                                  void* stream) {
  const bool aligned = aligned16(g) && aligned16(w_r) && aligned16(bias) &&
                       aligned16(out);
  fc::Geometry geo;
  int run = 0, tc = 0;
  const cudaError_t e = la_geometry(b, m, c, ns, aligned, &geo, &run, &tc);
  if (e != cudaSuccess || geo.variant < 0) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * m;
  if (geo.variant == 0) {
    local_aggregate_kernel<float4><<<geo.grid[0], geo.threads, geo.smem, s>>>(
        reinterpret_cast<const float4*>(g), nidx, gmask, rel,
        reinterpret_cast<const float4*>(w_r),
        reinterpret_cast<const float4*>(bias), reinterpret_cast<float4*>(out),
        rows, m, c / 4, ns, run, tc);
  } else {
    local_aggregate_kernel<float><<<geo.grid[0], geo.threads, geo.smem, s>>>(
        g, nidx, gmask, rel, w_r, bias, out, rows, m, c, ns, run, tc);
  }
  return (int)cudaGetLastError();
}

// fc_local_aggregate's geometry for these shapes, without a launch.
extern "C" int fc_local_aggregate_geometry(int b, int m, int c, int ns,
                                           int aligned, int* out) {
  fc::Geometry geo;
  int run = 0, tc = 0;
  const cudaError_t e =
      la_geometry(b, m, c, ns, aligned != 0, &geo, &run, &tc);
  fc::write_geometry(geo, out);
  return (int)e;
}

// Attributes of variant 0 (float4) or 1 (float) at that launch.
extern "C" int fc_local_aggregate_attributes(int variant, int threads,
                                             int smem, int* out) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  const void* fn =
      variant == 0
          ? reinterpret_cast<const void*>(&local_aggregate_kernel<float4>)
          : reinterpret_cast<const void*>(&local_aggregate_kernel<float>);
  return (int)fc::func_attributes(fn, threads, smem, out);
}
