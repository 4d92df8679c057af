// The FP stage's 3-NN inverse-distance blend, over the occupied leaf lanes.
//
// Replaces no TPU kernel: the JAX package blends with jnp
// (`repro.core.bppo.blockwise_interpolate`: a product with the weights, a
// sum over the three neighbours, then a scatter of every leaf lane, the
// padded ones to a sink row), and the port ran the same three PyTorch
// passes over the in-window gather's whole padded (NB, bs * 3, C) output.
// At level 0 of a 289,000-point room about 89 % of the leaf lanes are
// padding.
//
// Contract: for every leaf block nb (cloud b = nb / leaves) and lane
// j < min(count[nb], bs) whose row r = start[nb] + j lies in [0, R):
//   out[b, r, :] = (vals[nb, 3j] * wgt[nb, j, 0]
//                   + vals[nb, 3j + 1] * wgt[nb, j, 1])
//                  + vals[nb, 3j + 2] * wgt[nb, j, 2],
// each product and sum rounded on its own (`__f*_rn`), as
// `interp_blend_plain` spells it out.  Every other row of out keeps what
// it held; a padded lane's rows of vals and wgt are never read.
//
// What bounds it: bytes.  An occupied lane reads three floats a channel
// and writes one (16 bytes) for 5 operations.  At level 0 of a
// PointNeXt-XL microbatch (B=4, 9,916 leaf blocks a room, C=128, 1.156 M
// occupied lanes) that is 2.37 GB, 0.71 ms at 3.35 TB/s.
//
// Design: one CTA of 256 threads a leaf block, looping over the block's
// occupied lanes only.  Threads spread over a lane's channels, 16 bytes
// each (float4 where C is a multiple of 4 and out and vals are 16-byte
// aligned, else one float): a power of two of them, enough for the row up
// to 256, so 256 / that many lanes run at once.  A lane's three neighbour
// rows lie next to each other in vals and are read once, with streaming
// loads (nothing reads them again); its three weights come through the
// read-only cache, shared by the lane's threads.  Nothing is read twice,
// so nothing is staged in shared memory.
#include "common.cuh"

namespace {

constexpr int IB_THREADS = 256;

__device__ __forceinline__ float ib_blend(float v0, float v1, float v2,
                                          float w0, float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v0, w0), __fmul_rn(v1, w1)),
                   __fmul_rn(v2, w2));
}

__device__ __forceinline__ float4 ib_blend(const float4& v0, const float4& v1,
                                           const float4& v2, float w0,
                                           float w1, float w2) {
  return make_float4(ib_blend(v0.x, v1.x, v2.x, w0, w1, w2),
                     ib_blend(v0.y, v1.y, v2.y, w0, w1, w2),
                     ib_blend(v0.z, v1.z, v2.z, w0, w1, w2),
                     ib_blend(v0.w, v1.w, v2.w, w0, w1, w2));
}

// V: float4 or float; cv = channels / (elements of V); tc threads a lane.
template <typename V>
__global__ void __launch_bounds__(IB_THREADS)
    interp_blend_kernel(V* __restrict__ out, const V* __restrict__ vals,
                        const float* __restrict__ wgt,
                        const int32_t* __restrict__ start,
                        const int32_t* __restrict__ count, int leaves,
                        int rows, int bs, int cv, int tc) {
  const long long nb = blockIdx.x;
  const long long s = start[nb];
  // The occupied lanes whose rows lie in [0, rows): j in [lo, hi).
  const long long lo = s < 0 ? -s : 0;
  long long hi = count[nb];
  if (hi > bs) hi = bs;
  if (hi > rows - s) hi = rows - s;
  const long long vbase = nb * bs * 3 * cv;
  const long long obase = ((nb / leaves) * rows + s) * cv;
  const float* wb = wgt + nb * bs * 3;
  const int per = blockDim.x / tc;
  for (long long j = lo + threadIdx.x / tc; j < hi; j += per) {
    const float w0 = __ldg(wb + 3 * j);
    const float w1 = __ldg(wb + 3 * j + 1);
    const float w2 = __ldg(wb + 3 * j + 2);
    const V* v = vals + vbase + 3 * j * cv;
    const long long o = obase + j * cv;
    for (int cc = threadIdx.x % tc; cc < cv; cc += tc) {
      out[o + cc] = ib_blend(__ldcs(v + cc), __ldcs(v + cv + cc),
                             __ldcs(v + 2 * cv + cc), w0, w1, w2);
    }
  }
}

// The launch of one call: variant 0 (float4) where C is a multiple of 4 and
// out and vals are 16-byte aligned, else 1 (float); 256 threads, one CTA a
// leaf block.  *tc is the kernel's argument of that name.
cudaError_t ib_geometry(int nb, int bs, int c, bool aligned, fc::Geometry* g,
                        int* tc) {
  if (nb == 0 || bs == 0 || c == 0) return cudaSuccess;
  if (nb < 0 || bs < 0 || c < 0) return cudaErrorInvalidValue;
  const bool vec = (c % 4 == 0) && aligned;
  const int cv = vec ? c / 4 : c;
  int t = 1;
  while (t < cv && t < IB_THREADS) t *= 2;
  g->variant = vec ? 0 : 1;
  g->threads = IB_THREADS;
  g->grid[0] = nb;
  g->grid[1] = g->grid[2] = 1;
  g->smem = 0;
  *tc = t;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int fc_interp_blend(float* out, const float* vals,
                               const float* wgt, const int32_t* start,
                               const int32_t* count, int b, int leaves,
                               int rows, int bs, int c, void* stream) {
  if (b < 0 || leaves < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const long long nb = (long long)b * leaves;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  fc::Geometry geo;
  int tc = 0;
  const cudaError_t e = ib_geometry((int)nb, bs, c,
                                    aligned16(out) && aligned16(vals), &geo,
                                    &tc);
  if (e != cudaSuccess || geo.variant < 0) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (geo.variant == 0) {
    interp_blend_kernel<float4><<<geo.grid[0], geo.threads, 0, s>>>(
        reinterpret_cast<float4*>(out), reinterpret_cast<const float4*>(vals),
        wgt, start, count, leaves, rows, bs, c / 4, tc);
  } else {
    interp_blend_kernel<float><<<geo.grid[0], geo.threads, 0, s>>>(
        out, vals, wgt, start, count, leaves, rows, bs, c, tc);
  }
  return (int)cudaGetLastError();
}

// fc_interp_blend's geometry for these shapes (NB = B * leaves), without a
// launch.
extern "C" int fc_interp_blend_geometry(int nb, int bs, int c, int aligned,
                                        int* out) {
  fc::Geometry geo;
  int tc = 0;
  const cudaError_t e = ib_geometry(nb, bs, c, aligned != 0, &geo, &tc);
  fc::write_geometry(geo, out);
  return (int)e;
}

// Attributes of variant 0 (float4) or 1 (float) at that launch.
extern "C" int fc_interp_blend_attributes(int variant, int threads, int smem,
                                          int* out) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  const void* fn =
      variant == 0
          ? reinterpret_cast<const void*>(&interp_blend_kernel<float4>)
          : reinterpret_cast<const void*>(&interp_blend_kernel<float>);
  return (int)fc::func_attributes(fn, threads, smem, out);
}
