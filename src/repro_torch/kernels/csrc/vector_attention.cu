// Point Transformer's vector attention, one call a block, with no
// per-neighbour tensor in device memory.
//
// Replaces no TPU kernel: the JAX package has no Point Transformer.  The
// port's layer ran as ~15 PyTorch passes a block over (B, m, k, C) float32
// tensors -- the gathered k|v rows, delta and the layer before it, k - q
// and a, the w1 and w2 outputs, the masked softmax, v + delta and the
// weighted product -- 4.7 GB each at levels 0 and 1 of a 16-room
// microbatch.  q, k and v stay one matrix product a point (the caller's
// `addmm` onto [q | k | v]); this kernel does the rest, and the BatchNorm
// and ReLU after the layer (repro_torch/kernels/vector_attention.py has the
// formula).
//
// What bounds it: bytes and float32 operations about equally.  A call
// must read q|k|v once a point, each slot's index, mask bit and offsets,
// and write one C-row a point: 16 C + 17 k bytes a point.  Its delta and w
// layers take 2 (9 + 3 C + C N + N^2) operations a valid slot (N = C / G).
// Over the 18 blocks of a 16-room microbatch that is ~15.5 GB (4.6 ms at
// 3.35 TB/s) and ~428 GFLOP (6.4 ms at 67 TFLOP/s): ~7.7 ms, taking the
// larger of the two at each level.
//
// Design: a CTA of 256 threads takes a run of consecutive points (rows of
// the clouds' order), R = P k rows of (point, slot) pairs, 128 to 256
// rows, and stages their neighbour rows (-1 where the slot is masked or out
// of range), point numbers and hidden offsets h = ReLU(p1(rel)) in shared
// memory once.  Consecutive points are one object's (level 0) or one leaf
// block's samples (above), so the neighbour rows of a run repeat and the
// gathers hit L1 and L2.  Then, a slice of 32 channels at a time, it
// builds the a-rows of the run in shared memory, four channels a thread
// (float4 reads of k and q, whole 128-byte pieces of a row a warp, delta
// from h and the slice's p2 columns in registers), beside the slice of w1,
// and multiplies them into a register tile: a thread owns TM rows and TN
// of the N columns, reading its rows' a one float a row (the stride 33
// keeps the banks apart) and w1 as float4s that every lane of the warp
// shares.  The tile's ReLU goes back into the same shared memory, w2 runs
// the same way on it, and the logits replace it, where one thread a
// (point, column) takes the max-subtracted softmax over the point's valid
// slots in place (accurate expf).  Last, one thread a point's four
// channels folds sum_j p_j (v_j + delta_j), reading the v rows as float4s
// and recomputing delta from h, and writes ReLU(y * scale + shift).
// Nothing is written to device memory but the output.  Every product and
// sum is a float32 FMA or add: no TF32, no tensor cores.
//
// TN follows N (4 for N <= 4, 8 for N <= 8, else 16, with TX = N / TN
// threads across the columns, the last padded with zero weights) and TM
// the rows left to each thread (2 where TX is 4 or more:
// vector_attention_rows2_kernel); C (a multiple of 4) and k are read from
// the call, so one body takes every level of the net.  On an H100 the 18
// layers of a 16-room microbatch take ~40 ms against the ~6.2 ms bound
// (PERF.md): the gathers' latency between the slices' barriers, and the
// SIMT products at 64 registers a thread, hold it there.
#include "common.cuh"

namespace {

constexpr int VA_THREADS = 256;
constexpr int VA_MAX_SMEM = 227 * 1024;

struct VaPlan {
  int tm = 0, tn = 0, ty = 0;  // rows and columns a thread; threads a column
  int np = 0;                  // N padded to TX * TN columns
  int kc = 0;                  // channels of a slice
  int rows = 0;                // TY * TM rows of shared memory
  int pts = 0;                 // points a CTA
  int ks = 0;                  // slots a point (k, at least 1)
};

// acc[i][j] += sum over kk < kw of A[(ty + i TY) * lda + kk] * W[kk * ldw + j]
// (W already offset to the thread's first column).
template <int TM, int TN>
__device__ __forceinline__ void va_tile(float (&acc)[TM][TN],
                                        const float* __restrict__ A, int lda,
                                        const float* __restrict__ W, int ldw,
                                        int kw, int ty, int TY) {
  // Unrolled 4 deep but where one row meets 16 columns: there the unrolled
  // loads would take more than the 64 registers four CTAs an SM leave.
#pragma unroll (TM == 1 && TN == 16 ? 1 : 4)
  for (int kk = 0; kk < kw; ++kk) {
    float a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + i * TY) * lda + kk];
    float w[TN];
#pragma unroll
    for (int v = 0; v < TN / 4; ++v) {
      const float4 x = *reinterpret_cast<const float4*>(W + kk * ldw + 4 * v);
      w[4 * v] = x.x;
      w[4 * v + 1] = x.y;
      w[4 * v + 2] = x.z;
      w[4 * v + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ float4 va_ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// delta of four channels: h (h0, h1, h2, -) against their p2 columns.
__device__ __forceinline__ float4 va_delta4(const float4& h, const float4& w0,
                                            const float4& w1, const float4& w2,
                                            const float4& b) {
  return make_float4(fmaf(h.z, w2.x, fmaf(h.y, w1.x, fmaf(h.x, w0.x, b.x))),
                     fmaf(h.z, w2.y, fmaf(h.y, w1.y, fmaf(h.x, w0.y, b.y))),
                     fmaf(h.z, w2.z, fmaf(h.y, w1.z, fmaf(h.x, w0.z, b.z))),
                     fmaf(h.z, w2.w, fmaf(h.y, w1.w, fmaf(h.x, w0.w, b.w))));
}

// A call's tensors and sizes (va_geometry's plan), one kernel argument.
struct VaArgs {
  const float* qkv;
  const int32_t* nidx;
  const uint8_t* mask;
  const float *rel, *p1w, *p1b, *p2w, *p2b, *sa, *w1w, *w1b, *w2w, *w2b, *bns,
      *bnt;
  float* out;
  long long points;
  int m, c, k, n, np, kc, rows, pts, ks, ty;
};

template <int TM, int TN>
__device__ __forceinline__ void va_body(const VaArgs& args) {
  const float* __restrict__ qkv = args.qkv;
  const int32_t* __restrict__ nidx = args.nidx;
  const uint8_t* __restrict__ mask = args.mask;
  const float* __restrict__ rel = args.rel;
  const float* __restrict__ p1w = args.p1w;
  const float* __restrict__ p1b = args.p1b;
  const float* __restrict__ p2w = args.p2w;
  const float* __restrict__ p2b = args.p2b;
  const float* __restrict__ sa = args.sa;
  const float* __restrict__ w1w = args.w1w;
  const float* __restrict__ w1b = args.w1b;
  const float* __restrict__ w2w = args.w2w;
  const float* __restrict__ w2b = args.w2b;
  const float* __restrict__ bns = args.bns;
  const float* __restrict__ bnt = args.bnt;
  float* __restrict__ out = args.out;
  const long long points = args.points;
  const int m = args.m, c = args.c, k = args.k, n = args.n, np = args.np,
            kc = args.kc, rows = args.rows, pts = args.pts, ks = args.ks,
            TY = args.ty;
  extern __shared__ __align__(16) unsigned char va_smem[];
  float4* s_h = reinterpret_cast<float4*>(va_smem);   // [rows] (h, 0)
  int* s_idx = reinterpret_cast<int*>(s_h + rows);    // [rows] global row
  int* s_pt = s_idx + rows;                           // [rows] point a row
  // a slices [rows][kc + 1], then w1's ReLU [rows][np + 1], then the
  // logits and probabilities [rows][np].
  float* s_x = reinterpret_cast<float*>(s_pt + rows);
  const int ldx = (kc > np ? kc : np) + 1;
  float* s_w1 = s_x + rows * ldx;        // [kc][np]
  float* s_w2 = s_w1 + kc * np;          // [np][np]

  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * pts;
  const int np_here = (int)(points - first < pts ? points - first : pts);
  const int live_rows = np_here * ks;
  const long long c3 = 3LL * c;

  // Stage each row's neighbour (its global row, -1 where the slot is
  // masked or out of range), point and hidden offsets.
  for (int r = tid; r < rows; r += VA_THREADS) {
    int row = -1;
    float h[3] = {0.f, 0.f, 0.f};
    const int p = r / ks;
    if (r < live_rows && r % ks < k) {
      const long long pt = first + p;
      const long long slot = pt * k + r % ks;
      const int j = nidx[slot];
      if (mask[slot] && j >= 0 && j < m) {
        row = (int)((pt / m) * m + j);
        const float r0 = rel[3 * slot], r1 = rel[3 * slot + 1],
                    r2 = rel[3 * slot + 2];
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          h[o] = fmaxf(fmaf(r2, p1w[6 + o], fmaf(r1, p1w[3 + o],
                                                 fmaf(r0, p1w[o], p1b[o]))),
                       0.f);
        }
      }
    }
    s_idx[r] = row;
    s_pt[r] = p;
    s_h[r] = make_float4(h[0], h[1], h[2], 0.f);
  }
  for (int e = tid; e < np * np; e += VA_THREADS) {
    const int t = e / np, col = e % np;
    s_w2[e] = (t < n && col < n) ? w2w[t * n + col] : 0.f;
  }

  const int ty = tid % TY;
  const int col0 = (tid / TY) * TN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  // w1 over slices of kc channels: the slice of w1 and the run's a-rows
  // staged (four channels a thread, float4 reads of k and q), then
  // multiplied into the register tile.
  const int nq = kc / 4;
  const int q4 = tid % nq;
  const int rstep = VA_THREADS / nq;
  for (int c0 = 0; c0 < c; c0 += kc) {
    const int kw = c - c0 < kc ? c - c0 : kc;
    __syncthreads();  // the previous slice is consumed (or staging done)
    for (int e = tid; e < kc * np; e += VA_THREADS) {
      const int t = e / np, col = e % np;
      s_w1[e] = (t < kw && col < n) ? w1w[(long long)(c0 + t) * n + col]
                                    : 0.f;
    }
    const bool live = 4 * q4 < kw;
    const int ch = c0 + 4 * q4;
    float4 w0{}, w1{}, w2{}, db{}, sc{};
    if (live) {
      w0 = va_ld4(p2w + ch);
      w1 = va_ld4(p2w + c + ch);
      w2 = va_ld4(p2w + 2 * c + ch);
      db = va_ld4(p2b + ch);
      sc = va_ld4(sa + ch);
    }
#pragma unroll 4
    for (int r = tid / nq; r < rows; r += rstep) {
      float4 a{};
      const int row = s_idx[r];
      if (live && row >= 0) {
        const float4 kj = va_ld4(qkv + row * c3 + c + ch);
        const float4 qi = va_ld4(qkv + (first + s_pt[r]) * c3 + ch);
        const float4 d = va_delta4(s_h[r], w0, w1, w2, db);
        a.x = fmaxf(fmaf(d.x, sc.x, kj.x - qi.x), 0.f);
        a.y = fmaxf(fmaf(d.y, sc.y, kj.y - qi.y), 0.f);
        a.z = fmaxf(fmaf(d.z, sc.z, kj.z - qi.z), 0.f);
        a.w = fmaxf(fmaf(d.w, sc.w, kj.w - qi.w), 0.f);
      }
      float* x = s_x + r * (kc + 1) + 4 * q4;
      x[0] = a.x;
      x[1] = a.y;
      x[2] = a.z;
      x[3] = a.w;
    }
    __syncthreads();
    va_tile<TM, TN>(acc, s_x, kc + 1, s_w1 + col0, np, kw, ty, TY);
  }

  // ReLU(a w1 + b) into shared memory, then w2 on it into the logits.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + j;
      const float b = col < n ? w1b[col] : 0.f;
      s_x[(ty + i * TY) * (np + 1) + col] = fmaxf(acc[i][j] + b, 0.f);
      acc[i][j] = 0.f;
    }
  }
  __syncthreads();
  va_tile<TM, TN>(acc, s_x, np + 1, s_w2 + col0, np, n, ty, TY);
  __syncthreads();
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY;
    const bool valid = s_idx[r] >= 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + j;
      if (col < n) s_x[r * np + col] = valid ? acc[i][j] + w2b[col] : neg_inf;
    }
  }
  __syncthreads();

  // The softmax over each point's valid slots (the others' logits are
  // -inf), a (point, column) a thread, in place: probabilities, 0 at the
  // other slots, and all 0 where the point has no valid slot.
  for (int e = tid; e < np_here * n; e += VA_THREADS) {
    const int p = e / n, col = e % n;
    float* l = s_x + p * ks * np + col;
    float mx = neg_inf;
    for (int j = 0; j < ks; ++j) mx = fmaxf(mx, l[j * np]);
    if (mx == neg_inf) {
      for (int j = 0; j < ks; ++j) l[j * np] = 0.f;
      continue;
    }
    float sum = 0.f;
    for (int j = 0; j < ks; ++j) {
      const float x = expf(l[j * np] - mx);
      l[j * np] = x;
      sum += x;
    }
    const float inv = 1.f / sum;
    for (int j = 0; j < ks; ++j) l[j * np] *= inv;
  }
  __syncthreads();

  // y = sum_j p_j (v_j + delta_j), four channels of a point a thread, then
  // the BatchNorm and ReLU.
  constexpr int U = 4;  // neighbour rows in flight a thread
  const int cq = c / 4;
  const bool wide = n % 4 == 0;  // a float4 of channels reads 4 columns
  for (int e = tid; e < np_here * cq; e += VA_THREADS) {
    const int p = e / cq, ch = 4 * (e % cq);
    const float4 w0 = va_ld4(p2w + ch), w1 = va_ld4(p2w + c + ch),
                 w2 = va_ld4(p2w + 2 * c + ch), db = va_ld4(p2b + ch);
    const int* idx = s_idx + p * ks;
    const float4* hp = s_h + p * ks;
    const float* pr = s_x + p * ks * np;
    float4 y{};
    for (int j0 = 0; j0 < ks; j0 += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = j0 + u < ks ? idx[j0 + u] : -1;
        v[u] = row >= 0 ? va_ld4(qkv + row * c3 + 2 * c + ch)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j < ks && idx[j] >= 0) {
          const float4 d = va_delta4(hp[j], w0, w1, w2, db);
          const float* pj = pr + j * np;
          float4 w;
          if (wide) {
            w = *reinterpret_cast<const float4*>(pj + ch % n);
          } else {
            w = make_float4(pj[ch % n], pj[(ch + 1) % n], pj[(ch + 2) % n],
                            pj[(ch + 3) % n]);
          }
          y.x = fmaf(v[u].x + d.x, w.x, y.x);
          y.y = fmaf(v[u].y + d.y, w.y, y.y);
          y.z = fmaf(v[u].z + d.z, w.z, y.z);
          y.w = fmaf(v[u].w + d.w, w.w, y.w);
        }
      }
    }
    const float4 bs = va_ld4(bns + ch), bt = va_ld4(bnt + ch);
    *reinterpret_cast<float4*>(out + (first + p) * c + ch) =
        make_float4(fmaxf(fmaf(y.x, bs.x, bt.x), 0.f),
                    fmaxf(fmaf(y.y, bs.y, bt.y), 0.f),
                    fmaxf(fmaf(y.z, bs.z, bt.z), 0.f),
                    fmaxf(fmaf(y.w, bs.w, bt.w), 0.f));
  }
}

// One row a thread (TM 1): four CTAs an SM, 64 registers a thread, which
// hides the gathers' latency best (three CTAs ran levels 2-3 ~10 % slower).
template <int TN>
__global__ void __launch_bounds__(VA_THREADS, 4)
    vector_attention_kernel(VaArgs args) {
  va_body<1, TN>(args);
}

// Two rows a thread (TM 2): at least two CTAs an SM, so up to 128
// registers a thread, which its 32 accumulators need without spilling.
template <int TN>
__global__ void __launch_bounds__(VA_THREADS, 2)
    vector_attention_rows2_kernel(VaArgs args) {
  va_body<2, TN>(args);
}

// The launch of one call: its variant (0: TM 1 TN 4; 1: TM 1 TN 8; 2: TM 1
// TN 16; 3: TM 2 TN 16), 256 threads, a run of points a CTA and its
// staging as dynamic shared memory; *plan holds the kernel's sizes.
cudaError_t va_geometry(int b, int m, int c, int k, int n, fc::Geometry* g,
                        VaPlan* plan) {
  if (b == 0 || m == 0 || c == 0) return cudaSuccess;
  if (b < 0 || m < 0 || c < 0 || k < 0 || n < 1 || c % n || c % 4) {
    return cudaErrorInvalidValue;
  }
  VaPlan p;
  p.tn = n <= 4 ? 4 : n <= 8 ? 8 : 16;
  int tx = 1;
  while (tx * p.tn < n) tx *= 2;
  if (tx > 16) return cudaErrorInvalidValue;  // N above 256
  p.ty = VA_THREADS / tx;
  p.tm = tx >= 4 ? 2 : 1;
  p.np = tx * p.tn;
  p.rows = p.ty * p.tm;
  p.kc = 32;
  p.ks = k > 0 ? k : 1;
  if (p.ks > p.rows) return cudaErrorInvalidValue;
  p.pts = p.rows / p.ks;
  const long long points = (long long)b * m;
  if (points > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid = (points + p.pts - 1) / p.pts;
  const int ldx = (p.kc > p.np ? p.kc : p.np) + 1;
  const long long words = 6LL * p.rows + (long long)p.rows * ldx +
                          (long long)p.kc * p.np + (long long)p.np * p.np;
  if (words * 4 > VA_MAX_SMEM) return cudaErrorInvalidValue;
  g->variant = p.tm == 2 ? 3 : p.tn == 4 ? 0 : p.tn == 8 ? 1 : 2;
  g->threads = VA_THREADS;
  g->grid[0] = (int)grid;
  g->grid[1] = g->grid[2] = 1;
  g->smem = (int)(words * 4);
  *plan = p;
  return cudaSuccess;
}

const void* va_kernel(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(&vector_attention_kernel<4>);
    case 1: return reinterpret_cast<const void*>(&vector_attention_kernel<8>);
    case 2: return reinterpret_cast<const void*>(&vector_attention_kernel<16>);
    case 3:
      return reinterpret_cast<const void*>(&vector_attention_rows2_kernel<16>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int fc_vector_attention(
    const float* qkv, const int32_t* nidx, const uint8_t* mask,
    const float* rel, const float* p1w, const float* p1b, const float* p2w,
    const float* p2b, const float* sa, const float* w1w, const float* w1b,
    const float* w2w, const float* w2b, const float* bns, const float* bnt,
    float* out, int b, int m, int c, int k, int n, void* stream) {
  // float4 reads and writes: these must lie on 16-byte boundaries.
  const void* vec[] = {qkv, p2w, p2b, sa, bns, bnt, out};
  for (const void* q : vec) {
    if (reinterpret_cast<uintptr_t>(q) % 16) {
      return (int)cudaErrorMisalignedAddress;
    }
  }
  fc::Geometry geo;
  VaPlan p;
  cudaError_t e = va_geometry(b, m, c, k, n, &geo, &p);
  if (e != cudaSuccess || geo.variant < 0) return (int)e;
  const void* fn = va_kernel(geo.variant);
  if (geo.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             geo.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const VaArgs args{qkv, nidx, mask, rel, p1w, p1b, p2w, p2b, sa, w1w, w1b,
                    w2w, w2b, bns, bnt, out, (long long)b * m, m, c, k, n,
                    p.np, p.kc, p.rows, p.pts, p.ks, p.ty};
  const dim3 grid(geo.grid[0]);
  const int t = geo.threads, smem = geo.smem;
  switch (geo.variant) {
    case 0: vector_attention_kernel<4><<<grid, t, smem, s>>>(args); break;
    case 1: vector_attention_kernel<8><<<grid, t, smem, s>>>(args); break;
    case 2: vector_attention_kernel<16><<<grid, t, smem, s>>>(args); break;
    default: vector_attention_rows2_kernel<16><<<grid, t, smem, s>>>(args);
  }
  return (int)cudaGetLastError();
}

// fc_vector_attention's geometry for these shapes, without a launch.
extern "C" int fc_vector_attention_geometry(int b, int m, int c, int k, int n,
                                            int* out) {
  fc::Geometry geo;
  VaPlan p;
  const cudaError_t e = va_geometry(b, m, c, k, n, &geo, &p);
  fc::write_geometry(geo, out);
  return (int)e;
}

// Attributes of a variant (0-3, as va_geometry numbers them) at that launch.
extern "C" int fc_vector_attention_attributes(int variant, int threads,
                                              int smem, int* out) {
  const void* fn = va_kernel(variant);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fc::func_attributes(fn, threads, smem, out);
}
