// The fractal partition of B clouds, one level pass at a time.
//
// Replaces no TPU kernel: the JAX package partitions with jnp tensor ops
// (src/repro/core/fractal.py), and so did the port until this kernel; that
// tensor pass stays as the plain version (`tensor_pass` in
// repro_torch/core/fractal.py).  Its Pallas counterpart of one level,
// `fractal_level_blocks`, suggested the midpoint fold below ("partition
// unit and midpoint unit in one pass").
//
// Contract: every field of the tensor pass's FractalPartition, bit for bit,
// for strategy "fractal".  Points stay contiguous by node in depth-first
// order; level l splits each node that exists and holds more than th valid
// points on dimension (l + dim0[b]) % 3 at the midpoint of its valid points
// (a point exactly at the midpoint goes left), with the stable three-way key
// left-valid, right-valid, invalid.  Minimum, maximum and counts are exact
// in any order, and the midpoint (lo + hi) * 0.5 is rounded as the tensor
// pass rounds it, so nothing is approximated.
//
// What bounds it: launches and bytes.  The tensor pass spent ~250 small
// PyTorch calls a level; on a 4,096-point block the host's dispatch of them
// was two thirds of a served microbatch, and on 8 rooms of 289,000 points
// its ~100 int64 passes a level were a third of the card's time.  A level
// needs each point read twice and written once (~60 bytes).
//
// Design: one host entry launches everything on the caller's stream; the
// host loops over the static depth and never reads back.
//   * init: pack each point into a float4 (x, y, z, original index with the
//     valid bit on top), node 0, and fold the root's valid count and extrema
//     on its first split dimension (block reduce, one atomic each);
//   * per level, two passes over 2048-point tiles (256 threads, 8 points a
//     thread), a grid of (tiles, B); a tile reads its cloud's flag and
//     returns at once where no node of that cloud is active any more:
//     - count: each point's key from its node's midpoint; a block scan of
//       the (left-valid, valid) counts, packed 16 + 16 bits; one atomic a
//       node segment of the tile for the node's left count; the tile's
//       counts after its last node start, for the scatter's carry;
//     - scatter: the same scan, plus the carry of the node that started in
//       an earlier tile (warp 0 walks back over the tiles' counts to that
//       node's start); the stable rank gives each point its new position,
//       where it is written with its child's node id; the point's next split
//       coordinate is folded into its child's min and max with ordered-int
//       atomics (one a warp and child where the warp is in one node); the
//       thread that holds a node's first point writes both children's state,
//       records each child that is a leaf straight into the level-D slot
//       arrays (slot = node << (D - level)) and raises the next level's flag;
//   * slots, then final: a scan over the 2^D slots gives the compaction,
//     the leaf arrays, the slot bookkeeping and the diagnostics; the final
//     pass also unpacks the points from whichever buffer their cloud's last
//     level wrote.
// Indices, counts and node ids are int32 throughout: 2 * depth + 3 launches
// and one memset of the atomics' targets a call.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // points or slots a CTA
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHeadBit = 0x80000000u;

enum Stage { kInit = 0, kCount = 1, kScatter = 2, kSlots = 3, kFinal = 4 };

// Float order as unsigned order (-0 before +0; no NaN expected).  A node's
// lo is kept as ~key and its hi as key, both under atomicMax, so 0 is the
// identity of both and one memset clears them.
__device__ __forceinline__ uint32_t okey(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float comp(const float4& p, int d) {
  return d == 0 ? p.x : (d == 1 ? p.y : p.z);
}

struct Args {
  // Inputs.
  const float* coords;       // (B, n, 3)
  const uint8_t* valid;      // (B, n)
  const long long* dim0;     // (B,) or null: dim0_const
  int dim0_const;            // in [0, 3)
  int nb, n, depth, th, ml, tiles, stiles;
  long long heap, slots;     // nodes of a cloud's heap (2^(D+1) - 1), 2^D
  // Node heap, level l node p of cloud b at b * heap + 2^l - 1 + p.
  int32_t* nvs;              // valid points (zeroed: the root folds into it)
  uint32_t* nlo;             // ~okey(min) of the split coordinate (zeroed)
  uint32_t* nhi;             // okey(max) (zeroed)
  int32_t* ncnt;             // left-valid points (zeroed)
  int32_t* flags;            // (B, D + 1): a node of cloud b active at l (zeroed)
  uint8_t* sleaf;            // (B, 2^D) slot holds a leaf (zeroed)
  int32_t* nst;              // first point
  int32_t* nrs;              // points, invalid ones included
  uint8_t* nex;              // the node exists
  // Level-D slot records of the leaves.
  int32_t *sst, *srs, *svs, *sdp, *spst, *sprs, *spvs;
  uint32_t* agg;             // (B, tiles): counts after the last node start
  int32_t* scnt;             // (B, stiles): leaves a slot tile
  float4* pts[2];            // (B, n) packed points, ping-pong
  int32_t* nodes[2];         // (B, n) node ids, ping-pong
  // Outputs.
  float* out_coords;
  uint8_t* out_valid;
  int32_t* out_perm;
  int32_t *leaf_start, *leaf_rsize, *leaf_vsize, *leaf_depth;
  int32_t *par_start, *par_rsize, *par_vsize, *slot_of_leaf;
  uint8_t* is_leaf;
  int32_t* leaf_of_slot;     // (B, 2^D)
  int32_t* slot_cum;         // (B, 2^D + 1)
  int32_t *num_leaves, *traversals, *sort_passes, *max_leaf_vsize;
  uint8_t *overflowed, *cap_exceeded;
};

__device__ __forceinline__ int first_dim(const Args& a, int b) {
  if (a.dim0 == nullptr) return a.dim0_const;
  const long long d = a.dim0[b] % 3;
  return (int)(d < 0 ? d + 3 : d);
}

__device__ __forceinline__ long long node_at(const Args& a, int b, int l,
                                             int p) {
  return (long long)b * a.heap + ((1LL << l) - 1) + p;
}

// Exclusive scan of one value a thread over the CTA; `total` gets the sum.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before + inc - v;
}

// One tile's points at level l, classified: each item's node state, key and
// its (left-valid | valid << 16) flag, and the block's exclusive scan of
// those flags (into `ex`, and shared `ex_sh` by tile position).
struct Tile {
  int base, len, dim;
  int node[kItems], st[kItems], rs[kItems], vs[kItems];
  bool act[kItems];
  uint8_t key[kItems];
  uint32_t flag[kItems], ex[kItems];
  float4 p[kItems];
  uint32_t total;
};

__device__ __forceinline__ void classify(const Args& a, int b, int t, int l, Tile& T,
                         uint32_t* ex_sh, uint32_t* warp_sums) {
  const int src = l & 1;
  T.base = t * kTile;
  T.len = min(kTile, a.n - T.base);
  T.dim = (l + first_dim(a, b)) % 3;
  const size_t row = (size_t)b * a.n;
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    T.act[k] = false;
    T.key[k] = 2;
    T.flag[k] = 0;
    if (j < T.len) {
      const size_t i = row + T.base + j;
      const int nd = a.nodes[src][i];
      const float4 p = a.pts[src][i];
      const long long ni = node_at(a, b, l, nd);
      T.node[k] = nd;
      T.p[k] = p;
      T.st[k] = a.nst[ni];
      T.rs[k] = a.nrs[ni];
      T.vs[k] = a.nvs[ni];
      T.act[k] = a.nex[ni] != 0 && T.vs[k] > a.th;
      const bool vld = (__float_as_uint(p.w) >> 31) != 0;
      uint8_t key = vld ? 0 : 2;
      if (vld && T.act[k]) {
        const uint32_t lo = a.nlo[ni], hi = a.nhi[ni];
        const float flo = lo == 0 ? __int_as_float(0x7f800000) : unkey(~lo);
        const float fhi = hi == 0 ? __int_as_float(0xff800000) : unkey(hi);
        const float mid = __fmul_rn(__fadd_rn(flo, fhi), 0.5f);
        key = comp(p, T.dim) > mid ? 1 : 0;
      }
      T.key[k] = key;
      T.flag[k] = (key == 0 ? 1u : 0u) | (vld ? 0x10000u : 0u);
    }
    T.ex[k] = sum;
    sum += T.flag[k];
  }
  const uint32_t before = block_scan(sum, warp_sums, T.total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    T.ex[k] += before;
    ex_sh[threadIdx.x * kItems + k] = T.ex[k];
  }
  __syncthreads();
}

__device__ __forceinline__ bool cloud_done(const Args& a, int b, int l) {
  return l > 0 && a.flags[(size_t)b * (a.depth + 1) + l] == 0;
}

// ---- init ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
partition_init_kernel(Args a) {
  __shared__ uint32_t s_lo, s_hi;
  __shared__ int s_cnt;
  const int b = blockIdx.y, t = blockIdx.x;
  const int base = t * kTile, len = min(kTile, a.n - base);
  const int dim = first_dim(a, b);
  const size_t row = (size_t)b * a.n;
  if (threadIdx.x == 0) {
    s_lo = 0;
    s_hi = 0;
    s_cnt = 0;
  }
  __syncthreads();
  uint32_t lo = 0, hi = 0;   // ~okey(min) and okey(max)
  int cnt = 0;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const size_t i = row + base + j;
    const float x = a.coords[3 * i], y = a.coords[3 * i + 1],
                z = a.coords[3 * i + 2];
    const bool vld = a.valid[i] != 0;
    a.pts[0][i] = make_float4(
        x, y, z, __uint_as_float((uint32_t)(base + j) | (vld ? kHeadBit : 0u)));
    a.nodes[0][i] = 0;
    const float xd = dim == 0 ? x : (dim == 1 ? y : z);
    lo = max(lo, ~okey(vld ? xd : FC_INF));
    hi = max(hi, okey(vld ? xd : FC_NEG));
    cnt += vld ? 1 : 0;
  }
  lo = __reduce_max_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  cnt = __reduce_add_sync(kFull, cnt);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&s_lo, lo);
    atomicMax(&s_hi, hi);
    atomicAdd(&s_cnt, cnt);
  }
  __syncthreads();
  const long long root = node_at(a, b, 0, 0);
  if (threadIdx.x == 0) {
    if (len > 0) {
      atomicMax(&a.nlo[root], s_lo);
      atomicMax(&a.nhi[root], s_hi);
      atomicAdd(&a.nvs[root], s_cnt);
    }
    if (t == 0) {
      a.nst[root] = 0;
      a.nrs[root] = a.n;
      a.nex[root] = 1;
      a.sort_passes[b] = 0;
      a.max_leaf_vsize[b] = 0;
      a.overflowed[b] = 0;
    }
  }
  // The leaf arrays past the real leaves: zeros, slot -1, not a leaf.
  const long long cells = (long long)a.nb * a.ml;
  const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
  for (long long c = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                         kThreads + threadIdx.x;
       c < cells; c += stride) {
    a.leaf_start[c] = 0;
    a.leaf_rsize[c] = 0;
    a.leaf_vsize[c] = 0;
    a.leaf_depth[c] = 0;
    a.par_start[c] = 0;
    a.par_rsize[c] = 0;
    a.par_vsize[c] = 0;
    a.slot_of_leaf[c] = -1;
    a.is_leaf[c] = 0;
  }
}

// ---- one level: count ----------------------------------------------------

__global__ void __launch_bounds__(kThreads)
partition_count_kernel(Args a, int l) {
  __shared__ uint32_t ex_sh[kTile];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int last_head;
  const int b = blockIdx.y, t = blockIdx.x;
  if (cloud_done(a, b, l)) return;
  if (threadIdx.x == 0) last_head = -1;
  Tile T;
  classify(a, b, t, l, T, ex_sh, warp_sums);   // syncs after last_head's init
  int head = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    if (j >= T.len) continue;
    const int i = T.base + j;
    if (i == T.st[k]) head = j;
    // The last point of its node in this tile adds the segment's left count.
    if (T.act[k] && (i + 1 == T.st[k] + T.rs[k] || j == T.len - 1)) {
      const int first = max(T.st[k] - T.base, 0);
      const uint32_t c = (T.ex[k] + T.flag[k] - ex_sh[first]) & 0xffffu;
      if (c != 0)
        atomicAdd(&a.ncnt[node_at(a, b, l, T.node[k])], (int)c);
    }
  }
  if (head >= 0) atomicMax(&last_head, head);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int h = last_head;
    const uint32_t after = T.total - (h >= 0 ? ex_sh[h] : 0u);
    a.agg[(size_t)b * a.tiles + t] = after | (h >= 0 ? kHeadBit : 0u);
  }
}

// ---- one level: scatter --------------------------------------------------

// Fold one node's running extrema into its children's: lo0/hi0 for the
// left child, lo1/hi1 for the right; 0 is "nothing to fold".
__device__ __forceinline__ void fold_node(const Args& a, int b, int l,
                                          int node, uint32_t lo0,
                                          uint32_t hi0, uint32_t lo1,
                                          uint32_t hi1) {
  const long long c0 = node_at(a, b, l + 1, 2 * node);
  if (lo0 != 0) atomicMax(&a.nlo[c0], lo0);
  if (hi0 != 0) atomicMax(&a.nhi[c0], hi0);
  if (lo1 != 0) atomicMax(&a.nlo[c0 + 1], lo1);
  if (hi1 != 0) atomicMax(&a.nhi[c0 + 1], hi1);
}

// The warp's last running extrema: one set of atomics for the warp where
// every lane with something to fold is in the same node, else one a lane.
__device__ __forceinline__ void fold_warp(const Args& a, int b, int l,
                                          int node, uint32_t lo0,
                                          uint32_t hi0, uint32_t lo1,
                                          uint32_t hi1) {
  const int lead = __reduce_max_sync(kFull, node);
  if (__all_sync(kFull, node < 0 || node == lead)) {
    lo0 = __reduce_max_sync(kFull, lo0);
    hi0 = __reduce_max_sync(kFull, hi0);
    lo1 = __reduce_max_sync(kFull, lo1);
    hi1 = __reduce_max_sync(kFull, hi1);
    if ((threadIdx.x & 31) == 0 && lead >= 0)
      fold_node(a, b, l, lead, lo0, hi0, lo1, hi1);
  } else if (node >= 0) {
    fold_node(a, b, l, node, lo0, hi0, lo1, hi1);
  }
}

__global__ void __launch_bounds__(kThreads)
partition_scatter_kernel(Args a, int l) {
  __shared__ uint32_t ex_sh[kTile];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int carry_l, carry_v, first_start;
  const int b = blockIdx.y, t = blockIdx.x;
  if (cloud_done(a, b, l)) return;
  const int dst = (l + 1) & 1;
  const int lane = threadIdx.x & 31;
  Tile T;
  classify(a, b, t, l, T, ex_sh, warp_sums);
  if (threadIdx.x == 0) first_start = T.len > 0 ? T.st[0] : T.base;
  __syncthreads();
  // The node holding the tile's first point may have started in an earlier
  // tile: its counts from its start up to this tile are the suffixes of the
  // tiles back to (and including) the one where it starts.
  if (threadIdx.x < 32) {
    int cl = 0, cv = 0;
    if (first_start < T.base) {
      for (int back = t - 1;; back -= 32) {
        const int tt = back - lane;
        const uint32_t w =
            tt >= 0 ? a.agg[(size_t)b * a.tiles + tt] : kHeadBit;
        const unsigned heads = __ballot_sync(kFull, (w & kHeadBit) != 0);
        const int stop = heads ? __ffs(heads) - 1 : 31;
        const uint32_t mine = lane <= stop ? (w & ~kHeadBit) : 0u;
        cl += (int)__reduce_add_sync(kFull, mine & 0xffffu);
        cv += (int)__reduce_add_sync(kFull, mine >> 16);
        if (heads) break;
      }
    }
    if (lane == 0) {
      carry_l = cl;
      carry_v = cv;
    }
  }
  __syncthreads();
  const size_t row = (size_t)b * a.n;
  const bool fold = l + 1 < a.depth;
  const int ndim = (l + 1 + first_dim(a, b)) % 3;
  int run = -1;                       // node whose extrema are running
  uint32_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    if (j >= T.len) continue;
    const int i = T.base + j;
    const int st = T.st[k], vs = T.vs[k], nd = T.node[k];
    int wl, wv;
    if (st >= T.base) {
      const uint32_t w = T.ex[k] - ex_sh[st - T.base];
      wl = (int)(w & 0xffffu);
      wv = (int)(w >> 16);
    } else {
      wl = carry_l + (int)(T.ex[k] & 0xffffu);
      wv = carry_v + (int)(T.ex[k] >> 16);
    }
    const long long ni = node_at(a, b, l, nd);
    int pos;
    if (T.key[k] == 0) {
      pos = st + wl;
    } else if (T.key[k] == 1) {
      pos = st + a.ncnt[ni] + (wv - wl);
    } else {
      pos = st + vs + ((i - st) - wv);
    }
    const int child = T.act[k] && T.key[k] != 0 ? 1 : 0;
    a.pts[dst][row + pos] = T.p[k];
    a.nodes[dst][row + pos] = 2 * nd + child;
    if (fold && T.act[k]) {
      if (nd != run) {
        if (run >= 0) fold_node(a, b, l, run, lo0, hi0, lo1, hi1);
        run = nd;
        lo0 = hi0 = lo1 = hi1 = 0;
      }
      const bool vld = T.key[k] != 2;
      const float x = comp(T.p[k], ndim);
      const uint32_t klo = ~okey(vld ? x : FC_INF);
      const uint32_t khi = okey(vld ? x : FC_NEG);
      if (child) {
        lo1 = max(lo1, klo);
        hi1 = max(hi1, khi);
      } else {
        lo0 = max(lo0, klo);
        hi0 = max(hi0, khi);
      }
    }
    // The thread holding a node's first point writes the children.
    if (i == st) {
      const int l1 = l + 1, rs = T.rs[k];
      const bool act = T.act[k];
      const int c0 = act ? a.ncnt[ni] : rs;     // left child's points
      const int cst[2] = {st, st + c0};
      const int crs[2] = {c0, rs - c0};
      const int cvs[2] = {act ? c0 : vs, act ? vs - c0 : 0};
      const long long ci = node_at(a, b, l1, 2 * nd);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        a.nst[ci + c] = cst[c];
        a.nrs[ci + c] = crs[c];
        a.nvs[ci + c] = cvs[c];
        a.nex[ci + c] = act ? 1 : 0;
        if (!act) continue;
        if (cvs[c] > a.th && l1 < a.depth) {
          a.flags[(size_t)b * (a.depth + 1) + l1] = 1;
          continue;
        }
        const size_t s = (size_t)b * a.slots +
                         ((size_t)(2 * nd + c) << (a.depth - l1));
        const bool self = l1 <= 1;
        a.sleaf[s] = 1;
        a.sst[s] = cst[c];
        a.srs[s] = crs[c];
        a.svs[s] = cvs[c];
        a.sdp[s] = l1;
        a.spst[s] = self ? cst[c] : st;
        a.sprs[s] = self ? crs[c] : rs;
        a.spvs[s] = self ? cvs[c] : vs;
      }
    }
  }
  if (fold) fold_warp(a, b, l, run, lo0, hi0, lo1, hi1);
}

// ---- slots and final -----------------------------------------------------

__device__ __forceinline__ bool root_active(const Args& a, int b) {
  return a.depth > 0 && a.nvs[node_at(a, b, 0, 0)] > a.th;
}

__global__ void __launch_bounds__(kThreads)
partition_slots_kernel(Args a) {
  __shared__ int s_cnt;
  const int b = blockIdx.y, t = blockIdx.x;
  const long long base = (long long)t * kTile;
  const size_t row = (size_t)b * a.slots;
  if (threadIdx.x == 0) {
    s_cnt = 0;
    if (t == 0 && !root_active(a, b)) {   // the root is the only leaf
      const int vs = a.nvs[node_at(a, b, 0, 0)];
      a.sleaf[row] = 1;
      a.sst[row] = 0;
      a.srs[row] = a.n;
      a.svs[row] = vs;
      a.sdp[row] = 0;
      a.spst[row] = 0;
      a.sprs[row] = a.n;
      a.spvs[row] = vs;
    }
  }
  __syncthreads();
  int cnt = 0;
  for (int j = threadIdx.x; j < kTile && base + j < a.slots; j += kThreads)
    cnt += a.sleaf[row + base + j];
  cnt = __reduce_add_sync(kFull, cnt);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_cnt, cnt);
  __syncthreads();
  if (threadIdx.x == 0) a.scnt[(size_t)b * a.stiles + t] = s_cnt;
}

__global__ void __launch_bounds__(kThreads)
partition_final_kernel(Args a) {
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int s_before, s_max, s_trav;
  const int b = blockIdx.y, t = blockIdx.x;
  if (threadIdx.x == 0) {
    int trav = root_active(a, b) ? 1 : 0;
    for (int l = 1; l < a.depth; ++l)
      trav += a.flags[(size_t)b * (a.depth + 1) + l];
    s_trav = trav;
    s_before = 0;
    s_max = 0;
  }
  __syncthreads();
  if (t < a.stiles) {
    int before = 0;
    for (int u = threadIdx.x; u < t; u += kThreads)
      before += a.scnt[(size_t)b * a.stiles + u];
    before = __reduce_add_sync(kFull, before);
    if ((threadIdx.x & 31) == 0) atomicAdd(&s_before, before);
    const long long base = (long long)t * kTile;
    const size_t row = (size_t)b * a.slots;
    uint8_t isl[kItems];
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long s = base + threadIdx.x * kItems + k;
      isl[k] = s < a.slots ? a.sleaf[row + s] : 0;
      sum += isl[k];
    }
    uint32_t total;
    uint32_t ex = block_scan(sum, warp_sums, total);   // syncs: s_before set
    const int prior = s_before;
    int vmax = 0;
    bool over = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long s = base + threadIdx.x * kItems + k;
      if (s >= a.slots) break;
      const int e = prior + (int)ex;
      ex += isl[k];
      a.slot_cum[(size_t)b * (a.slots + 1) + s] = e;
      a.leaf_of_slot[row + s] = isl[k] ? e : -1;
      if (!isl[k]) continue;
      const size_t r = row + s;
      const int vs = a.svs[r];
      vmax = max(vmax, vs);
      over = over || vs > a.th;
      if (e < a.ml) {
        const size_t o = (size_t)b * a.ml + e;
        a.leaf_start[o] = a.sst[r];
        a.leaf_rsize[o] = a.srs[r];
        a.leaf_vsize[o] = vs;
        a.leaf_depth[o] = a.sdp[r];
        a.par_start[o] = a.spst[r];
        a.par_rsize[o] = a.sprs[r];
        a.par_vsize[o] = a.spvs[r];
        a.slot_of_leaf[o] = (int)s;
        a.is_leaf[o] = 1;
      }
    }
    vmax = __reduce_max_sync(kFull, vmax);
    if ((threadIdx.x & 31) == 0) atomicMax(&s_max, vmax);
    if (over) a.overflowed[b] = 1;
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s_max > 0) atomicMax(&a.max_leaf_vsize[b], s_max);
      if (t == a.stiles - 1) {
        const int all = prior + (int)total;
        a.slot_cum[(size_t)b * (a.slots + 1) + a.slots] = all;
        a.num_leaves[b] = all;
        a.cap_exceeded[b] = all > a.ml ? 1 : 0;
        a.traversals[b] = s_trav;
      }
    }
  }
  if (t < a.tiles) {
    // Each level a cloud ran moved its points to the other buffer: level 0
    // always runs (it puts the valid points first), then one a traversal.
    const int q = a.depth > 0 ? max(s_trav, 1) & 1 : 0;
    const int base = t * kTile, len = min(kTile, a.n - base);
    const size_t row = (size_t)b * a.n;
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const size_t i = row + base + j;
      const float4 p = a.pts[q][i];
      const uint32_t w = __float_as_uint(p.w);
      a.out_coords[3 * i] = p.x;
      a.out_coords[3 * i + 1] = p.y;
      a.out_coords[3 * i + 2] = p.z;
      a.out_valid[i] = (uint8_t)(w >> 31);
      a.out_perm[i] = (int32_t)(w & 0x7fffffffu);
    }
  }
}

// ---- host ----------------------------------------------------------------

int ceil_div(long long x, int d) { return (int)((x + d - 1) / d); }

struct Layout {
  long long heap, slots;
  int tiles, stiles;
  size_t zeroed, words;            // 32-bit words
  size_t nvs, nlo, nhi, ncnt, flags, sleaf, nst, nrs, nex, slot[7], agg,
      scnt, pts[2], nodes[2];
};

bool plan(int nb, int n, int depth, Layout* L) {
  if (nb < 0 || n < 0 || depth < 0 || depth > 30) return false;
  L->heap = (2LL << depth) - 1;
  L->slots = 1LL << depth;
  L->tiles = n > 0 ? ceil_div(n, kTile) : 1;
  L->stiles = ceil_div(L->slots, kTile);
  size_t off = 0;
  auto take = [&](long long words) {
    const size_t at = off;
    off += ((size_t)words + 3) & ~(size_t)3;   // 16-byte aligned regions
    return at;
  };
  const long long bh = nb * L->heap, bl = nb * L->slots, bn = (long long)nb * n;
  L->nvs = take(bh);
  L->nlo = take(bh);
  L->nhi = take(bh);
  L->ncnt = take(bh);
  L->flags = take((long long)nb * (depth + 1));
  L->sleaf = take((bl + 3) / 4);
  L->zeroed = off;
  L->nst = take(bh);
  L->nrs = take(bh);
  L->nex = take((bh + 3) / 4);
  for (int f = 0; f < 7; ++f) L->slot[f] = take(bl);
  L->agg = take((long long)nb * L->tiles);
  L->scnt = take((long long)nb * L->stiles);
  for (int q = 0; q < 2; ++q) L->pts[q] = take(4 * bn);
  for (int q = 0; q < 2; ++q) L->nodes[q] = take(bn);
  L->words = off;
  return true;
}

// The launch of one stage: (tiles, B) CTAs of 256 threads for the point
// passes, (slot tiles, B) for the slots pass, enough for both in the final.
cudaError_t partition_geometry(int nb, int n, int depth, int stage,
                               fc::Geometry* g) {
  Layout L;
  if (!plan(nb, n, depth, &L) || stage < kInit || stage > kFinal)
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  g->variant = stage;
  g->threads = kThreads;
  g->grid[0] = stage == kSlots ? L.stiles
               : stage == kFinal ? max(L.tiles, L.stiles)
                                 : L.tiles;
  g->grid[1] = nb;
  g->grid[2] = 1;
  return cudaSuccess;
}

const void* stage_kernel(int stage) {
  switch (stage) {
    case kInit: return reinterpret_cast<const void*>(&partition_init_kernel);
    case kCount: return reinterpret_cast<const void*>(&partition_count_kernel);
    case kScatter:
      return reinterpret_cast<const void*>(&partition_scatter_kernel);
    case kSlots: return reinterpret_cast<const void*>(&partition_slots_kernel);
    case kFinal: return reinterpret_cast<const void*>(&partition_final_kernel);
    default: return nullptr;
  }
}

}  // namespace

// 32-bit words of scratch that fc_partition needs for these shapes.
extern "C" int fc_partition_scratch(int nb, int n, int depth,
                                    long long* words) {
  Layout L;
  if (!plan(nb, n, depth, &L)) return (int)cudaErrorInvalidValue;
  *words = (long long)L.words;
  return 0;
}

// The whole partition on `stream`: clears the atomics' targets, then
// init, two passes a level and the slots and final passes.  `out_i32`
// holds the int32 outputs' pointers in FractalPartition's order (perm,
// leaf_start, leaf_rsize, leaf_vsize, leaf_depth, parent_start,
// parent_rsize, parent_vsize, slot_of_leaf, leaf_of_slot, slot_cum_leaves,
// num_leaves, traversals, sort_passes, max_leaf_vsize) and `out_u8` the
// bool ones' (valid, is_leaf, overflowed, leaf_capacity_exceeded).
// `launched` gets the number of kernels launched.
extern "C" int fc_partition(const float* coords, const uint8_t* valid,
                            const long long* dim0, int dim0_const, int nb,
                            int n, int depth, int th, int ml, void* scratch,
                            float* out_coords, void** out_i32, void** out_u8,
                            int* launched, void* stream) {
  *launched = 0;
  Layout L;
  if (!plan(nb, n, depth, &L) || ml < 1 || nb > 65535 ||
      dim0_const < 0 || dim0_const > 2)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int32_t* w = static_cast<int32_t*>(scratch);
  Args a;
  a.coords = coords;
  a.valid = valid;
  a.dim0 = dim0;
  a.dim0_const = dim0_const;
  a.nb = nb;
  a.n = n;
  a.depth = depth;
  a.th = th;
  a.ml = ml;
  a.tiles = L.tiles;
  a.stiles = L.stiles;
  a.heap = L.heap;
  a.slots = L.slots;
  a.nvs = w + L.nvs;
  a.nlo = reinterpret_cast<uint32_t*>(w + L.nlo);
  a.nhi = reinterpret_cast<uint32_t*>(w + L.nhi);
  a.ncnt = w + L.ncnt;
  a.flags = w + L.flags;
  a.sleaf = reinterpret_cast<uint8_t*>(w + L.sleaf);
  a.nst = w + L.nst;
  a.nrs = w + L.nrs;
  a.nex = reinterpret_cast<uint8_t*>(w + L.nex);
  int32_t** slot[7] = {&a.sst, &a.srs, &a.svs, &a.sdp, &a.spst, &a.sprs,
                       &a.spvs};
  for (int f = 0; f < 7; ++f) *slot[f] = w + L.slot[f];
  a.agg = reinterpret_cast<uint32_t*>(w + L.agg);
  a.scnt = w + L.scnt;
  for (int q = 0; q < 2; ++q) {
    a.pts[q] = reinterpret_cast<float4*>(w + L.pts[q]);
    a.nodes[q] = w + L.nodes[q];
  }
  a.out_coords = out_coords;
  int32_t** i32[15] = {&a.out_perm, &a.leaf_start, &a.leaf_rsize,
                       &a.leaf_vsize, &a.leaf_depth, &a.par_start,
                       &a.par_rsize, &a.par_vsize, &a.slot_of_leaf,
                       &a.leaf_of_slot, &a.slot_cum, &a.num_leaves,
                       &a.traversals, &a.sort_passes, &a.max_leaf_vsize};
  for (int f = 0; f < 15; ++f) *i32[f] = static_cast<int32_t*>(out_i32[f]);
  uint8_t** u8[4] = {&a.out_valid, &a.is_leaf, &a.overflowed,
                     &a.cap_exceeded};
  for (int f = 0; f < 4; ++f) *u8[f] = static_cast<uint8_t*>(out_u8[f]);

  cudaError_t e = cudaMemsetAsync(scratch, 0, L.zeroed * 4, s);
  if (e != cudaSuccess) return (int)e;
  fc::Geometry g;
  auto go = [&](int stage, int l) -> cudaError_t {
    cudaError_t ge = partition_geometry(nb, n, depth, stage, &g);
    if (ge != cudaSuccess) return ge;
    const dim3 grid(g.grid[0], g.grid[1], g.grid[2]);
    switch (stage) {
      case kInit: partition_init_kernel<<<grid, g.threads, 0, s>>>(a); break;
      case kCount:
        partition_count_kernel<<<grid, g.threads, 0, s>>>(a, l);
        break;
      case kScatter:
        partition_scatter_kernel<<<grid, g.threads, 0, s>>>(a, l);
        break;
      case kSlots: partition_slots_kernel<<<grid, g.threads, 0, s>>>(a); break;
      default: partition_final_kernel<<<grid, g.threads, 0, s>>>(a); break;
    }
    ++*launched;
    return cudaGetLastError();
  };
  if ((e = go(kInit, 0)) != cudaSuccess) return (int)e;
  for (int l = 0; l < depth; ++l) {
    if ((e = go(kCount, l)) != cudaSuccess) return (int)e;
    if ((e = go(kScatter, l)) != cudaSuccess) return (int)e;
  }
  if ((e = go(kSlots, 0)) != cudaSuccess) return (int)e;
  return (int)go(kFinal, 0);
}

// fc_partition's launch of `stage` (0 init, 1 count, 2 scatter, 3 slots,
// 4 final) for these shapes, without a launch.
extern "C" int fc_partition_geometry(int nb, int n, int depth, int stage,
                                     int* out) {
  fc::Geometry g;
  const cudaError_t e = partition_geometry(nb, n, depth, stage, &g);
  fc::write_geometry(g, out);
  return (int)e;
}

// Attributes of a stage's kernel (variant = stage) at that launch.
extern "C" int fc_partition_attributes(int variant, int threads, int smem,
                                       int* out) {
  const void* fn = stage_kernel(variant);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fc::func_attributes(fn, threads, smem, out);
}
