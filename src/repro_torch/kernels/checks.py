"""Hold the CUDA kernels against their plain versions: the odd ladder of
inputs and the comparison rules, in one place for ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` (and, on CPU tensors, for the CPU tests, where
both sides run the plain version).

The ladder is that of tests/test_point_impls.py -- block sizes 65/200/33,
empty blocks, all-invalid masks, FPS exhaustion, out-of-range gathers --
plus FPS at the edges of its variants' widths (``fps.variant``): the
one-warp variant at 1, 32, 33, 256 and 512 lanes and the CTA variant at
513 (``fps_ladder``: only the last lane valid, two valid lanes, valid
lanes only in every thread's last slot, k = 1, duplicated lattice
points), blocks wider than one CTA of threads, at 1500, 3000, 5000 and
8192 lanes (two to eight points a thread), and the scratch-row variant
at 8193, 12,000 and 20,000 lanes, each with an empty block, a scattered
mask and exhaustion past lane 1024; ball query and kNN over 1500-lane
windows.  Ball query and kNN also meet the cases that catch a wrong
selection (``topk_ladder``): scattered (non-prefix) window masks,
windows of 1 to 15 valid lanes at ``num``=16, ``num``/``k`` of 1, 3, 16
and 40 (40 takes two passes of the register list), windows of 8,192 and
20,000 lanes (several shared-memory tiles), and duplicated lattice points
around lattice centres, where many distances are bit-equal and only the
lowest-lane rule decides.  The gather's backward,
``scatter_add_blocks``, has its own: windows of 33, 128 and 200 rows, 65
and 768 cotangent rows, 9, 64 and 128 channels, indices below 0, at or
above W and the -1 padding, a block whose rows all land on one slot, a
block whose rows all fall outside, no blocks at all, and a run chunked
through ``ops.gather_blocks``' autograd node against an unchunked one.
The partition level, ``fractal_level_blocks``, has its own too
(``level_ladder``): the same block sizes and masks under all three
``(da, db)`` pairs, a split value beyond the extents on either side (one
side empty), lanes exactly at the split value, blocks of 32, 256, 513 and
2048 lanes with valid lanes only in every thread's last slot, and a run
chunked through ``ops.fractal_level_blocks`` against an unchunked one.
The whole partition, ``partition`` (``partition_ladder``), is held
against its tensor pass on B of 1 and 4 clouds of 1, 65, 256, 257, 4,096
and 72,250 points (one and several 2048-point tiles, a node that spans
many), with an int ``dim0`` and a (B,) one (negative values included),
all-invalid clouds, clouds of one point repeated and of lattice points
(ties at the midpoint go left), a depth cap that overflows, and
``max_leaves_`` below the real leaf count.
The ball query also meets the InvResMLP blocks' stride-1 shape
(``stride1_ladder``): every lane of a 256-lane leaf block a centre against
its 512-lane window at ``num`` = 32, with the leaf's own points as the
centres (each its own nearest), empty and all-invalid blocks, scattered
masks, lane-misaligned widths (255 centres over 509 lanes), and a run
chunked through ``ops.ball_query_blocks`` against an unchunked one.
kNN meets Point Transformer's stride-1 shape (``knn_stride1_ladder``):
256 queries, the window's own lanes, valid or not, against 512 lanes at
``k`` = 8 and 16, with empty and all-invalid windows, scattered masks,
windows of 1 to 16 valid lanes (fewer than ``k``), lattice points repeated
8 times (bit-equal distances), and a run chunked through
``ops.knn_blocks`` against an unchunked one.
FPS, ball query, kNN and gather also run chunked through ``kernels.ops``
(``chunk_ladder``), as a model with ``leaf_chunk`` calls them: each chunk
a view into the middle of the block axis and the last chunk shorter,
against the plain version on the whole block axis.
The InvResMLP blocks' pooled local aggregation, ``local_aggregate``, has
its own (``aggregate_ladder``): C of 128, 256, 512 and 1024 (PointNeXt-XL's
widths, one float4 a thread at 32 to 256 threads a centre) and 2048 (two a
thread), ragged C (33, 9, 6) and a g that is not 16-byte aligned (one float
a thread), ns of 0, 1, 16, 32 and 40, runs of centres that cross a cloud's
end, centres with no valid slot, an all-masked cloud, and masked slots
whose index lies outside the cloud (never read).
The FP stage's blend, ``interp_blend``, has its own (``blend_ladder``):
C of 3, 9, 33 (one float a thread), 4, 32, 64, 128, 256 and 1024 (float4,
1 to 256 threads a lane), blocks of 256, 65 and 33 lanes, leaves that
overflow their block (rows past ``bs`` keep their values), slots that hold
no leaf, a cloud with no occupied lane, no blocks at all, lanes whose rows
fall before row 0 or past the last row (never written), an ``out`` that
is not 16-byte aligned, rows of ``out`` that no leaf holds (their values
kept), padded lanes whose rows of vals and wgt are NaN (never read), and
leaves blended a chunk at a time into one ``out`` against one call.
Point Transformer's attention layer, ``vector_attention``, has its own
(``attention_ladder``): each level's (C, k) of the published net, (32, 8),
(64, 16), (128, 16), (256, 16) and (512, 16) at G = 8 groups (every
tiling the kernel has: N = C / G of 4, 8, 16, 32 and 64), and C of 16, 48
(N of 2 and 6: zero-padded columns), 1024 (N = 128) and 64 at G = 4; k of
0, 1, 3 and 40; runs of points that cross a cloud's end; points with no
valid slot, an all-masked cloud, masked slots whose index lies outside
the cloud (never read), and a qkv that is not 16-byte aligned.

Rules:

* FPS, gather, the local aggregation and the blend must match exactly
  (the last two round every float op as their plain versions do, in the
  same order);
* the vector attention within ``ATTN_TOL`` of the largest output,
  absolutely (``hold_result``): the kernel sums in float32 FMAs, the w1
  layer's C-long sums a channel at a time where the plain version's
  matrix product blocks them, and its softmax's and weighted sum's sums in
  slot order, so the two differ by rounding that grows with C;
* ball query and kNN must match exactly: the same indices and bitwise the
  same d2 (the kernels round every float op as the plain versions do, and
  ties go to the lowest lane on both sides).  ``check_topk``, which allows
  near-tie flips, is the rule between the port and the JAX package, whose
  XLA dot rounds the last ulp differently;
* ball-query counts: the kernel squares the radius in double, the plain
  version in f32 (as the two JAX paths do), so a row's count may differ by
  at most the number of its valid lanes whose distance lies within
  ``D2_TOL`` of r^2 (``check_counts``);
* the partition level must match exactly: side bits, left counts and child
  extrema compared with ``==`` (min, max and a count do not depend on the
  order of the lanes; ``==`` holds -0 equal to +0);
* the partition must match exactly: every ``FractalPartition`` field equal,
  the coordinates bit for bit;
* scatter-add within ``SUM_TOL`` (absolute and relative).  CUDA's own
  ``scatter_add_`` adds with atomics in no fixed order, so the plain
  version scatters one row position at a time and sums each cell's rows
  in row order, as the kernel does; the two then agree exactly, and the
  tolerance stands for the order of float32 sums, which the function's
  contract does not fix;
* a model's gradients, card against CPU (``hold_grads``): every parameter
  gets a finite gradient that is not all zero (for an LM: not all zero
  where the CPU's is not, all zero where it is), within ``GRAD_REL_TOL``
  relative L2 of the CPU's.  The kernels repeat their plain versions' indices
  exactly, so what differs is the order of float32 sums (matmuls, the
  scatter-adds), far below this bar.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fractal
from repro_torch.kernels import (ball_query, fps, fractal_level, gather,
                                 interp_blend, knn, local_aggregate, ops,
                                 vector_attention)
from repro_torch.kernels.common import INF, sqdist_rows

D2_TOL = 1e-5
SUM_TOL = 1e-5
GRAD_REL_TOL = 1e-3
ATTN_TOL = 1e-5
KERNELS = ("fps_blocks", "ball_query_blocks", "knn_blocks", "gather_blocks",
           "scatter_add_blocks", "fractal_level_blocks", "partition",
           "local_aggregate", "interp_blend", "vector_attention")
LEVEL_DIMS = ((0, 1), (1, 2), (2, 0))


def blocks(seed, nb, bs, device, empty=0, invalid=False):
    """(coords (nb, bs, 3) f32, prefix mask (nb, bs) bool) from numpy; the
    first ``empty`` blocks have no valid lane, and none has if
    ``invalid``."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(0, 1, (nb, bs, 3)).astype(np.float32)
    nvalid = rng.integers(1, bs + 1, nb)
    nvalid[:empty] = 0
    if invalid:
        nvalid[:] = 0
    mask = np.arange(bs)[None, :] < nvalid[:, None]
    return (torch.from_numpy(coords).to(device),
            torch.from_numpy(mask).to(device))


def scattered(seed, nb, bs, device, p=0.5):
    """(coords (nb, bs, 3) f32, mask (nb, bs) bool) with each lane valid
    with probability ``p``, anywhere in the block."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(0, 1, (nb, bs, 3)).astype(np.float32)
    mask = rng.random((nb, bs)) < p
    return (torch.from_numpy(coords).to(device),
            torch.from_numpy(mask).to(device))


def lattice(seed, nb, copies, device):
    """Windows of the 4 x 4 x 4 integer lattice, each point ``copies``
    times in shuffled lane order (a fifth of the lanes invalid), and 16
    centres a block on lattice points and half-way between them: every
    product and sum is exact in f32, so equal distances are bit-equal.
    Returns (centres, cmask, window, wmask)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    pts = np.stack([rng.permutation(np.repeat(g, copies, 0))
                    for _ in range(nb)])
    mask = rng.random(pts.shape[:2]) < 0.8
    cen = np.stack([g[rng.choice(len(g), 16)] + 0.5 * rng.integers(
        0, 2, (16, 3)) for _ in range(nb)]).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(device)
    return t(cen), t(np.ones((nb, 16), bool)), t(pts), t(mask)


def topk_ladder(device) -> list:
    """[(name, arguments)] of the ball-query and kNN cases that catch a
    wrong selection."""
    calls = []

    def both(cen, cm, win, wm, num, radius=0.8):
        calls.append(("ball_query_blocks", dict(
            q=cen, cmask=cm, window=win, wmask=wm, radius=radius, num=num)))
        calls.append(("knn_blocks", dict(q=cen, window=win, wmask=wm,
                                          num=num)))

    for seed, p in ((40, 0.5), (41, 0.1)):               # scattered masks
        win, wm = scattered(seed, 4, 200, device, p)
        wm[0] = False
        cen, cm = blocks(seed + 10, 4, 13, device)
        both(cen, cm, win, wm, 16)
    win, _ = scattered(42, 15, 64, device)               # 1-15 valid lanes
    rng = np.random.default_rng(43)
    wm = torch.zeros((15, 64), dtype=torch.bool)
    for b in range(15):
        wm[b, torch.from_numpy(rng.choice(64, b + 1, replace=False))] = True
    cen, cm = blocks(44, 15, 9, device)
    both(cen, cm, win, wm.to(device), 16)
    win, wm = scattered(45, 3, 200, device)              # num/k 1..40
    cen, cm = blocks(46, 3, 40, device)
    for num in (1, 3, 16, 40):
        both(cen, cm, win, wm, num)
    for seed, bs in ((47, 8192), (48, 20_000)):          # several tiles
        win, wm = scattered(seed, 2, bs, device, 0.7)
        wm[1, : bs // 2] = False
        cen, cm = blocks(seed + 10, 2, 24, device)
        both(cen, cm, win, wm, 16, radius=0.3)
    both(cen, cm, win, wm, 40, radius=0.3)
    for copies in (2, 5):                                # bit-equal ties
        both(*lattice(50 + copies, 3, copies, device), 16, radius=1.0)
    return calls


def ladder(device) -> list:
    """[(kernel name, arguments)] of every ladder call."""
    calls = []
    for nb, bs in [(3, 65), (2, 200), (5, 33)]:
        for empty, invalid in [(0, False), (1, False), (0, True)]:
            c, m = blocks(0, nb, bs, device, empty, invalid)
            cen, cm = blocks(2, nb, 13, device, empty, invalid)
            calls.append(("fps_blocks", dict(coords=c, mask=m, k=7)))
            calls.append(("ball_query_blocks", dict(
                q=cen, cmask=cm, window=c, wmask=m, radius=0.8, num=5)))
            calls.append(("knn_blocks", dict(q=cen, window=c, wmask=m,
                                             num=3)))
        rng = np.random.default_rng(5)
        f = torch.from_numpy(rng.normal(0, 1, (nb, bs, 9)).astype(
            np.float32)).to(device)
        idx = torch.from_numpy(rng.integers(-3, bs + 3, (nb, 17)).astype(
            np.int32)).to(device)
        calls.append(("gather_blocks", dict(feats=f, idx=idx)))
    c, m = blocks(11, 3, 40, device, empty=1)
    m[1] = torch.arange(40, device=device) < 3           # FPS exhaustion
    calls.append(("fps_blocks", dict(coords=c, mask=m, k=7)))
    for bs in (1500, 3000, 5000, 8192, 8193, 12_000, 20_000):
        c, m = blocks(bs, 4, bs, device, empty=1)
        rng = np.random.default_rng(bs + 1)
        m[1] = False                                      # exhaustion, with
        m[1, torch.tensor([1100, bs - 1, 1030])] = True   # no valid lane < 1024
        m[2] = torch.from_numpy(rng.random(bs) < 0.5).to(device)
        calls.append(("fps_blocks", dict(coords=c, mask=m, k=33)))
    c, m = blocks(21, 3, 1500, device, empty=1)
    cen, cm = blocks(22, 3, 40, device)
    calls.append(("ball_query_blocks", dict(q=cen, cmask=cm, window=c,
                                            wmask=m, radius=0.5, num=16)))
    calls.append(("knn_blocks", dict(q=cen, window=c, wmask=m, num=3)))
    return (calls + fps_ladder(device) + topk_ladder(device)
            + stride1_ladder(device) + knn_stride1_ladder(device)
            + chunk_ladder(device) + scatter_ladder(device)
            + level_ladder(device) + partition_ladder(device)
            + aggregate_ladder(device)
            + blend_ladder(device) + attention_ladder(device))


def stride1_ladder(device) -> list:
    """[(name, arguments)] of the ball query at the stride-1 shape of the
    InvResMLP blocks: KC = 256 centres, a whole leaf block, against W = 512
    window lanes at ``num`` = 32."""
    calls = []

    def bq(cen, cm, win, wm, radius=0.5, chunk=None):
        args = dict(q=cen, cmask=cm, window=win, wmask=wm, radius=radius,
                    num=32)
        if chunk:
            args["chunk"] = chunk
        calls.append(("ball_query_blocks", args))

    def own(win, wm, kc, lo):
        """The window's lanes [lo, lo + kc) as the centres: a leaf inside
        its parent window, each centre its own nearest lane."""
        return win[:, lo:lo + kc].contiguous(), wm[:, lo:lo + kc].contiguous()

    win, wm = blocks(90, 6, 512, device, empty=1)     # prefix fills, 1 empty
    bq(*own(win, wm, 256, 0), win, wm)
    bq(*own(win, wm, 256, 128), win, wm, radius=0.25)
    win, wm = scattered(91, 4, 512, device, p=0.3)    # scattered lanes
    wm[1] = False
    bq(*own(win, wm, 256, 200), win, wm)
    win, wm = blocks(92, 3, 512, device, invalid=True)  # all invalid
    bq(*own(win, wm, 256, 0), win, wm)
    win, wm = blocks(93, 5, 509, device, empty=2)     # lane-misaligned
    bq(*own(win, wm, 255, 131), win, wm)
    win, wm = blocks(94, 7, 512, device, empty=1)     # chunked by 3
    bq(*own(win, wm, 256, 64), win, wm, chunk=3)
    return calls


def knn_stride1_ladder(device) -> list:
    """[(name, arguments)] of kNN at the stride-1 shape of Point
    Transformer's blocks: Q = 256 queries, a whole leaf block of the
    window's own lanes (every lane a query, valid or not), against W = 512
    window lanes at ``k`` = 8 and 16."""
    calls = []

    def knn(win, wm, lo, k, chunk=None):
        args = dict(q=win[:, lo:lo + 256].contiguous(), window=win,
                    wmask=wm, num=k)
        if chunk:
            args["chunk"] = chunk
        calls.append(("knn_blocks", args))

    win, wm = blocks(100, 6, 512, device, empty=1)    # prefix fills, 1 empty
    for k in (8, 16):
        knn(win, wm, 0, k)
        knn(win, wm, 256, k)
    win, wm = scattered(101, 4, 512, device, p=0.3)   # scattered lanes
    wm[1] = False
    knn(win, wm, 128, 16)
    win, wm = blocks(102, 3, 512, device, invalid=True)  # all invalid
    knn(win, wm, 0, 8)
    win, _ = scattered(103, 16, 512, device)          # 1-16 valid lanes
    rng = np.random.default_rng(104)
    wm = torch.zeros((16, 512), dtype=torch.bool)
    for b in range(16):
        wm[b, torch.from_numpy(rng.choice(512, b + 1, replace=False))] = True
    for k in (8, 16):
        knn(win, wm.to(device), 64, k)
    _, _, win, wm = lattice(105, 3, 8, device)        # bit-equal ties
    for k in (8, 16):
        knn(win, wm, 128, k)
    win, wm = blocks(106, 7, 512, device, empty=1)    # chunked by 3
    knn(win, wm, 200, 16, chunk=3)
    return calls


def chunk_ladder(device) -> list:
    """[(name, arguments with ``chunk``)] of FPS, ball query, kNN and
    gather run ``chunk`` blocks at a time through ``kernels.ops``: 7 blocks
    by 3 (a last chunk of one block) and 1100 blocks by 512, the models'
    ``leaf_chunk`` (a last chunk of 76)."""
    calls = []
    for nb, chunk, seed in ((7, 3, 80), (1100, 512, 81)):
        c, m = blocks(seed, nb, 64, device, empty=1)
        cen, cm = blocks(seed + 10, nb, 13, device, empty=1)
        calls.append(("fps_blocks", dict(coords=c, mask=m, k=7,
                                         chunk=chunk)))
        calls.append(("ball_query_blocks", dict(
            q=cen, cmask=cm, window=c, wmask=m, radius=0.8, num=5,
            chunk=chunk)))
        calls.append(("knn_blocks", dict(q=cen, window=c, wmask=m, num=3,
                                         chunk=chunk)))
        rng = np.random.default_rng(seed + 20)
        f = torch.from_numpy(rng.normal(0, 1, (nb, 64, 9)).astype(
            np.float32)).to(device)
        idx = torch.from_numpy(rng.integers(-3, 67, (nb, 17)).astype(
            np.int32)).to(device)
        calls.append(("gather_blocks", dict(feats=f, idx=idx, chunk=chunk)))
    return calls


def last_slots(bs, device):
    """(bs,) mask whose valid lanes are the block's last 32: the last lane
    that each of a warp's 32 threads takes."""
    return torch.arange(bs, device=device) >= bs - 32


def fps_ladder(device) -> list:
    """[("fps_blocks", arguments)] at the edges of the one-warp variant's
    width (1, 32 and 33 lanes: one and two slots a lane; 256, the main
    path's; 512 and 513, the last width one warp takes and the first the
    CTA variant takes): an empty block, only the last lane valid, two valid
    lanes (exhaustion at step 2), valid lanes only in every thread's last
    slot and a prefix, at k = 7 and k = 1; then duplicated lattice points,
    where distances are bit-equal across lanes and slots, at k = 65."""
    calls = []
    for bs in (1, 32, 33, 256, 512, 513):
        c, m = blocks(60 + bs, 5, bs, device, empty=1)
        m[1:4] = False
        m[1, bs - 1] = True                              # only the last lane
        m[2, torch.tensor([bs // 3, bs - 1])] = True     # two valid lanes
        m[3] = last_slots(bs, device)
        for k in (7, 1):
            calls.append(("fps_blocks", dict(coords=c, mask=m, k=k)))
        _, _, pts, pm = lattice(70 + bs, 3, bs // 64 + 2, device)
        calls.append(("fps_blocks", dict(coords=pts[:, :bs].contiguous(),
                                         mask=pm[:, :bs].contiguous(), k=65)))
    return calls


def scatter_ladder(device) -> list:
    """[("scatter_add_blocks", arguments)] of the scatter-add cases."""
    calls = []
    for seed, (w, m, c) in enumerate([(33, 65, 9), (128, 768, 64),
                                      (128, 768, 128), (200, 65, 64),
                                      (200, 768, 128), (33, 768, 9)]):
        rng = np.random.default_rng(30 + seed)
        nb = 4
        g = rng.normal(0, 1, (nb, m, c)).astype(np.float32)
        idx = rng.integers(-3, w + 3, (nb, m)).astype(np.int32)
        idx[:, ::7] = -1                                  # padding rows
        idx[1] = w // 2                                   # one slot takes all
        idx[2] = rng.choice([-5, -1, w, w + 9], m)        # all outside
        calls.append(("scatter_add_blocks", dict(
            g=torch.from_numpy(g).to(device),
            idx=torch.from_numpy(idx).to(device), w=w)))
    calls.append(("scatter_add_blocks", dict(
        g=torch.zeros((0, 65, 9), device=device),
        idx=torch.zeros((0, 65), dtype=torch.int32, device=device), w=33)))
    rng = np.random.default_rng(40)
    g = rng.normal(0, 1, (7, 768, 64)).astype(np.float32)
    idx = rng.integers(-2, 130, (7, 768)).astype(np.int32)
    calls.append(("scatter_add_blocks", dict(
        g=torch.from_numpy(g).to(device),
        idx=torch.from_numpy(idx).to(device), w=128, chunk=3)))
    return calls


def aggregate_args(seed, b, m, c, ns, device, *, none=0.05,
                   masked_cloud=False, misaligned=False) -> dict:
    """Arguments of one ``local_aggregate`` call: B clouds of m centres,
    each naming ``ns`` rows near its own (slot 0 itself, as the blocks'
    search gives it), ~70 % of the slots valid and a ``none`` share of the
    centres with none; masked slots hold indices outside [0, m) half of
    the time; ``masked_cloud`` masks every slot of the last cloud;
    ``misaligned`` puts g 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    i = np.arange(m)[None, :, None]
    idx = np.clip(i + rng.integers(-24, 25, (b, m, ns)), 0, m - 1)
    if ns:
        idx[..., 0] = i[..., 0]
    mask = rng.random((b, m, ns)) < 0.7
    if ns:
        mask[..., 0] = True
    mask[rng.random((b, m)) < none] = False
    if masked_cloud:
        mask[-1] = False
    far = rng.choice([-7, -1, m, m + 3, 2**31 - 1], (b, m, ns))
    idx = np.where(~mask & (rng.random((b, m, ns)) < 0.5), far, idx)
    g = rng.normal(0, 1, (b, m, c)).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(device)
    g_t = t(g)
    if misaligned:
        flat = torch.empty(g.size + 1, dtype=torch.float32, device=device)
        g_t = flat[1:].view(b, m, c)
        g_t.copy_(t(g))
    return dict(g=g_t, nidx=t(idx.astype(np.int32)), gmask=t(mask),
                rel=t(rng.uniform(-1, 1, (b, m, ns, 3)).astype(np.float32)),
                w_r=t(rng.normal(0, 1, (3, c)).astype(np.float32)),
                bias=t(rng.normal(-0.5, 0.5, c).astype(np.float32)))


def aggregate_ladder(device) -> list:
    """[("local_aggregate", arguments)] of the local aggregation's cases."""
    cases = ((2, 70, 33, 16, {}), (2, 70, 33, 32, {}),
             (3, 130, 128, 32, {}), (2, 90, 256, 32, {}),
             (2, 40, 512, 32, {}), (1, 40, 1024, 32, {}),
             (2, 50, 2048, 8, {}), (2, 65, 64, 1, {}),
             (2, 33, 12, 40, {}), (2, 20, 8, 0, {}),
             (3, 97, 9, 32, dict(masked_cloud=True, none=0.3)),
             (2, 130, 128, 32, dict(misaligned=True)),
             (2, 7, 6, 16, dict(none=0.5)))
    return [("local_aggregate", aggregate_args(100 + k, b, m, c, ns, device,
                                               **kw))
            for k, (b, m, c, ns, kw) in enumerate(cases)]


def attention_args(seed, b, m, c, k, device, *, groups=8, none=0.05,
                   masked_cloud=False, misaligned=False) -> dict:
    """Arguments of one ``vector_attention`` call: B clouds of m points,
    each naming ``k`` rows near its own (slot 0 itself, as the level's
    search gives it), ~70 % of the slots valid and a ``none`` share of the
    points with none; masked slots hold indices outside [0, m) half of the
    time; ``masked_cloud`` masks every slot of the last cloud.  Features
    and weights at the scales a trained layer has (unit q|k|v, offsets
    within half a metre, BatchNorm scales around 1), N = C / ``groups``;
    ``misaligned`` puts qkv 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    n = c // groups
    i = np.arange(m)[None, :, None]
    idx = np.clip(i + rng.integers(-24, 25, (b, m, k)), 0, m - 1)
    mask = rng.random((b, m, k)) < 0.7
    if k:
        idx[..., 0] = i[..., 0]
        mask[..., 0] = True
    mask[rng.random((b, m)) < none] = False
    if masked_cloud:
        mask[-1] = False
    far = rng.choice([-7, -1, m, m + 3, 2**31 - 1], (b, m, k))
    idx = np.where(~mask & (rng.random((b, m, k)) < 0.5), far, idx)

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)

    def normal(shape, sd):
        return t(rng.normal(0, sd, shape))

    qkv = normal((b, m, 3 * c), 1.0)
    if misaligned:
        flat = torch.empty(qkv.numel() + 1, dtype=torch.float32,
                           device=device)
        qkv = flat[1:].view(qkv.shape).copy_(qkv)
    return dict(
        qkv=qkv,
        nidx=torch.from_numpy(idx.astype(np.int32)).to(device),
        mask=torch.from_numpy(mask).to(device),
        rel=t(rng.uniform(-0.5, 0.5, (b, m, k, 3))),
        p1w=normal((3, 3), 3 ** -0.5), p1b=normal(3, 0.1),
        p2w=normal((3, c), 3 ** -0.5), p2b=normal(c, 0.1),
        s=t(rng.uniform(0.5, 1.5, c)),
        w1w=normal((c, n), c ** -0.5), w1b=normal(n, 0.1),
        w2w=normal((n, n), n ** -0.5), w2b=normal(n, 0.1),
        bn_scale=t(rng.uniform(0.5, 1.5, c)), bn_shift=normal(c, 0.2))


def attention_ladder(device) -> list:
    """[("vector_attention", arguments)] of the attention layer's cases."""
    cases = ((2, 300, 32, 8, {}), (2, 150, 64, 16, {}),
             (3, 70, 128, 16, {}), (2, 45, 256, 16, {}),
             (2, 33, 512, 16, {}), (1, 20, 1024, 16, {}),
             (2, 90, 16, 8, {}), (2, 70, 48, 16, {}),
             (2, 60, 64, 16, dict(groups=4)), (2, 40, 32, 0, {}),
             (2, 50, 32, 1, {}), (3, 61, 64, 3, {}), (2, 65, 32, 40, {}),
             (3, 97, 128, 16, dict(masked_cloud=True, none=0.3)),
             (2, 7, 32, 8, dict(none=0.5)),
             (2, 50, 64, 16, dict(misaligned=True)))
    return [("vector_attention", attention_args(600 + i, b, m, c, k, device,
                                                **kw))
            for i, (b, m, c, k, kw) in enumerate(cases)]


def blend_layout(seed, b, leaves, bs, *, fill=0.5, non_leaf=0.1, overflow=0,
                 extra_rows=5):
    """(start (B, leaves) int32, count (B, leaves) int32, rows): a leaf
    layout as the partition gives it, each cloud's leaves back to back in
    rows [0, rows - extra_rows) and ``extra_rows`` rows that no leaf holds
    after them.  A leaf holds 0 to 2 * fill * bs points (its first
    ``overflow`` leaves more than ``bs``: its count is capped at ``bs``);
    a ``non_leaf`` share of the slots hold no leaf (count 0, any start)."""
    rng = np.random.default_rng(seed)
    size = rng.integers(0, int(2 * fill * bs) + 1, (b, leaves))
    size[:, :overflow] = bs + rng.integers(1, bs + 1, (b, min(overflow,
                                                               leaves)))
    is_leaf = rng.random((b, leaves)) >= non_leaf
    size[~is_leaf] = 0
    start = np.cumsum(size, 1) - size
    rows = int(size.sum(1).max()) + extra_rows
    start = np.where(is_leaf, start, rng.integers(-9, rows + 9, (b, leaves)))
    count = np.where(is_leaf, np.minimum(size, bs), 0)
    t = lambda x: torch.from_numpy(x.astype(np.int32))
    return t(start), t(count), rows


def blend_args(seed, start, count, rows, bs, c, device, *,
               misaligned=False) -> dict:
    """Arguments of one ``interp_blend`` call over the layout ``start``,
    ``count`` (B, leaves): vals (NB, bs * 3, C) and weights (NB, bs, 3)
    drawn on ``device`` from the seed (a torch generator there: the card
    and the CPU draw other numbers), NaN on every lane that writes no row
    (never read), and an ``out`` (B, rows, C) of drawn values (rows the
    call does not write keep them); ``misaligned`` puts ``out`` 4 bytes
    past a 16-byte boundary."""
    b, leaves = start.shape
    nb = b * leaves
    start = start.reshape(nb).to(device)
    count = count.reshape(nb).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, keep = interp_blend.occupied_rows(rows, start, count, bs)
    vals = torch.randn((nb, bs, 3, c), generator=gen, device=device)
    vals = vals.masked_fill_(~keep[..., None, None], float("nan"))
    w = torch.rand((nb, bs, 3), generator=gen, device=device) + 1e-3
    wgt = (w / w.sum(-1, keepdim=True)).masked_fill_(~keep[..., None],
                                                       float("nan"))
    out = torch.randn((b, rows, c), generator=gen, device=device)
    if misaligned:
        flat = torch.empty(out.numel() + 1, dtype=torch.float32,
                           device=device)
        flat[1:].copy_(out.reshape(-1))
        out = flat[1:].view(b, rows, c)
    return dict(vals=vals.view(nb, bs * 3, c), wgt=wgt, leaf_start=start,
                count=count, out=out)


def blend_ladder(device) -> list:
    """[("interp_blend", arguments)] of the blend's cases."""
    calls = []
    for k, (b, leaves, bs, c, kw) in enumerate((
            (2, 5, 256, 128, dict(overflow=1)),
            (2, 6, 256, 32, {}), (3, 4, 65, 64, dict(overflow=2)),
            (2, 3, 33, 256, dict(fill=0.9)), (1, 3, 65, 1024, {}),
            (2, 5, 65, 4, {}), (2, 7, 33, 3, dict(non_leaf=0.4)),
            (2, 4, 256, 9, dict(overflow=1)), (3, 3, 65, 33, {}))):
        start, count, rows = blend_layout(200 + k, b, leaves, bs, **kw)
        calls.append(("interp_blend", blend_args(300 + k, start, count, rows,
                                                 bs, c, device)))
    start, count, rows = blend_layout(210, 3, 4, 65)
    count[1] = 0                                        # no occupied lane
    calls.append(("interp_blend", blend_args(310, start, count, rows, 65, 64,
                                             device)))
    start, count, rows = blend_layout(211, 2, 4, 65, extra_rows=0)
    calls.append(("interp_blend", blend_args(311, start, count, rows, 65, 128,
                                             device, misaligned=True)))
    # rows outside [0, rows): lanes before row 0 and past the last row
    start = torch.tensor([[-3, 10, 45], [-70, 0, 48]], dtype=torch.int32)
    count = torch.tensor([[5, 5, 10], [65, 7, 65]], dtype=torch.int32)
    calls.append(("interp_blend", blend_args(312, start, count, 50, 65, 32,
                                             device)))
    calls.append(("interp_blend", blend_args(
        313, torch.zeros((0, 3), dtype=torch.int32),
        torch.zeros((0, 3), dtype=torch.int32), 7, 65, 32, device)))
    start, count, rows = blend_layout(214, 3, 7, 65, overflow=1)
    calls.append(("interp_blend", dict(blend_args(314, start, count, rows, 65,
                                                  64, device), chunk=3)))
    return calls


def level_ladder(device) -> list:
    """[("fractal_level_blocks", arguments)] of the partition-level cases."""
    calls = []
    for nb, bs in [(3, 65), (2, 200), (5, 33)]:
        for empty, invalid in [(0, False), (1, False), (0, True)]:
            c, m = blocks(6, nb, bs, device, empty, invalid)
            mid = torch.from_numpy(np.random.default_rng(7).normal(
                0, 0.5, nb).astype(np.float32)).to(device)
            for da, db in LEVEL_DIMS:
                calls.append(("fractal_level_blocks", dict(
                    coords=c, mask=m, mid=mid, da=da, db=db)))
    c, m = blocks(8, 4, 65, device, empty=1)
    for da, db in LEVEL_DIMS:
        for far in (1e3, -1e3):                  # one side empty
            calls.append(("fractal_level_blocks", dict(
                coords=c, mask=m, mid=torch.full((4,), far, device=device),
                da=da, db=db)))
        tied = c.clone()                         # lanes exactly at mid
        mid = torch.tensor([0.25, -0.5, 0.0, 1.5], device=device)
        tied[:, ::3, da] = mid[:, None]
        calls.append(("fractal_level_blocks", dict(
            coords=tied, mask=m, mid=mid, da=da, db=db)))
    for bs in (32, 256, 513, 2048):             # the one-warp kernel's edges
        c, m = blocks(12 + bs, 4, bs, device, empty=1)
        m[2] = last_slots(bs, device)
        mid = torch.from_numpy(np.random.default_rng(bs).normal(
            0, 0.5, 4).astype(np.float32)).to(device)
        for da, db in LEVEL_DIMS:
            calls.append(("fractal_level_blocks", dict(
                coords=c, mask=m, mid=mid, da=da, db=db)))
    c, m = blocks(9, 7, 200, device, empty=1)
    mid = torch.from_numpy(np.random.default_rng(10).normal(
        0, 0.5, 7).astype(np.float32)).to(device)
    calls.append(("fractal_level_blocks", dict(
        coords=c, mask=m, mid=mid, da=1, db=2, chunk=3)))
    return calls


def partition_args(coords, valid, *, th: int, dim0=0, depth=None,
                   max_leaves_=None) -> dict:
    """Arguments of one ``partition`` call, with the depth and the leaf
    slots resolved as ``core.fractal.partition`` resolves them, and a
    tensor ``dim0`` as the int64 (B,) one it hands on."""
    n = coords.shape[1]
    depth = fractal.default_depth(n, th) if depth is None else depth
    ml = (fractal.max_leaves(n, th, depth) if max_leaves_ is None
          else max_leaves_)
    if isinstance(dim0, torch.Tensor):
        dim0 = dim0.to(device=coords.device, dtype=torch.int64)
    return dict(coords=coords, valid=valid, th=th, depth=depth, ml=ml,
                dim0=dim0)


def partition_ladder(device) -> list:
    """[("partition", arguments)] of the partition cases."""
    calls = []

    def cloud(seed, b, n, p=0.9):
        rng = np.random.default_rng(seed)
        c = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
        v = rng.random((b, n)) < p
        return torch.from_numpy(c).to(device), torch.from_numpy(v).to(device)

    def add(c, v, th, **kw):
        calls.append(("partition", partition_args(c, v, th=th, **kw)))

    for b in (1, 4):
        phases = torch.tensor([1, -4, 5, 3][:b])
        for n in (1, 65, 256, 257, 4096, 72_250):
            c, v = cloud(90 + n + b, b, n)
            th = 32 if n <= 257 else 256
            add(c, v, th, dim0=b % 3)
            add(c, v, th, dim0=phases)
    c, v = cloud(91, 4, 257)                             # all-invalid clouds
    v[1] = False
    add(c, v, 32)
    add(c[:1], torch.zeros_like(v[:1]), 32, dim0=2)
    same = torch.full((2, 257, 3), 0.25, device=device)  # one point repeated
    same[1, :, 1] = -3.0
    sv = torch.ones((2, 257), dtype=torch.bool, device=device)
    sv[1, ::5] = False
    add(same, sv, 32, dim0=torch.tensor([0, 2]))
    rng = np.random.default_rng(92)                      # lattice points
    g = rng.integers(0, 4, (3, 3000, 3)).astype(np.float32)
    add(torch.from_numpy(g).to(device),
        torch.from_numpy(rng.random((3, 3000)) < 0.8).to(device), 64,
        dim0=torch.tensor([0, 1, 2]))
    c, v = cloud(93, 4, 4096)
    add(c, v, 64, depth=3)                              # overflows at the cap
    add(c, v, 64, max_leaves_=5)                        # leaves past ML
    add(c, v, 64, depth=4, max_leaves_=3, dim0=torch.tensor([2, 0, 1, 1]))
    return calls


def level_at_midpoints(coords, mask, da: int, db: int) -> dict:
    """Arguments of one ``fractal_level_blocks`` call on blocks ``coords``
    (..., BS, 3) with ``mask`` (..., BS), flattened to (NB, BS), each block
    split at the midpoint of its valid lanes on ``da`` (0 for a block with
    none): the split the partition makes next at such a node."""
    bs = mask.shape[-1]
    c = coords.reshape(-1, bs, 3).contiguous()
    m = mask.reshape(-1, bs).contiguous()
    xa = c[..., da]
    lo = torch.where(m, xa, INF).amin(-1)
    hi = torch.where(m, xa, -INF).amax(-1)
    mid = torch.where(m.any(-1), (lo + hi) * 0.5, 0.0)
    return dict(coords=c, mask=m, mid=mid, da=da, db=db)


def _gather_grad(g, idx, w, chunk):
    """The window's gradient through ``ops.gather_blocks`` with ``chunk``:
    one ``Gathering`` node, and so one scatter-add, per chunk."""
    f = torch.zeros((g.shape[0], w, g.shape[2]), device=g.device,
                    requires_grad=True)
    (df,) = torch.autograd.grad(ops.gather_blocks(f, idx, chunk=chunk), f, g)
    return df


def _blend_chunks(chunk, out, vals, wgt, leaf_start, count):
    """``ops.interp_blend`` over ``chunk`` leaves of every cloud at a time,
    into ``out``, as ``core.bppo.blockwise_interpolate`` calls it with a
    leaf chunk."""
    b = out.shape[0]
    per = lambda x: x.reshape(b, -1, *x.shape[1:])
    for v, w, s, k in ops.leaf_chunks((per(vals), per(wgt), per(leaf_start),
                                       per(count)), chunk, dim=1):
        out = ops.interp_blend(out, v.reshape(-1, *v.shape[2:]),
                               w.reshape(-1, *w.shape[2:]), s.reshape(-1),
                               k.reshape(-1))
    return out


def runners(name: str, args: dict):
    """(kernel call, plain call) on one call's arguments; with ``chunk``
    the kernel runs through ``kernels.ops`` that many blocks at a time,
    and the plain version on the whole block axis."""
    chunk = args.get("chunk")
    if name == "fps_blocks":
        c, m, k = args["coords"], args["mask"], args["k"]
        return ((lambda: ops.fps_blocks(c, m, k=k, chunk=chunk)) if chunk
                else (lambda: fps.fps_blocks(c, m, k=k)),
                lambda: fps.fps_plain(c, m, k))
    if name == "gather_blocks":
        f, i = args["feats"], args["idx"]
        return ((lambda: ops.gather_blocks(f, i, chunk=chunk)) if chunk
                else (lambda: gather.gather_blocks(f, i)),
                lambda: gather.gather_plain(f, i))
    if name == "scatter_add_blocks":
        g, i, w = args["g"], args["idx"], args["w"]
        return ((lambda: _gather_grad(g, i, w, chunk)) if chunk
                else (lambda: gather.scatter_add_blocks(g, i, w=w)),
                lambda: gather.scatter_add_plain(g, i, w=w))
    if name == "fractal_level_blocks":
        c, m, mid = args["coords"], args["mask"], args["mid"]
        kw = dict(da=args["da"], db=args["db"])
        return ((lambda: ops.fractal_level_blocks(c, m, mid, chunk=chunk,
                                                  **kw)) if chunk
                else (lambda: fractal_level.fractal_level_blocks(c, m, mid,
                                                                 **kw)),
                lambda: fractal_level.fractal_level_plain(c, m, mid, **kw))
    if name == "local_aggregate":
        return (lambda: local_aggregate.local_aggregate(**args),
                lambda: local_aggregate.local_aggregate_plain(**args))
    if name == "vector_attention":
        return (lambda: vector_attention.vector_attention(**args),
                lambda: vector_attention.vector_attention_plain(**args))
    if name == "interp_blend":
        # The blend writes in place: the kernel into one copy of ``out``,
        # made here (a repeated call rewrites the same rows), the plain
        # version into a fresh copy a call.
        a = {k: v for k, v in args.items() if k != "chunk"}
        own = dict(a, out=a["out"].clone())
        return ((lambda: _blend_chunks(chunk, **own)) if chunk
                else (lambda: interp_blend.interp_blend(**own)),
                lambda: interp_blend.interp_blend_plain(
                    **dict(a, out=a["out"].clone())))
    if name == "partition":
        c, v = args["coords"], args["valid"]
        kw = dict(th=args["th"], depth=args["depth"], dim0=args["dim0"])
        return ((lambda: fractal.partition(c, v, max_leaves_=args["ml"],
                                           on_overflow="silent", **kw)),
                lambda: fractal.tensor_pass(c, v, strategy=fractal.FRACTAL,
                                            ml=args["ml"], **kw))
    q, w, wm, num = args["q"], args["window"], args["wmask"], args["num"]
    if name == "ball_query_blocks":
        cm, r = args["cmask"], args["radius"]
        return ((lambda: ops.ball_query_blocks(q, cm, w, wm, radius=r,
                                               num=num, chunk=chunk))
                if chunk else
                (lambda: ball_query.ball_query_blocks(q, cm, w, wm, radius=r,
                                                      num=num)),
                lambda: ball_query.ball_query_plain(q, cm, w, wm, radius=r,
                                                    num=num))
    return ((lambda: ops.knn_blocks(q, w, wm, k=num, chunk=chunk)) if chunk
            else (lambda: knn.knn_blocks(q, w, wm, k=num)),
            lambda: knn.knn_plain(q, w, wm, k=num))


def check_topk(idx_a, d2_a, idx_b, d2_b, queries, window, wmask, *,
               tol: float) -> int:
    """Hold one top-k result (a) against another (b) of the same rows of
    ``queries`` (NB, Q, 3) against ``window`` (NB, W, 3) under ``wmask``.

    ``d2`` must agree within ``tol`` rank by rank.  Indices must agree
    exactly except at near-ties: where they differ, the plain distance of
    a's lane must lie within ``tol`` of b's distance at that rank; exhausted
    slots (INF on both sides) must hold the same lane.  Returns the number
    of near-tie flips; raises AssertionError on a real disagreement."""
    fin = (d2_a < INF) & (d2_b < INF)
    both_inf = (d2_a >= INF) & (d2_b >= INF)
    bad_d2 = ~(both_inf | (fin & ((d2_a - d2_b).abs() <= tol)))
    if bool(bad_d2.any()):
        worst = (d2_a - d2_b).abs()[bad_d2].max()
        raise AssertionError(f"top-k d2 disagree at {int(bad_d2.sum())} "
                             f"entries (worst {float(worst)})")
    diff = idx_a != idx_b
    if not bool(diff.any()):
        return 0
    d = torch.where(wmask[:, None, :], sqdist_rows(queries, window), INF)
    tie = (torch.gather(d, -1, idx_a.long()) - d2_b).abs() <= tol
    bad = diff & (both_inf | ~tie)
    if bool(bad.any()):
        raise AssertionError(f"top-k indices disagree at {int(bad.sum())} "
                             f"entries that are not near-ties")
    return int(diff.sum())


def check_counts(cnt_a, cnt_b, centers, window, wmask, *, radius: float,
                 tol: float) -> int:
    """Hold two ball-query counts (NB, KC) of the same rows against each
    other: a row's counts may differ by at most the number of its valid
    lanes whose distance lies within ``tol * max(r^2, 1)`` of r^2.  Returns
    the number of rows that differ; raises AssertionError otherwise."""
    diff = (cnt_a.long() - cnt_b.long()).abs()
    if not bool(diff.any()):
        return 0
    d = sqdist_rows(centers, window)
    r2 = float(radius) ** 2
    edge = (((d - r2).abs() <= tol * max(r2, 1.0))
            & wmask[:, None, :]).sum(-1)
    if bool((diff > edge).any()):
        raise AssertionError(f"ball-query counts differ by more than their "
                             f"boundary lanes in {int((diff > edge).sum())} "
                             f"rows")
    return int((diff > 0).sum())


def hold_picks(name: str, got, want) -> None:
    """Ball query or kNN output (idx, d2, ...) against another: the same
    indices and bitwise the same d2, or raise."""
    if got[0].shape != want[0].shape or got[1].shape != want[1].shape:
        raise AssertionError(f"{name}: shape {tuple(got[0].shape)}, plain "
                             f"version {tuple(want[0].shape)}")
    bad = (got[0] != want[0]) | (got[1].view(torch.int32)
                                 != want[1].view(torch.int32))
    if bool(bad.any()):
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{int(bad.sum())} of {bad.numel()} picks")


def hold(name: str, args: dict, tol: float = D2_TOL) -> dict:
    """Run the kernel and its plain version on one call's arguments and
    compare them.  Returns {max_abs_err, count_rows}."""
    run_kernel, run_plain = runners(name, args)
    return hold_result(name, args, run_kernel(), run_plain(), tol)


def hold_result(name: str, args: dict, got, want, tol: float = D2_TOL) -> dict:
    """One call's kernel output ``got`` against its plain version's
    ``want``, by the rules above.  Returns {max_abs_err, count_rows}."""
    if name == "scatter_add_blocks":
        torch.testing.assert_close(got, want, atol=SUM_TOL, rtol=SUM_TOL)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        return {"max_abs_err": err, "count_rows": 0}
    if name == "fractal_level_blocks":
        for part, a, b in zip(("side", "left_count", "child_stats"), got,
                              want):
            if a.shape != b.shape or not bool((a == b).all()):
                raise AssertionError(f"fractal_level_blocks: {part} differs "
                                     f"from its plain version")
        return {"max_abs_err": 0.0, "count_rows": 0}
    if name == "partition":
        for field in got.__dataclass_fields__:
            a, b = getattr(got, field), getattr(want, field)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"partition: {field} differs from the "
                                     f"tensor pass")
        return {"max_abs_err": 0.0, "count_rows": 0}
    if name == "vector_attention":
        if got.shape != want.shape:
            raise AssertionError(f"vector_attention: shape "
                                 f"{tuple(got.shape)}, plain version "
                                 f"{tuple(want.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        top = float(want.abs().max()) if want.numel() else 0.0
        if not err <= ATTN_TOL * max(top, 1.0):
            raise AssertionError(f"vector_attention differs from its plain "
                                 f"version by {err:.3g} (largest output "
                                 f"{top:.3g}, tolerance {ATTN_TOL})")
        return {"max_abs_err": err, "count_rows": 0}
    if name in ("fps_blocks", "gather_blocks", "local_aggregate",
                "interp_blend"):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{int((got != want).sum())} entries")
        return {"max_abs_err": 0.0, "count_rows": 0}
    hold_picks(name, got, want)
    rows = 0
    if name == "ball_query_blocks":
        rows = check_counts(got[2], want[2], args["q"], args["window"],
                            args["wmask"], radius=args["radius"], tol=tol)
    return {"max_abs_err": 0.0, "count_rows": rows}


def hold_grads(card: dict, cpu: dict, tol: float = GRAD_REL_TOL,
               zero_ok: bool = False) -> dict:
    """Hold gradients {name: tensor or None} computed on the card against
    the same parameters' gradients on the CPU.  Raises if a parameter has
    no gradient, a non-finite one or an all-zero one on the card, or
    differs from the CPU's by more than ``tol`` in relative L2.  With
    ``zero_ok`` (an LM, whose MoE experts may see no token), a parameter
    whose CPU gradient is all zero must be all zero on the card too, and
    holds at 0.  Returns {name: relative L2}."""
    if sorted(card) != sorted(cpu):
        raise AssertionError("the two gradient sets name different "
                             "parameters")

    def zero(g):
        return g is None or not bool(g.abs().sum() > 0)

    inf = [k for k, g in card.items()
           if g is not None and not bool(torch.isfinite(g).all())]
    if inf:
        raise AssertionError(f"non-finite gradients on the card: {inf}")

    idle = {k for k, g in cpu.items() if zero_ok and zero(g)}
    silent = [k for k, g in card.items() if k not in idle and zero(g)]
    if silent:
        raise AssertionError(f"{len(silent)} of {len(card)} parameters get "
                             f"no gradient on the card: {silent}")
    bad = [k for k in idle if not zero(card[k])]
    if bad:
        raise AssertionError(f"parameters with an all-zero gradient on the "
                             f"CPU get one on the card: {bad}")
    rel = {}
    for k, g in card.items():
        if k in idle:
            rel[k] = 0.0
            continue
        want = cpu[k].double()
        rel[k] = float((g.double().cpu() - want).norm()
                       / want.norm().clamp(min=1e-30))
    bad = {k: r for k, r in rel.items() if not r <= tol}
    if bad:
        raise AssertionError(f"gradients differ from the CPU's beyond {tol} "
                             f"(relative L2): {bad}")
    return rel


# ---------------------------------------------------------------------------
# The work a call needs, and the main path's own calls.
# ---------------------------------------------------------------------------

def work(name: str, args: dict) -> tuple[float, float]:
    """(bytes, operations) that one call needs on these inputs: each input
    read once and each output written once, but coordinates only of valid
    lanes (masks in full), queries only of blocks whose window has a valid
    lane, and for gather only the distinct in-range feature rows that the
    indices name; operations only on valid lanes, for the steps or ranks
    a block's valid lanes can fill."""
    if name == "fps_blocks":
        m, k = args["mask"], args["k"]
        nb = m.shape[0]
        nv = m.sum(1)
        steps = (nv.clamp(max=k) - 1).clamp(min=0)
        # a step folds the pick into each valid lane: 3 sub, 3 mul, 2 add,
        # min, compare
        return (int(nv.sum()) * 12 + m.numel() + nb * k * 4,
                float((nv * steps).sum()) * 10.0)
    if name in ("ball_query_blocks", "knn_blocks"):
        q, wm, num = args["q"], args["wmask"], args["num"]
        nb, nq = q.shape[:2]
        nv = wm.sum(1)
        live = int((nv > 0).sum())
        # a pair: distance (8), then one compare per rank the row can fill
        ops_ = float((nv * (8 + nv.clamp(max=num))).sum()) * nq
        nbytes = (live * nq * 12 + int(nv.sum()) * 12 + wm.numel()
                  + nb * nq * num * 8)
        if name == "ball_query_blocks":
            cm = args["cmask"]
            ops_ += float((cm.sum(1) * nv).sum()) * 2.0   # radius test, count
            nbytes += cm.numel() + nb * nq * 4
        return nbytes, ops_
    if name == "fractal_level_blocks":
        # reads the mask, the split values and two coordinates of each
        # valid lane; writes the side bits, counts and four extrema; a
        # valid lane costs a compare, a count and two min/max
        m = args["mask"]
        nb, bs = m.shape
        nv = int(m.sum())
        return (m.numel() + nb * 4 + nv * 8 + nb * bs * 4 + nb * 4
                + nb * 16, float(nv) * 4.0)
    if name == "partition":
        # reads each point and its valid flag, writes the permuted points,
        # flags and indices, the leaf arrays (ML slots), the slot
        # bookkeeping (2^depth slots) and four numbers a cloud; the
        # splits themselves are compares, counted as nothing
        b, n = args["valid"].shape
        ml, slots = args["ml"], 1 << args["depth"]
        return (b * n * (13 + 17) + b * ml * (8 * 4 + 1)
                + b * (2 * slots + 1) * 4 + b * 18, 0.0)
    if name == "local_aggregate":
        # reads the distinct rows of g that valid slots name, each valid
        # slot's index and offsets, every mask bit, w_r and the bias;
        # writes the output; a valid slot costs 8 operations a channel
        # (three products, four sums, a max)
        g, idx, msk = args["g"], args["nidx"], args["gmask"]
        b, m, c = g.shape
        ok = msk & (idx >= 0) & (idx < m)
        key = torch.arange(b, device=idx.device)[:, None, None] * m + \
            idx.long()
        rows = int(torch.unique(key[ok]).numel())
        slots = int(ok.sum())
        return (rows * c * 4 + slots * 16 + msk.numel() + c * 16
                + b * m * c * 4, float(slots * c) * 8.0)
    if name == "vector_attention":
        # reads q|k|v once a point, each slot's index, mask bit and
        # offsets, and the weights; writes one C-row a point; the delta and
        # w layers take 2 (9 + 3 C + C N + N^2) operations a valid slot
        qkv, idx, msk = args["qkv"], args["nidx"], args["mask"]
        b, m, c3 = qkv.shape
        c, n = c3 // 3, args["w2w"].shape[0]
        slots = int((msk & (idx >= 0) & (idx < m)).sum())
        weights = sum(args[w].numel() for w in vector_attention.WEIGHTS)
        return (b * m * (16 * c + 17 * idx.shape[2]) + weights * 4,
                float(slots) * 2.0 * (9 + 3 * c + c * n + n * n))
    if name == "scatter_add_blocks":
        # reads the indices and each in-range cotangent row, writes the
        # whole window tile; one add per in-range (row, channel)
        g, idx, w = args["g"], args["idx"], args["w"]
        nb, _, c = g.shape
        rows = int(((idx >= 0) & (idx < w)).sum())
        return idx.numel() * 4 + rows * c * 4 + nb * w * c * 4, float(rows * c)
    if name == "interp_blend":
        # reads each block's start and count, and each occupied lane's
        # three neighbour rows and three weights; writes the lane's row of
        # out; 5 operations a lane and channel (three products, two sums)
        out, wgt = args["out"], args["wgt"]
        c = out.shape[2]
        _, keep = interp_blend.occupied_rows(out.shape[1], args["leaf_start"],
                                             args["count"], wgt.shape[1])
        lanes = int(keep.sum())
        return (wgt.shape[0] * 8 + lanes * (16 * c + 12),
                float(lanes * c) * 5.0)
    f, idx = args["feats"], args["idx"]
    nb, w, c = f.shape
    ok = (idx >= 0) & (idx < w)
    key = torch.arange(nb, device=idx.device)[:, None] * w + idx.long()
    rows = int(torch.unique(key[ok]).numel())
    return rows * c * 4 + idx.numel() * 4 + idx.numel() * c * 4, 0.0


class Recorder:
    """Record the arguments of every kernel call that ``kernels.ops`` makes
    (the main path's own inputs) for the length of one forward, or one
    forward and backward, by handing ``ops`` stand-ins for its kernel
    modules; the kernels themselves and their launch counters are
    untouched.  ``calls`` holds (name, arguments), or with ``tally`` (name,
    ``tally(name, arguments)``), computed at the call so the arguments can
    be freed.  A call (and its tally) runs with any ``TorchDispatchMode``
    around it suspended, so a mode that counts the path's operations sees
    none of the kernel's own (``work`` counts those)."""

    def __init__(self, tally=None):
        self.calls = []
        self.tally = tally

    def __enter__(self):
        import types

        from torch.utils._python_dispatch import _disable_current_modes

        def stand_in(mod, name, to_args, **more):
            def wrap(name, to_args):
                orig = getattr(mod, name)

                def rec(*a, **kw):
                    with _disable_current_modes():
                        args = to_args(*a, **kw)
                        self.calls.append((name, args if self.tally is None
                                           else self.tally(name, args)))
                        return orig(*a, **kw)
                return rec
            fns = {name: to_args, **more}
            return types.SimpleNamespace(
                **{n: wrap(n, f) for n, f in fns.items()})

        self._saved = {a: getattr(ops, a) for a in ("_fps", "_bq", "_knn",
                                                     "_ga", "_la", "_ib",
                                                     "_va")}
        ops._fps = stand_in(ops._fps, "fps_blocks",
                            lambda c, m, *, k: dict(coords=c, mask=m, k=k))
        ops._bq = stand_in(
            ops._bq, "ball_query_blocks",
            lambda c, cm, w, wm, *, radius, num: dict(
                q=c, cmask=cm, window=w, wmask=wm, radius=radius, num=num))
        ops._knn = stand_in(
            ops._knn, "knn_blocks",
            lambda q, w, wm, *, k: dict(q=q, window=w, wmask=wm, num=k))
        ops._ga = stand_in(
            ops._ga, "gather_blocks", lambda f, i: dict(feats=f, idx=i),
            scatter_add_blocks=lambda g, i, *, w: dict(g=g, idx=i, w=w))
        ops._la = stand_in(
            ops._la, "local_aggregate",
            lambda g, nidx, gmask, rel, w_r, bias: dict(
                g=g, nidx=nidx, gmask=gmask, rel=rel, w_r=w_r, bias=bias))
        ops._ib = stand_in(
            ops._ib, "interp_blend",
            lambda out, vals, wgt, leaf_start, count: dict(
                vals=vals, wgt=wgt, leaf_start=leaf_start, count=count,
                out=out))
        names = ("qkv", "nidx", "mask", "rel") + vector_attention.WEIGHTS
        ops._va = stand_in(ops._va, "vector_attention",
                           lambda *a: dict(zip(names,
                                               (t.detach() for t in a))))
        return self

    def __exit__(self, *exc):
        for alias, mod in self._saved.items():
            setattr(ops, alias, mod)
        return False
