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
FPS, ball query, kNN and gather also run chunked through ``kernels.ops``
(``chunk_ladder``), as a model with ``leaf_chunk`` calls them: each chunk
a view into the middle of the block axis and the last chunk shorter,
against the plain version on the whole block axis.

Rules:

* FPS and gather must match exactly;
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

from repro_torch.kernels import (ball_query, fps, fractal_level, gather, knn,
                                 ops)
from repro_torch.kernels.common import INF, sqdist_rows

D2_TOL = 1e-5
SUM_TOL = 1e-5
GRAD_REL_TOL = 1e-3
KERNELS = ("fps_blocks", "ball_query_blocks", "knn_blocks", "gather_blocks",
           "scatter_add_blocks", "fractal_level_blocks")
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
            + chunk_ladder(device) + scatter_ladder(device)
            + level_ladder(device))


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
    if name in ("fps_blocks", "gather_blocks"):
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
    if name == "scatter_add_blocks":
        # reads the indices and each in-range cotangent row, writes the
        # whole window tile; one add per in-range (row, channel)
        g, idx, w = args["g"], args["idx"], args["w"]
        nb, _, c = g.shape
        rows = int(((idx >= 0) & (idx < w)).sum())
        return idx.numel() * 4 + rows * c * 4 + nb * w * c * 4, float(rows * c)
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
                                                     "_ga")}
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
        return self

    def __exit__(self, *exc):
        for alias, mod in self._saved.items():
            setattr(ops, alias, mod)
        return False
