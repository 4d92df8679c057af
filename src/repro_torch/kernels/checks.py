"""Hold the CUDA kernels against their plain versions: the odd ladder of
inputs and the comparison rules, in one place for ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` (and, on CPU tensors, for the CPU tests, where
both sides run the plain version).

The ladder is that of tests/test_point_impls.py -- block sizes 65/200/33,
empty blocks, all-invalid masks, FPS exhaustion, out-of-range gathers --
plus blocks wider than one CTA of threads: FPS at 1500, 3000 and 5000
lanes (two, three and five points a thread, with scattered masks and
exhaustion past lane 1024), ball query and kNN over 1500-lane windows
(shared memory above the 48 KB default).

Rules:

* FPS and gather must match exactly;
* ball query and kNN: d2 within ``D2_TOL`` rank by rank, indices exactly
  except at near-ties (``check_topk``);
* ball-query counts: the kernel squares the radius in double, the plain
  version in f32 (as the two JAX paths do), so a row's count may differ by
  at most the number of its valid lanes whose distance lies within
  ``D2_TOL`` of r^2 (``check_counts``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ball_query, fps, gather, knn
from repro_torch.kernels.common import INF, sqdist_rows

D2_TOL = 1e-5
KERNELS = ("fps_blocks", "ball_query_blocks", "knn_blocks", "gather_blocks")


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
    for bs in (1500, 3000, 5000):
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
    return calls


def runners(name: str, args: dict):
    """(kernel call, plain call) on one call's arguments."""
    if name == "fps_blocks":
        c, m, k = args["coords"], args["mask"], args["k"]
        return (lambda: fps.fps_blocks(c, m, k=k),
                lambda: fps.fps_plain(c, m, k))
    if name == "gather_blocks":
        f, i = args["feats"], args["idx"]
        return (lambda: gather.gather_blocks(f, i),
                lambda: gather.gather_plain(f, i))
    q, w, wm, num = args["q"], args["window"], args["wmask"], args["num"]
    if name == "ball_query_blocks":
        cm, r = args["cmask"], args["radius"]
        return (lambda: ball_query.ball_query_blocks(q, cm, w, wm, radius=r,
                                                     num=num),
                lambda: ball_query.ball_query_plain(q, cm, w, wm, radius=r,
                                                    num=num))
    return (lambda: knn.knn_blocks(q, w, wm, k=num),
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


def hold(name: str, args: dict, tol: float = D2_TOL) -> dict:
    """Run the kernel and its plain version on one call's arguments and
    compare them.  Returns {max_abs_err, near_tie_flips, count_rows}."""
    run_kernel, run_plain = runners(name, args)
    got, want = run_kernel(), run_plain()
    if name in ("fps_blocks", "gather_blocks"):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{int((got != want).sum())} entries")
        return {"max_abs_err": 0.0, "near_tie_flips": 0, "count_rows": 0}
    q, w, wm = args["q"], args["window"], args["wmask"]
    flips = check_topk(got[0], got[1], want[0], want[1], q, w, wm, tol=tol)
    fin = (got[1] < INF) & (want[1] < INF)
    err = float((got[1] - want[1]).abs()[fin].max()) if fin.any() else 0.0
    rows = 0
    if name == "ball_query_blocks":
        rows = check_counts(got[2], want[2], q, w, wm,
                            radius=args["radius"], tol=tol)
    return {"max_abs_err": err, "near_tie_flips": flips, "count_rows": rows}
