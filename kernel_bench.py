#!/usr/bin/env python3
"""Time the point kernels on the serving path's own inputs.

    python3 kernel_bench.py attribute [DIR]
    python3 kernel_bench.py compare DIR
    python3 kernel_bench.py rates

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  The inputs are the ``fps_blocks``, ``ball_query_blocks``
and ``knn_blocks`` calls of one 4 x 65,536 serving microbatch, recorded as
``chip_smoke.py`` records them (same clouds, engine configuration and
seed), and the ``fractal_level_blocks`` call that ``chip_smoke.py`` times
on that microbatch's leaf blocks (each split at its valid midpoint, (da,
db) = ``chip_smoke.LEVEL_DIMS_TIMED``).  Times are medians of 20 samples
of ``chip_smoke.median_ms``; bounds are ``kernels.checks.work``'s.

``attribute`` splits each kernel's time (this tree's build, or that of
``DIR``): every block against only the live blocks (a block or window
with a valid lane); for FPS also ``k`` of 1 (the load, the start and the
empty blocks' zeros) against the path's own ``k``, on all blocks and on
live blocks, and the per-step latency (t(k) - t(1)) / (k - 1) on live
blocks; for ball query and kNN ``num``/``k`` of 0 (the window load and
the distance pass), 1 and the path's own value.

``compare DIR`` builds the kernels of ``DIR`` (another commit's
``src/repro_torch/kernels/csrc``) into a library of their own, holds both
builds against the plain versions (exactly), then times them in turns
(DIR's, this tree's, this tree's, DIR's), in two runs, A and B.

``rates`` counts, on the same inputs, how often the register top-k of
``csrc/topk.cuh`` takes a candidate (one thread a row, the valid lanes in
lane order): the share of a row's lane steps at which its list takes one,
and the share of a warp's lane steps at which any of its 32 rows does --
the steps at which the warp runs the insertion.

All print the card's name and power limit first and the ``ptxas``
registers and spills of each build.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import chip_smoke as smoke

NAMES = ("fps_blocks", "ball_query_blocks", "knn_blocks",
         "fractal_level_blocks")
PTXAS = ("fps", "ball_query", "knn", "fractal_level")
# Builds from before FPS had one entry a variant: one entry for every width.
OLD_SIGNATURES = {"fc_fps_blocks": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p]}


def log(msg=""):
    print(msg, flush=True)


def load(path):
    """Load another build, declaring every launcher it has."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    for name, argtypes in {**OLD_SIGNATURES, **_build.SIGNATURES}.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def build(csrc=None):
    """Build (and load) the kernels of ``csrc``, or of this tree; print what
    ptxas reports for the point kernels."""
    from repro_torch.kernels import _build
    if csrc is None:
        lib = _build.library()
    else:
        lib = load(_build.build(Path(csrc).resolve(),
                                smoke.ROOT / "build" / "bench_ext"))
    src = csrc or "this tree"
    for name, text in sorted(_build.build_log.get("ptxas", {}).items()):
        if name.split(".")[0] not in PTXAS:
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {src} {name}: {line.strip()}")
    return lib


def record():
    """The FPS, ball-query and kNN calls of one full microbatch of the
    largest bucket, in the order the forward makes them, then the timed
    partition-level call on that microbatch's leaf blocks."""
    import torch
    from repro_torch.kernels import checks
    engine = smoke.make_engine(None)
    engine.warm()
    b = smoke.BUCKETS[-1]
    with checks.Recorder() as rec:
        rids = [engine.submit(smoke.clustered_cloud(b, 100 + i))
                for i in range(smoke.MICROBATCH)]
        engine.flush()
    for rid in rids:
        engine.take(rid)
    torch.cuda.synchronize()
    level = [(n, a) for n, a in smoke.level_calls()
             if (a["da"], a["db"]) == smoke.LEVEL_DIMS_TIMED]
    return [(n, a) for n, a in rec.calls if n in NAMES] + level


def launch(lib, name, args):
    """One launch of ``name`` from ``lib``, as the wrapper makes it."""
    import torch
    from repro_torch.kernels import _build, fps
    stream = torch.cuda.current_stream().cuda_stream
    if name == "fps_blocks":
        c, m, k = args["coords"], args["mask"], args["k"]
        nb, bs = m.shape
        idx = torch.empty((nb, k), dtype=torch.int32, device=c.device)
        if hasattr(lib, "fc_fps_blocks"):
            err = lib.fc_fps_blocks(c.data_ptr(), m.data_ptr(), idx.data_ptr(),
                                    None, nb, bs, k, stream)
        else:
            err = fps.launch(lib, c, m, idx)
        _build.check(err, name)
        return idx
    if name == "fractal_level_blocks":
        c, m, mid = args["coords"], args["mask"], args["mid"]
        nb, bs = m.shape
        side = torch.empty((nb, bs), dtype=torch.int32, device=c.device)
        lcnt = torch.empty((nb,), dtype=torch.int32, device=c.device)
        stats = torch.empty((nb, 4), dtype=torch.float32, device=c.device)
        err = lib.fc_fractal_level_blocks(
            c.data_ptr(), m.data_ptr(), mid.data_ptr(), side.data_ptr(),
            lcnt.data_ptr(), stats.data_ptr(), nb, bs, args["da"], args["db"],
            stream)
        _build.check(err, name)
        return side, lcnt, stats
    q, w, wm, num = args["q"], args["window"], args["wmask"], args["num"]
    nb, nq = q.shape[:2]
    idx = torch.empty((nb, nq, num), dtype=torch.int32, device=q.device)
    d2 = torch.empty((nb, nq, num), dtype=torch.float32, device=q.device)
    if name == "ball_query_blocks":
        cnt = torch.empty((nb, nq), dtype=torch.int32, device=q.device)
        err = lib.fc_ball_query_blocks(
            q.data_ptr(), args["cmask"].data_ptr(), w.data_ptr(),
            wm.data_ptr(), idx.data_ptr(), d2.data_ptr(), cnt.data_ptr(),
            nb, nq, w.shape[1], num, float(args["radius"]) ** 2, stream)
        out = (idx, d2, cnt)
    else:
        err = lib.fc_knn_blocks(q.data_ptr(), w.data_ptr(), wm.data_ptr(),
                                idx.data_ptr(), d2.data_ptr(), nb, nq,
                                w.shape[1], num, stream)
        out = (idx, d2)
    _build.check(err, name)
    return out


def subset(args, rows):
    """The call's arguments restricted to the blocks ``rows``."""
    return {k: (v.index_select(0, rows).contiguous()
                if hasattr(v, "index_select") else v)
            for k, v in args.items()}


def block_mask(args):
    """The call's (NB, BS) lane mask (the window's for ball query and
    kNN)."""
    return args["mask"] if "mask" in args else args["wmask"]


def attribute(lib, calls):
    from repro_torch.kernels import checks

    def ms(a):
        return smoke.median_ms(lambda: launch(lib, name, a), reps=20)

    for name, args in calls:
        m = block_mask(args)
        live = m.any(1).nonzero().squeeze(1)
        sub = subset(args, live)
        nb = m.shape[0]
        nbytes, ops = checks.work(name, args)
        bms, by = smoke.bound_ms(nbytes, ops)
        checks.hold_result(name, args, launch(lib, name, args),
                           checks.runners(name, args)[1]())
        t_all, t_live = ms(args), ms(sub)
        line = (f"  {name:20s} {smoke.shape_of(name, args):34s} all "
                f"{t_all:.4f} ms, live blocks only ({live.numel()} of {nb}) "
                f"{t_live:.4f} ms")
        if name == "fps_blocks":
            k = args["k"]
            a1, s1 = ms(dict(args, k=1)), ms(dict(sub, k=1))
            line += (f"; k=1: all {a1:.4f} ms, live {s1:.4f} ms; per step "
                     f"on live blocks {(t_live - s1) / (k - 1) * 1e3:.3f} us")
        elif name != "fractal_level_blocks":
            line += "; by num: " + ", ".join(
                f"{n}: {ms(dict(args, num=n)):.4f} ms"
                for n in sorted({0, 1, args["num"]}))
        log(line + f"; bound {bms:.5f} ms ({by})")


def rates(calls):
    import torch
    from repro_torch.kernels.common import INF, sqdist_rows
    for name, args in calls:
        if name not in ("ball_query_blocks", "knn_blocks"):
            continue
        m = args["wmask"]
        live = m.any(1).nonzero().squeeze(1)
        m = m[live]
        d = torch.where(m[:, None, :], sqdist_rows(args["q"][live],
                                                   args["window"][live]), INF)
        order = torch.argsort((~m).to(torch.int8), dim=1, stable=True)
        d = torch.gather(d, 2, order[:, None, :].expand_as(d))  # valid first
        nv = m.sum(1)
        nb, nq, w = d.shape
        cap = 1
        while cap < min(args["num"], 32):
            cap *= 2
        lists = torch.full((nb, nq, cap), INF, device=d.device)
        nwarp = (nq + 31) // 32
        row_takes = warp_takes = row_steps = warp_steps = 0
        for j in range(w):
            x = d[:, :, j]
            valid = (j < nv)[:, None]
            take = (x < lists[..., -1]) & valid
            warps = torch.nn.functional.pad(take, (0, nwarp * 32 - nq))
            row_takes += int(take.sum())
            warp_takes += int(warps.view(nb, nwarp, 32).any(-1).sum())
            row_steps += int(valid.sum()) * nq
            warp_steps += int(valid.sum()) * nwarp
            merged = torch.cat([lists[..., :-1], x[..., None]], -1)
            lists = torch.where(take[..., None], merged.sort(-1).values,
                                lists)
        log(f"  {name:18s} {smoke.shape_of(name, args):34s} list of "
            f"{cap}: a row takes a candidate at {row_takes / row_steps:.3f} "
            f"of its lane steps, a warp of 32 rows at "
            f"{warp_takes / warp_steps:.3f} of its lane steps")


def compare(lib_this, lib_other, calls, run: str):
    import torch
    from repro_torch.kernels import checks
    total = {"this": 0.0, "other": 0.0}
    for name, args in calls:
        want = checks.runners(name, args)[1]()
        for lib in (lib_this, lib_other):
            checks.hold_result(name, args, launch(lib, name, args), want)
        turns = []
        for which in ("other", "this", "this", "other"):
            lib = lib_this if which == "this" else lib_other
            turns.append((which, smoke.median_ms(
                lambda: launch(lib, name, args), reps=20)))
        nbytes, ops = checks.work(name, args)
        bms, by = smoke.bound_ms(nbytes, ops)
        this = [t for w, t in turns if w == "this"]
        other = [t for w, t in turns if w == "other"]
        total["this"] += min(this)
        total["other"] += min(other)
        log(f"  run {run} {name:20s} {smoke.shape_of(name, args):34s} turns "
            + " / ".join(f"{w} {t:.4f}" for w, t in turns)
            + f" ms; bound {bms:.5f} ms ({by}); share of bound, this tree "
            f"{bms / min(this):.3f}, other {bms / min(other):.3f}; "
            f"speed-up {min(other) / min(this):.2f}x")
    torch.cuda.synchronize()
    log(f"  run {run} sums: this tree {total['this']:.4f} ms, other "
        f"{total['other']:.4f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    nargs = {"attribute": (2, 3), "compare": (3,), "rates": (2,)}
    if mode not in nargs or len(sys.argv) not in nargs[mode]:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(smoke.SRC))
    smoke.phase_device()
    lib = build()
    if len(sys.argv) == 3:
        other = build(sys.argv[2])
    calls = record()
    log(f"{len(calls)} recorded calls")
    if mode == "attribute":
        attribute(other if len(sys.argv) == 3 else lib, calls)
    elif mode == "rates":
        rates(calls)
    else:
        for run in ("A", "B"):
            compare(lib, other, calls, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
