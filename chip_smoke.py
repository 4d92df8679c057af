#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It drives the paths of the port -- serving, training, the
global (O(n^2)) point ops and room-scale scene segmentation.  Phases, each
of which raises on failure:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the float32 matmul settings (TF32 off, "highest");
2. build every kernel of ``src/repro_torch/kernels/csrc`` with nvcc; then
   ``repro_torch.analysis``: the port's tree lints clean under --strict,
   the interface matrix is clean on the card (each public op's specs
   chunked and not, card against CPU, and against its plain version), and
   every launch of the matrix and of the paths' largest shapes fits the
   card (whole warps within the function's thread limit, grid within the
   device's, shared memory within the opt-in limit, no spills), read from
   the launchers' own geometry; one line a kernel variant (registers,
   local bytes, shared memory, threads, CTAs an SM); any finding fails;
3. hold each hand-written kernel against its plain PyTorch version on the
   same CUDA tensors, by the rules of ``repro_torch.kernels.checks``: on
   its odd ladder (block sizes 65/200/33, empty blocks, all-invalid masks,
   FPS exhaustion, out-of-range gathers; FPS at every variant's edges,
   1-512 lanes for one warp a block, 513-8192 for one CTA, 8193-20,000
   with a scratch row, with one or two valid lanes, valid lanes only in
   each thread's last slot, k=1 and duplicated lattice points; 1500-lane
   windows; ball query and kNN on scattered masks, 1-15 valid lanes at
   num=16, num/k of 1/3/16/40, windows of 8,192 and 20,000 lanes and
   duplicated lattice points, exactly; FPS, ball query, kNN and gather
   chunked through ``kernels.ops`` with a short last chunk (7 blocks by 3,
   1100 by 512); scatter-adds over 33/128/200-row
   windows with out-of-range, duplicate and chunked rows; partition levels
   under all three (da, db) pairs, split values beyond the extents, lanes
   at the split value, blocks of 32-2048 lanes valid only in each thread's
   last slot, chunked runs) and on the inputs the serving path gives the
   four forward kernels in one microbatch of the largest bucket, with the
   kernel's, the plain version's and the PyTorch library call's median
   times; ``fractal_level_blocks``, on no path, is held and timed on that
   microbatch's stage-0 leaf blocks, each split at its valid midpoint;
4. serve 8 mixed-size segmentation requests through ``ServeEngine`` on the
   card (pointnet2 seg, full widths, th=256, buckets 4096/16384/65536,
   microbatch 4, seeded random weights), with every kernel's launch count
   read around that run; check the logits, and hold the 4096-bucket ones
   against the same engine on the CPU;
5. one 289,000-point cloud (S3DIS scale) through ``pnn.apply``: its time
   and peak device memory;
6. one microbatch per bucket under ``torch.profiler``: device time by
   kernel and the card's idle share;
7. training (``repro_torch.train.pnn``, pointnet2 seg at full widths,
   th=256): the first step's loss and every parameter's gradient on the
   card against the CPU, for one 4096-point cloud and for the 8 x 16384
   batch of the run; then 20 AdamW steps at 8 x 16384 points through
   ``fit``, with every kernel's launch count read around them, the
   losses, the median step time and the peak device memory;
8. the kernels on one training step's own inputs (the gather's backward,
   ``scatter_add_blocks``, on that step's cotangents), held and timed as
   in phase 3, and that step under ``torch.profiler``;
9. the global point ops (``point_ops="global"``, plain tensor ops, no
   plan): one microbatch of 4 x 16384 clouds through a global
   ``ServeEngine`` beside the BPPO engine on the same clouds, and the
   4096-bucket logits held against the same global engine on the CPU;
10. scene segmentation (``repro_torch.scene``) at the configuration of
   examples/segment_scene.py (pointnet2 seg, full widths, th=256,
   tile_points=4096, halo=0.15, microbatch 4): a 16,384-point scene on
   the card against the CPU (same tiling, logits by the serving rule),
   then a 1,000,000-point scene from the port's generator, made on the
   card, with every kernel's launch count read around its inference: each
   point owned by exactly one tile, finite logits, the times to generate,
   tile and infer, and the peak device memory;
11. training with gradient compression: ``fit`` as in phase 7 with the
   int8 and then the bf16 codec (error feedback), each with its launch
   counts, losses and median step beside the uncompressed one;
12. the PNN cells of ``repro_torch.launch.pnn_cell`` (``CELLS``):
   PointNeXt serving at 289k points (the largest batch that fits), a
   PointNeXt fine-tune step at 33k points, PointVector serving at 289k
   points and PointNeXt serving at 1M points (batch 1), each with its
   launch counts over its timed steps, step time, peak memory and
   roofline row, and every kernel call of one of its steps (each leaf
   chunk, the short last one included) held against its plain version on
   that call's own inputs; one step of the first under
   ``torch.profiler``; then PointNeXt and PointVector logits at 4096
   points on the card against the CPU;
13. the first training step's decompressed gradients of each codec, on
   the card against the CPU (one 4096-point cloud), and the codec on the
   card against the CPU on the same gradients, bit for bit.

It then prints a ``{"kernels": [...]}`` line and, last, the device line.
Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BUCKETS = (4096, 16384, 65536)
TH = 256
MICROBATCH = 4
REQUESTS = 8
SEED = 0
N_289K = 289_000
TRAIN_N = 16384          # points a cloud: the middle serving bucket
TRAIN_BATCH = 8
TRAIN_STEPS = 20
PARITY_N = 4096
GLOBAL_BUCKETS = (4096, 16384)
SCENE = dict(tile_points=4096, halo=0.15, th=TH, microbatch=MICROBATCH,
             variant="pointnet2")        # examples/segment_scene.py
SCENE_SMALL_N = 16_384
SCENE_N = 1_000_000
# The PNN cells of launch/pnn_cell.py: (variant, shape, kind, batch); no
# batch takes the largest that fits on the card.
CELLS = (("pointnext", "pnn_289k", "serve", None),
         ("pointnext", "pnn_33k", "train", None),
         ("pointvector", "pnn_289k", "serve", 1),
         ("pointnext", "pnn_1m", "serve", 1))
CELL_PARITY_N = 4096
SLEEP_CYCLES_PER_S = 2.0e9   # at or above the H100's SM clock (1.98 GHz)
LOGIT_TOL = 1e-3      # card vs CPU: float32 matmuls sum in another order
LOGIT_SHARE = 0.999   # share of points within LOGIT_TOL

REPLACES = {
    "fps_blocks": "src/repro/kernels/fps.py:62",
    "ball_query_blocks": "src/repro/kernels/ball_query.py:43",
    "knn_blocks": "src/repro/kernels/knn.py:31",
    "gather_blocks": "src/repro/kernels/gather.py:30",
    "scatter_add_blocks": "src/repro/kernels/gather.py:65",
    "fractal_level_blocks": "src/repro/kernels/fractal_engine.py:47",
}
SERVING = ("fps_blocks", "ball_query_blocks", "knn_blocks", "gather_blocks")
TRAINING = SERVING + ("scatter_add_blocks",)
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name.rsplit('_', 1)[0]}.cu"
           for name in REPLACES}
LEVEL_DIMS_TIMED = (0, 1)   # the (da, db) pair whose leaf-block call is timed


def log(msg=""):
    print(msg, flush=True)


def clustered_cloud(n: int, seed: int) -> np.ndarray:
    """Two objects and clutter, as in examples/quickstart.py, scaled to n."""
    rng = np.random.default_rng(seed)
    a, b = int(0.49 * n), int(0.37 * n)
    return np.concatenate([
        rng.normal([0, 0, 0], 0.3, (a, 3)),
        rng.normal([3, 1, 0], 0.5, (b, 3)),
        rng.uniform(-1, 4, (n - a - b, 3)),
    ]).astype(np.float32)


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------

def median_ms(fn, reps: int, warmup: int = 2, batch: int = 10) -> float:
    """The card's time for one call of ``fn``: the median over ``reps``
    samples of ``batch`` calls between two CUDA events, divided by
    ``batch``.  Each sample is queued behind ``torch.cuda._sleep``, long
    enough to keep the card busy while the host enqueues the batch, so the
    card runs the calls back to back: a short kernel is timed by the card,
    not by the host's cost of one launch (a wrapper call takes tens of
    microseconds of host time).  With ``batch=1`` a call that enqueues many
    operations (a plain version) is timed with its host time."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / max(warmup, 1)
    sleep = (int(min(max(4 * host_s * batch, 2e-4), 0.5) * SLEEP_CYCLES_PER_S)
             if batch > 1 else 0)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if sleep:
            torch.cuda._sleep(sleep)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for ``nbytes`` and ``ops`` at the H100's published
    HBM and float32 rates (``repro_torch.launch.roofline``); comparisons
    and selects count as float32 operations."""
    from repro_torch.launch import roofline
    t_bytes = nbytes / roofline.HBM_BW * 1e3
    t_ops = ops / roofline.PEAK_FLOPS_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Kernel against plain.
# ---------------------------------------------------------------------------

def library_calls(name, args) -> dict:
    """PyTorch calls that compute the same function on these inputs, where
    there are: a gather whose indices all lie in the window is
    ``torch.gather`` (with the index widened to (NB, M, C)) or advanced
    indexing (with the (NB, M) index); a scatter-add is ``scatter_add_``
    along dim 1 into a zeroed (NB, W+1, C) buffer (index widened to
    (NB, M, C), out-of-range rows sent to the sink row W) or
    ``index_add_`` into its flattened (NB*(W+1), C) view.  Each is timed;
    the fastest is reported.  The indices are prepared outside the timed
    call; the zeroed buffer is part of it, as the kernel writes its zeros
    too."""
    import torch
    if name == "scatter_add_blocks":
        g, idx, w = args["g"], args["idx"], args["w"]
        nb, m, c = g.shape
        slot = torch.where((idx >= 0) & (idx < w), idx.long(), w)
        wide = slot[..., None].expand(nb, m, c).contiguous()
        flat = (slot + torch.arange(nb, device=g.device)[:, None] * (w + 1)
                ).reshape(-1)
        g2 = g.reshape(nb * m, c)
        return {
            "scatter_add_": lambda: g.new_zeros((nb, w + 1, c)).scatter_add_(
                1, wide, g),
            "index_add_": lambda: g.new_zeros((nb * (w + 1), c)).index_add_(
                0, flat, g2)}
    if name != "gather_blocks":
        return {}
    f, idx = args["feats"], args["idx"]
    if bool(((idx < 0) | (idx >= f.shape[1])).any()):
        return {}
    wide = idx.long()[..., None].expand(*idx.shape, f.shape[2]).contiguous()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {"torch.gather": lambda: torch.gather(f, 1, wide),
            "indexing": lambda: f[rows, idx]}


def shape_of(name, args):
    if name == "fps_blocks":
        nb, bs = args["mask"].shape
        return f"NB={nb} BS={bs} k={args['k']}"
    if name == "gather_blocks":
        nb, w, c = args["feats"].shape
        return f"NB={nb} W={w} C={c} M={args['idx'].shape[1]}"
    if name == "scatter_add_blocks":
        nb, m, c = args["g"].shape
        return f"NB={nb} W={args['w']} C={c} M={m}"
    if name == "fractal_level_blocks":
        nb, bs = args["mask"].shape
        return f"NB={nb} BS={bs} da={args['da']} db={args['db']}"
    nb, nq = args["q"].shape[:2]
    return f"NB={nb} Q={nq} W={args['window'].shape[1]} k={args['num']}"


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.library()
    log(f"built {Path(_build.build_log['path']).name} in "
        f"{time.monotonic() - t0:.1f} s (reused an earlier build: "
        f"{_build.build_log['reused']})")
    for src, text in sorted(_build.build_log.get("ptxas", {}).items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")


def phase_analysis(smi: str):
    """The contract linter and the interface checks of
    ``repro_torch.analysis`` on the card; raises on any finding, or if a
    kernel variant of the library was reached by no checked launch."""
    from repro_torch.analysis import abstract, report, walker
    t0 = time.monotonic()
    findings = walker.lint_tree()
    findings += abstract.run_matrix_checks(device="cuda")
    launch_findings, rows = abstract.run_launch_checks()
    findings += launch_findings
    log(f"analysis ({smi}): lint + {len(abstract.MATRIX)}-row interface "
        f"matrix on cpu and cuda + {sum(r['launches'] for r in rows.values())}"
        f" launch geometries in {time.monotonic() - t0:.1f} s")
    for name in abstract.all_variants():
        if name not in rows:
            continue
        r = rows[name]
        log(f"  {name:26s} {r['source']:17s} {r['num_regs']:3d} registers, "
            f"{r['local_bytes']} local bytes, {r['static_smem']} static + "
            f"<= {r['max_smem']} dynamic shared bytes, threads "
            f"{sorted(r['threads'])}, >= {r['min_ctas_per_sm']} CTAs/SM, "
            f"{r['launches']} launches checked")
    missing = sorted(set(abstract.all_variants()) - set(rows))
    if missing:
        raise AssertionError(f"analysis: no checked launch reached {missing}")
    for f in report.sort_findings(findings):
        log(f"  {f.format()}")
    if findings:
        raise AssertionError(f"analysis: {report.summarize(findings)}")


def phase_ladder(device):
    from repro_torch.kernels import checks
    rows = 0
    calls = checks.ladder(device)
    for name, args in calls:
        rows += checks.hold(name, args)["count_rows"]
    log(f"ladder: {len(calls)} kernel calls match their plain versions "
        f"(ball query and kNN exactly; {rows} ball-query count rows off by "
        f"their boundary lanes)")


def make_engine(device, params=None):
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=BUCKETS, microbatch=MICROBATCH, variant="pointnet2",
                      task="seg", num_classes=6, th=TH)
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def hold_and_time(calls) -> dict:
    """Hold and time every recorded kernel call; returns {kernel name:
    sums over its calls of ms, plain_ms, bytes, ops, library_ms, and the
    largest error}."""
    import torch
    from repro_torch.kernels import checks
    rows = {}
    for name, args in calls:
        res = checks.hold(name, args)
        run_kernel, run_plain = checks.runners(name, args)
        ms = median_ms(run_kernel, reps=20)
        plain_ms = median_ms(run_plain, reps=5, warmup=1, batch=1)
        libs = {label: median_ms(fn, reps=20)
                for label, fn in library_calls(name, args).items()}
        lib_ms = min(libs.values()) if libs else None
        nbytes, ops = checks.work(name, args)
        bms, by = bound_ms(nbytes, ops)
        log(f"  {name:18s} {shape_of(name, args):38s} kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bms:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)  library "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in libs.items()) or "-")
            + f"  max|err| {res['max_abs_err']:.3g}  count rows "
            f"{res['count_rows']}")
        row = rows.setdefault(name, dict(ms=0.0, plain_ms=0.0, bytes=0.0,
                                         ops=0.0, library_ms=0.0, err=0.0,
                                         calls=0))
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bytes"] += nbytes
        row["ops"] += ops
        row["library_ms"] = (None if lib_ms is None or row["library_ms"] is None
                             else row["library_ms"] + lib_ms)
        row["err"] = max(row["err"], res["max_abs_err"])
        row["calls"] += 1
    torch.cuda.synchronize()
    return rows


def phase_main_path_kernels(engine):
    """Record the kernel inputs of one full microbatch of the largest
    bucket, served through the engine, then hold and time every kernel
    call on them."""
    from repro_torch.kernels import checks
    b = BUCKETS[-1]
    with checks.Recorder() as rec:
        rids = [engine.submit(clustered_cloud(b, 100 + i))
                for i in range(MICROBATCH)]
        engine.flush()
    for rid in rids:
        engine.take(rid)
    rows = hold_and_time(rec.calls)
    missing = set(SERVING) - set(rows)
    if missing:
        raise AssertionError(f"main path made no call to {sorted(missing)}")
    return rows


def phase_serve(engine):
    """The main path: 8 mixed-size requests through the engine, with the
    kernel launch counts read around the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import mixed_request_sizes
    sizes = mixed_request_sizes(BUCKETS, REQUESTS, seed=SEED)
    clouds = [clustered_cloud(n, SEED + i) for i, n in enumerate(sizes)]
    ops.reset_launch_counts()
    t0 = time.monotonic()
    rids = [engine.submit(c) for c in clouds]
    engine.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    log(f"served {len(rids)} requests of sizes {sizes} in {wall:.3f} s")
    log(f"launches during serving: {launches}")
    idle = [k for k in SERVING if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    results = {}
    for i, (rid, c) in enumerate(zip(rids, clouds)):
        out = engine.take(rid)
        if out is None or out.shape != (len(c), 6):
            raise AssertionError(f"request {rid}: bad result shape "
                                 f"{None if out is None else out.shape}")
        if not np.isfinite(out).all():
            raise AssertionError(f"request {rid}: non-finite logits")
        results[i] = out
    buckets = sorted({engine.policy.select(len(c)) for c in clouds})
    if tuple(buckets) != BUCKETS:
        raise AssertionError(f"stream touched buckets {buckets} only")
    st = engine.stats()
    st["plan_cache"]["traces"] = {
        "/".join(map(str, k)): v for k, v in st["plan_cache"]["traces"].items()}
    log("stats: " + json.dumps(st))
    return clouds, results, launches


def hold_logits(pairs, title: str) -> None:
    """Card logits against CPU logits, (got, want) per cloud: |difference|
    <= LOGIT_TOL on >= LOGIT_SHARE of the points, or raise."""
    total = over = 0
    worst = 0.0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"{title}: shapes {got.shape} vs "
                                 f"{want.shape}")
        diff = np.abs(got - want).max(-1)
        total += len(diff)
        over += int((diff > LOGIT_TOL).sum())
        worst = max(worst, float(diff.max()))
    share = 1.0 - over / total
    log(f"{title}, card vs CPU: {len(pairs)} clouds, {total} points, "
        f"{over} over {LOGIT_TOL} (share within {share:.6f}), max |d| "
        f"{worst:.3g}")
    if share < LOGIT_SHARE:
        raise AssertionError(f"{title}: card and CPU logits disagree")


def serve_on_cpu(cpu, clouds) -> list:
    rids = [cpu.submit(c) for c in clouds]
    cpu.flush()
    return [cpu.take(rid) for rid in rids]


def phase_cpu_reference(engine, clouds, results):
    """The 4096-bucket requests again on the CPU (plain versions, same
    weights), held by ``hold_logits``."""
    import copy
    small = [i for i, c in enumerate(clouds) if len(c) <= BUCKETS[0]]
    cpu = make_engine("cpu", params=copy.deepcopy(engine.params).cpu())
    wants = serve_on_cpu(cpu, [clouds[i] for i in small])
    hold_logits([(results[i], w) for i, w in zip(small, wants)],
                "4096 bucket")


def phase_289k(engine):
    import torch
    from repro_torch.models import pnn
    cfg = pnn.pointnet2_seg(n=N_289K, point_ops="bppo", th=TH)
    pts = torch.from_numpy(clustered_cloud(N_289K, 289))[None].cuda()
    with torch.inference_mode():
        pnn.apply(engine.params, cfg, pts).cpu()           # first use
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = pnn.apply(engine.params, cfg, pts)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
    out = out.cpu().numpy()
    if out.shape != (1, N_289K, 6) or not np.isfinite(out).all():
        raise AssertionError(f"289k forward: bad output {out.shape}")
    log(f"289k cloud: pnn.apply {dt * 1e3:.1f} ms, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def level_calls() -> list:
    """[("fractal_level_blocks", arguments)] on the main path's own blocks,
    one call for every (da, db) pair: the stage-0 leaf blocks of one
    microbatch of the largest bucket (the clouds of
    ``phase_main_path_kernels``), each split at its valid midpoint on
    ``da``."""
    import torch
    from repro_torch.core import fractal
    from repro_torch.kernels import checks
    clouds = torch.from_numpy(np.stack(
        [clustered_cloud(BUCKETS[-1], 100 + i)
         for i in range(MICROBATCH)])).cuda()
    part = fractal.partition(clouds, th=TH, on_overflow="silent")
    view, mask, _ = fractal.leaf_view(part, part.coords, TH)
    return [("fractal_level_blocks", checks.level_at_midpoints(view, mask, da,
                                                              db))
            for da, db in checks.LEVEL_DIMS]


def phase_level_kernel() -> dict:
    """``fractal_level_blocks`` (on no path) on the main path's own blocks
    (``level_calls``): held for every (da, db) pair, timed for one."""
    from repro_torch.kernels import checks
    calls = level_calls()
    for name, args in calls:
        checks.hold(name, args)
    log(f"fractal_level_blocks on {MICROBATCH}x{BUCKETS[-1]} leaf blocks "
        f"({int(calls[0][1]['mask'].sum())} valid lanes): all three (da, db) "
        f"pairs equal their plain versions")
    return hold_and_time([(n, a) for n, a in calls
                          if (a["da"], a["db"]) == LEVEL_DIMS_TIMED])


def phase_profile(engine):
    """Where the time goes: one full microbatch per bucket under
    torch.profiler; device time by kernel, kernel launches, and the card's
    busy share of the wall time (profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for b in BUCKETS:
        clouds = [clustered_cloud(b, 500 + i) for i in range(MICROBATCH)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            rids = [engine.submit(c) for c in clouds]
            engine.flush()
            wall_us = (time.monotonic() - t0) * 1e6
        for rid in rids:
            engine.take(rid)
        report_profile(prof, wall_us,
                       f"profile bucket {b} (microbatch {MICROBATCH})")


def report_profile(prof, wall_us: float, title: str, top: int = 8):
    """Device time by kernel, device ops, the ported kernels' share and the
    card's idle share of ``wall_us``, from one ``torch.profiler`` run."""
    # The kernels of csrc/ live in an anonymous namespace.
    ported = tuple(f"(anonymous namespace)::{k}_kernel"
                   for k in ("fps_warp", "fps", "fps_wide", "ball_query",
                             "knn", "gather", "scatter_add", "fractal_level"))
    dev = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.device_type.name == "CUDA":
            dev.append((us, e.count, e.key))
    dev.sort(reverse=True)
    busy = sum(us for us, _, _ in dev)
    launches = sum(c for _, c, _ in dev)
    mine = sum(us for us, _, k in dev if any(p in k for p in ported))
    if busy <= 0:
        raise AssertionError(f"{title}: the profiler saw no device time")
    log(f"{title}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (idle share {1 - busy / wall_us:.3f}), "
        f"{launches} device ops, ported kernels {mine / 1e3:.2f} ms")
    for us, count, key in dev[:top]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# The global point ops and scene segmentation.
# ---------------------------------------------------------------------------

def global_engine(device, params):
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=GLOBAL_BUCKETS, microbatch=MICROBATCH,
                      variant="pointnet2", task="seg", num_classes=6, th=TH,
                      point_ops="global")
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def serve_timed(engine, clouds) -> tuple[list, float]:
    """One microbatch through ``engine``: (logits per cloud, wall s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rids = [engine.submit(c) for c in clouds]
    engine.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return [engine.take(rid) for rid in rids], wall


def phase_global(engine):
    """The global (O(n^2)) point ops through a plan-less ``ServeEngine``:
    one microbatch of 4 x 16384 clouds beside the BPPO engine on the same
    clouds (turns: bppo, global, global, bppo), with every kernel's launch
    count read around a global run; then the 4096-bucket logits held
    against the same engine on the CPU."""
    import copy
    from repro_torch.kernels import ops
    geng = global_engine(None, engine.params)
    log(f"global warm: {geng.warm()}")
    b = GLOBAL_BUCKETS[-1]
    clouds = [clustered_cloud(b, 700 + i) for i in range(MICROBATCH)]
    walls = {"bppo": [], "global": []}
    for kind in ("bppo", "global", "global", "bppo"):
        ops.reset_launch_counts()
        outs, wall = serve_timed(engine if kind == "bppo" else geng, clouds)
        walls[kind].append(wall)
        if kind == "global":
            launches, gouts = ops.launch_counts(), outs
        else:
            bouts = outs
    for o in gouts:
        if o.shape != (b, 6) or not np.isfinite(o).all():
            raise AssertionError(f"global serving: bad logits {o.shape}")
    agree = np.mean([(g.argmax(-1) == p.argmax(-1)).mean()
                     for g, p in zip(gouts, bouts)])
    log(f"{MICROBATCH}x{b} microbatch: global "
        + " / ".join(f"{w * 1e3:.1f}" for w in walls["global"])
        + " ms, bppo " + " / ".join(f"{w * 1e3:.1f}" for w in walls["bppo"])
        + f" ms; argmax agreement global vs bppo {agree:.4f} (random "
        f"weights); launches during a global microbatch: {launches}")
    b0 = GLOBAL_BUCKETS[0]
    small = [clustered_cloud(n, 800 + i)
             for i, n in enumerate((b0, 3 * b0 // 4, b0, b0 // 2))]
    got, _ = serve_timed(geng, small)
    t0 = time.monotonic()
    want = serve_on_cpu(global_engine(
        "cpu", copy.deepcopy(engine.params).cpu()), small)
    log(f"global {b0} bucket on the CPU: {time.monotonic() - t0:.1f} s")
    hold_logits(list(zip(got, want)), f"global {b0} bucket")


def scene_engine(device, params):
    from repro_torch.scene import SceneConfig, SceneEngine
    return SceneEngine(SceneConfig(**SCENE), params=params, seed=SEED,
                       device=device)


def phase_scene_small(eng):
    """A 16,384-point scene on the card and on the CPU (plain versions,
    same weights): the same tiling, logits by ``hold_logits``."""
    import copy
    from repro_torch.data import synthetic
    pts, _ = synthetic.scene(SEED, SCENE_SMALL_N, device="cuda")
    got, plan = eng.infer(pts)
    t0 = time.monotonic()
    want, cplan = scene_engine("cpu", copy.deepcopy(eng.params).cpu()).infer(
        pts.cpu())
    cpu_s = time.monotonic() - t0
    same = plan.num_tiles == cplan.num_tiles and all(
        np.array_equal(a.owned, b.owned) and np.array_equal(a.halo, b.halo)
        for a, b in zip(plan.tiles, cplan.tiles))
    log(f"scene {SCENE_SMALL_N}: {plan.num_tiles} tiles, "
        f"{plan.halo_points} halo points, tiling card == CPU: {same}; CPU "
        f"took {cpu_s:.1f} s")
    if not same:
        raise AssertionError("the card and the CPU tile the scene apart")
    hold_logits([(got, want)], f"scene {SCENE_SMALL_N}")


def phase_scene_1m(eng) -> dict:
    """The slice's main path: a 1,000,000-point scene generated on the
    card, tiled, and segmented through ``SceneEngine.infer``, with every
    kernel's launch count read around the inference."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pts, labels = synthetic.scene(SEED, SCENE_N, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    t0 = time.monotonic()
    plan = eng.plan(pts)
    tile_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    logits, _ = eng.infer(pts, plan=plan)
    torch.cuda.synchronize()
    infer_s = time.monotonic() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    owned = np.bincount(np.concatenate([t.owned for t in plan.tiles]),
                        minlength=SCENE_N)
    if owned.shape != (SCENE_N,) or not (owned == 1).all():
        raise AssertionError(f"1M scene: {int((owned != 1).sum())} points "
                             f"not owned exactly once")
    if logits.shape != (SCENE_N, 6) or not np.isfinite(logits).all():
        raise AssertionError(f"1M scene: bad logits {logits.shape}")
    sizes = [t.n for t in plan.tiles]
    st = eng.stats()
    log(f"scene {SCENE_N}: {plan.num_tiles} tiles (owned points per tile "
        f"{min(t.n_owned for t in plan.tiles)}-"
        f"{max(t.n_owned for t in plan.tiles)}), {plan.halo_points} halo "
        f"points, largest tile cloud {plan.max_tile_n}, mean "
        f"{np.mean(sizes):.0f}; {len(np.unique(labels.cpu().numpy()))} "
        f"shape classes")
    log(f"scene {SCENE_N}: generate {gen_s:.3f} s, tile {tile_s:.3f} s, "
        f"infer {infer_s:.3f} s ({SCENE_N / infer_s:,.0f} points/s; "
        f"{SCENE_N / (tile_s + infer_s):,.0f} points/s with tiling), peak "
        f"device memory during inference {peak:.2f} GiB; tile latency p50 "
        + " / ".join(f"{b}: {v['p50_ms']:.1f} ms x{v['count']}"
                     for b, v in st["buckets"].items()))
    log(f"launches during the 1M scene: {launches}")
    idle = [k for k in SERVING if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the scene path: "
                             f"{idle}")
    return launches


def phase_scene(params) -> dict:
    eng = scene_engine(None, params)
    log(f"scene warm: {eng.warm()}")
    phase_scene_small(eng)
    return phase_scene_1m(eng)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def train_cfg(n: int, batch: int):
    from repro_torch.train import pnn as train
    return train.TrainConfig(preset="pointnet2_seg", n_points=n, th=TH,
                             batch=batch, steps=TRAIN_STEPS, seed=SEED)


def first_batch(cfg, device):
    """The batch ``fit`` trains on at step 0."""
    from repro_torch.data import synthetic
    pts, labels = synthetic.segmentation_batch(cfg.seed + 11, 0, cfg.batch,
                                               cfg.n_points, device=device)
    return {"points": pts, "labels": labels}


def phase_grad_parity(n: int, batch: int):
    """The first training step's loss and every parameter's gradient on
    the card against the CPU (plain versions), from the weights and the
    batch ``fit`` starts from, by ``checks.hold_grads``."""
    import copy
    import torch
    from repro_torch.kernels import checks, ops
    from repro_torch.models import pnn
    from repro_torch.train import pnn as train
    cfg = train_cfg(n, batch)
    mcfg = train.model_config(cfg)
    model = pnn.init(mcfg, torch.Generator().manual_seed(cfg.seed))
    t0 = time.monotonic()
    want, wm = train.grads_fn(model, mcfg)(train.param_dict(model),
                                           first_batch(cfg, "cpu"))
    cpu_s = time.monotonic() - t0
    card = copy.deepcopy(model).cuda()
    before = ops.launch_counts()["scatter_add_blocks"]
    got, gm = train.grads_fn(card, mcfg)(train.param_dict(card),
                                         first_batch(cfg, "cuda"))
    torch.cuda.synchronize()
    backward = ops.launch_counts()["scatter_add_blocks"] - before
    rel = checks.hold_grads(got, want)
    worst = max(rel, key=rel.get)
    log(f"gradients {batch}x{n}, card vs CPU: loss {float(gm['loss']):.7f} "
        f"vs {float(wm['loss']):.7f}; all {len(got)} parameters non-zero "
        f"on the card; largest relative L2 difference {rel[worst]:.3g} "
        f"({worst}; rule <= {checks.GRAD_REL_TOL}); scatter_add_blocks "
        f"launched {backward} times by the backward; CPU took {cpu_s:.1f} s")
    if backward == 0:
        raise AssertionError("the card's backward did not launch "
                             "scatter_add_blocks")


def phase_train():
    """The training path: ``fit`` for TRAIN_STEPS AdamW steps at
    TRAIN_BATCH x TRAIN_N points on the card, with every kernel's launch
    count read around the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import pnn as train
    cfg = train_cfg(TRAIN_N, TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    model, state, info = train.fit(cfg, log=log)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    losses = [h["loss"] for h in info["history"]]
    dts = [h["dt"] * 1e3 for h in info["history"]]
    log(f"trained {len(losses)} steps of {cfg.batch}x{cfg.n_points} points "
        f"in {wall:.2f} s: median step {statistics.median(dts):.1f} ms "
        f"(first {dts[0]:.1f} ms), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("losses: " + " ".join(f"{x:.4f}" for x in losses))
    log("step ms: " + " ".join(f"{x:.1f}" for x in dts))
    log(f"launches during training: {launches}")
    hold_losses(losses, "training")
    idle = [k for k in TRAINING if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched in training: {idle}")
    return cfg, model, state, launches, statistics.median(dts)


def hold_losses(losses, title: str) -> None:
    """TRAIN_STEPS finite losses whose last 5 average below their first 5,
    or raise."""
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{title}: bad losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"{title}: mean loss, first 5 steps {first:.4f}, last 5 steps "
        f"{last:.4f}")
    if not last < first:
        raise AssertionError(f"{title}: the loss did not fall")


def phase_train_kernels(cfg, model):
    """Record the kernel calls of one training step's forward and backward
    at full size, check that every parameter gets a gradient, and hold and
    time the gather's backward on that step's own cotangents."""
    from repro_torch.kernels import checks
    from repro_torch.train import pnn as train
    mcfg = train.model_config(cfg)
    with checks.Recorder() as rec:
        grads, _ = train.grads_fn(model, mcfg)(train.param_dict(model),
                                               first_batch(cfg, "cuda"))
    silent = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    if silent:
        raise AssertionError(f"parameters without gradient: {silent}")
    calls = [(n, a) for n, a in rec.calls if n == "scatter_add_blocks"]
    rec.calls.clear()
    if not calls:
        raise AssertionError("the training step made no scatter-add call")
    return hold_and_time(calls)


def phase_profile_train(cfg, model, state):
    """One more training step (forward, backward, AdamW) under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import pnn as train
    mcfg = train.model_config(cfg)
    step = train.make_train_step(model, mcfg, opt_lib.OptConfig(
        lr=cfg.lr, warmup=0, total_steps=cfg.steps,
        weight_decay=cfg.weight_decay))
    batch = first_batch(cfg, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, _, metrics = step(train.param_dict(model), state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    report_profile(prof, wall_us, f"profile training step "
                   f"({cfg.batch}x{cfg.n_points})", top=12)


def phase_train_compressed(plain_ms: float) -> dict:
    """``fit`` with each gradient codec (error feedback, keyed by (seed,
    step)) for TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_N points, with
    every kernel's launch count read around each run; the median step
    beside the uncompressed run's.  Returns {codec: its run's launches}."""
    import dataclasses
    import torch
    from repro_torch.dist import compression
    from repro_torch.kernels import ops
    from repro_torch.train import pnn as train
    total = {}
    for method in compression.METHODS[::-1]:          # int8, then bf16
        cfg = dataclasses.replace(train_cfg(TRAIN_N, TRAIN_BATCH),
                                  grad_compression=method)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        _, _, info = train.fit(cfg, log=log)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        losses = [h["loss"] for h in info["history"]]
        dts = [h["dt"] * 1e3 for h in info["history"]]
        log(f"trained {len(losses)} steps of {cfg.batch}x{cfg.n_points} "
            f"points with {method} compression: median step "
            f"{statistics.median(dts):.1f} ms against {plain_ms:.1f} ms "
            f"uncompressed (first {dts[0]:.1f} ms), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"{method} losses: " + " ".join(f"{x:.4f}" for x in losses))
        log(f"{method} step ms: " + " ".join(f"{x:.1f}" for x in dts))
        log(f"launches during {method} training: {launches}")
        hold_losses(losses, f"{method} training")
        idle = [k for k in TRAINING if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched in {method} "
                                 f"training: {idle}")
        total[method] = launches
    return total


def phase_compressed_grads(n: int, batch: int):
    """The first training step's decompressed gradients (error feedback
    from a zero residual, key (seed, 0), as ``fit`` runs it) on the card
    against the CPU, from the same weights and batch, by
    ``checks.hold_grads``, for each codec; and the codec itself on the
    card against the CPU on the card's raw gradients, bit for bit."""
    import copy
    import torch
    from repro_torch.dist import compression
    from repro_torch.kernels import checks
    from repro_torch.models import pnn
    from repro_torch.train import pnn as train
    cfg = train_cfg(n, batch)
    mcfg = train.model_config(cfg)
    model = pnn.init(mcfg, torch.Generator().manual_seed(cfg.seed))
    want, _ = train.grads_fn(model, mcfg)(train.param_dict(model),
                                          first_batch(cfg, "cpu"))
    card = copy.deepcopy(model).cuda()
    got, _ = train.grads_fn(card, mcfg)(train.param_dict(card),
                                        first_batch(cfg, "cuda"))
    got_cpu = {k: g.cpu() for k, g in got.items()}
    key = (cfg.seed, 0)
    for method in compression.METHODS:
        def ef(grads):
            return compression.apply_error_feedback(
                grads, compression.init_residual(grads), method, key)
        (dg, rg), (dw, _), (dx, rx) = ef(got), ef(want), ef(got_cpu)
        same = all(torch.equal(dg[k].cpu(), dx[k])
                   and torch.equal(rg[k].cpu(), rx[k]) for k in dg)
        log(f"{method} codec on the card's gradients, card vs CPU: "
            f"{'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{method}: the codec on the card differs "
                                 f"from the CPU's on the same gradients")
        rel = checks.hold_grads(dg, dw)
        worst = max(rel, key=rel.get)
        log(f"{method} decompressed gradients {batch}x{n}, card vs CPU: all "
            f"{len(dg)} parameters non-zero on the card; largest relative "
            f"L2 difference {rel[worst]:.3g} ({worst}; rule <= "
            f"{checks.GRAD_REL_TOL})")


def phase_cells() -> tuple[dict, int]:
    """The paper's PNN cells through ``launch.pnn_cell.run_pnn_cell`` (a
    batch cut to what fits where none is given): each cell's row, every
    kernel call of one step held against its plain version (the cell
    raises on a difference), the launches of its timed steps, and the
    roofline table.  Returns ({cell: its timed steps' launches}, the
    first cell's batch)."""
    import torch
    from repro_torch.launch import pnn_cell, roofline
    rows, total = [], {}
    for variant, shape, kind, batch in CELLS:
        torch.cuda.empty_cache()
        d = pnn_cell.run_pnn_cell(variant, shape, batch=batch, kind=kind)
        launches = d["launches"]
        cut = (f"batch {d['batch']} of the reference's {d['ref_batch']}"
               + (f" (probe at batch 1: {d['probe']['probe_base_gib']:.2f} "
                  f"GiB before the step, {d['probe']['probe_step_gib']:.2f} "
                  f"GiB a cloud; estimate {d['probe']['estimate_gib']:.2f} "
                  f"GiB)" if d["probe"] else " (given)"))
        log(f"cell {variant} x {d['shape']}: {cut}; step "
            f"{d['step_s'] * 1e3:.2f} ms (median of {len(d['steps_s'])}: "
            + " / ".join(f"{t * 1e3:.2f}" for t in d["steps_s"])
            + f"), warm {d['warm_s']:.2f} s, peak "
            f"{d['mem_per_device']['peak_mb'] / 1024:.2f} GiB; counted "
            f"{d['hlo_flops_per_chip']:.4g} flop, {d['hlo_bytes_per_chip']:.4g}"
            f" B: t_compute {d['t_compute_s'] * 1e3:.3f} ms, t_memory "
            f"{d['t_memory_s'] * 1e3:.3f} ms ({d['bottleneck']}, "
            f"{d['bound_fraction'] * 100:.2f}% of the step), useful flops "
            f"{d['model_flops']:.4g} ({d['usefulness'] * 100:.1f}%); kernel "
            f"calls a step {d['kernel_calls']}; launches over the timed steps "
            f"{launches}; cell {d['total_s']:.1f} s")
        for name, h in d["held"].items():
            b = h["blocks"]
            log(f"  held {name}: {len(b)} calls of one step match their "
                f"plain versions (max|err| {h['max_abs_err']:.3g}, count "
                f"rows {h['count_rows']}); blocks a call: first {b[0]}, "
                f"last {b[-1]}, sizes {sorted(set(b))}")
        need = TRAINING if kind == "train" else SERVING
        idle = [k for k in need if launches[k] == 0 or k not in d["held"]]
        if idle:
            raise AssertionError(f"cell {variant} x {shape}: kernels not "
                                 f"launched or not held: {idle}")
        total[f"{variant} x {d['shape']}"] = launches
        rows.append(d)
    log(roofline.format_table(rows))
    return total, rows[0]["batch"]


def phase_profile_cell(batch: int):
    """One step of the first cell (PointNeXt serving at 289k points, at
    the batch ``phase_cells`` ran) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import pnn_cell
    variant, shape, kind, _ = CELLS[0]
    cell = pnn_cell.make_cell(variant, shape, batch=batch, kind=kind)
    cell.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        cell.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    report_profile(prof, wall_us, f"profile cell {variant} x {shape} "
                   f"({kind}, batch {batch})", top=12)


def phase_cell_parity():
    """PointNeXt and PointVector logits on the card against the CPU (plain
    versions, same weights and clouds) at CELL_PARITY_N points, by
    ``hold_logits``."""
    import copy
    from repro_torch.launch import pnn_cell
    shape = pnn_cell.PNNShape("parity", CELL_PARITY_N, 2, TH)
    for variant in ("pointnext", "pointvector"):
        cell = pnn_cell.make_cell(variant, shape, device="cuda")
        got = cell.step().cpu().numpy()
        cpu = pnn_cell.make_cell(variant, shape, device="cpu",
                                 params=copy.deepcopy(cell.model).cpu())
        want = cpu.step().numpy()
        hold_logits(list(zip(got, want)), f"{variant} {CELL_PARITY_N}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()
    phase_analysis(smi)
    phase_ladder("cuda")
    engine = make_engine(None)
    log(f"warm: {engine.warm()}")
    # Kernel inputs come from an engine of its own (same weights), so the
    # serving engine's latency and throughput cover the served stream only.
    rows = phase_main_path_kernels(make_engine(None, params=engine.params))
    clouds, results, launches = phase_serve(engine)
    phase_cpu_reference(engine, clouds, results)
    phase_289k(engine)
    phase_profile(engine)
    rows.update(phase_level_kernel())
    phase_global(engine)
    scene_launches = phase_scene(engine.params)
    del engine
    phase_grad_parity(PARITY_N, 1)
    phase_grad_parity(TRAIN_N, TRAIN_BATCH)
    cfg, model, state, train_launches, plain_ms = phase_train()
    rows.update(phase_train_kernels(cfg, model))
    launches["scatter_add_blocks"] = train_launches["scatter_add_blocks"]
    phase_profile_train(cfg, model, state)
    del model, state
    compressed = phase_train_compressed(plain_ms)
    cells, cell_batch = phase_cells()
    phase_profile_cell(cell_batch)
    phase_cell_parity()
    phase_compressed_grads(PARITY_N, 1)

    kernels = []
    for name in REPLACES:
        r = rows[name]
        bms, by = bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": r["library_ms"]})
    log(f"(kernel ms, plain_ms, bound_ms, library_ms: sums over the calls "
        f"of the {MICROBATCH}x{BUCKETS[-1]} serving microbatch, for "
        f"scatter_add_blocks of one {TRAIN_BATCH}x{TRAIN_N} training step, "
        f"and for fractal_level_blocks one call on that microbatch's leaf "
        f"blocks, (da, db) = {LEVEL_DIMS_TIMED}; launches: the serving run "
        f"(for scatter_add_blocks the {TRAIN_STEPS} training steps; "
        f"fractal_level_blocks is on no path); launches on the other paths, "
        f"each read around its own run: the compressed trainings "
        f"{compressed}, the PNN cells' timed steps {cells}, the 1M scene's "
        f"inference {scene_launches}; card: {smi}; total "
        f"{time.monotonic() - t_start:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
