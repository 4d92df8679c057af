#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  Phases, each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the float32 matmul settings (TF32 off, "highest");
2. build every kernel of ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each hand-written kernel against its plain PyTorch version on the
   same CUDA tensors, by the rules of ``repro_torch.kernels.checks``: on
   its odd ladder (block sizes 65/200/33, empty blocks, all-invalid masks,
   FPS exhaustion, out-of-range gathers, FPS blocks of 1500-5000 lanes,
   1500-lane windows) and on the inputs the serving path gives it in one
   microbatch of the largest bucket, with the kernel's, the plain
   version's and the PyTorch library call's median times;
4. serve 8 mixed-size segmentation requests through ``ServeEngine`` on the
   card (pointnet2 seg, full widths, th=256, buckets 4096/16384/65536,
   microbatch 4, seeded random weights), with every kernel's launch count
   read around that run; check the logits, and hold the 4096-bucket ones
   against the same engine on the CPU;
5. one 289,000-point cloud (S3DIS scale) through ``pnn.apply``: its time
   and peak device memory;
6. one microbatch per bucket under ``torch.profiler``: device time by
   kernel and the card's idle share.

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
# H100 SXM published rates (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) operations/s.  Comparisons and selects count as fp32
# operations.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
LOGIT_TOL = 1e-3      # card vs CPU: float32 matmuls sum in another order
LOGIT_SHARE = 0.999   # share of points within LOGIT_TOL

REPLACES = {
    "fps_blocks": "src/repro/kernels/fps.py:62",
    "ball_query_blocks": "src/repro/kernels/ball_query.py:43",
    "knn_blocks": "src/repro/kernels/knn.py:31",
    "gather_blocks": "src/repro/kernels/gather.py:30",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name.rsplit('_', 1)[0]}.cu"
           for name in REPLACES}


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

def median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name: str, args: dict) -> tuple[float, float]:
    """(bytes, operations) that one call needs on these inputs: each input
    read once and each output written once, but coordinates only of valid
    lanes (masks in full), queries only of blocks whose window has a valid
    lane, and for gather only the distinct in-range feature rows that the
    indices name; operations only on valid lanes, for the steps or ranks
    a block's valid lanes can fill."""
    import torch
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
        ops = float((nv * (8 + nv.clamp(max=num))).sum()) * nq
        nbytes = (live * nq * 12 + int(nv.sum()) * 12 + wm.numel()
                  + nb * nq * num * 8)
        if name == "ball_query_blocks":
            cm = args["cmask"]
            ops += float((cm.sum(1) * nv).sum()) * 2.0   # radius test, count
            nbytes += cm.numel() + nb * nq * 4
        return nbytes, ops
    f, idx = args["feats"], args["idx"]
    nb, w, c = f.shape
    ok = (idx >= 0) & (idx < w)
    key = torch.arange(nb, device=idx.device)[:, None] * w + idx.long()
    rows = int(torch.unique(key[ok]).numel())
    return rows * c * 4 + idx.numel() * 4 + idx.numel() * c * 4, 0.0


# ---------------------------------------------------------------------------
# Kernel against plain.
# ---------------------------------------------------------------------------

class Recorder:
    """Record the arguments of every kernel call that ``kernels.ops`` makes
    (the main path's own inputs) for the length of one forward, by handing
    ``ops`` stand-ins for its kernel modules; the kernels themselves and
    their launch counters are untouched."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import types
        from repro_torch.kernels import ops

        def stand_in(mod, name, to_args):
            orig = getattr(mod, name)

            def rec(*a, **kw):
                self.calls.append((name, to_args(*a, **kw)))
                return orig(*a, **kw)
            return types.SimpleNamespace(**{name: rec})

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
        ops._ga = stand_in(ops._ga, "gather_blocks",
                           lambda f, i: dict(feats=f, idx=i))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for alias, mod in self._saved.items():
            setattr(ops, alias, mod)
        return False


def library_calls(name, args) -> dict:
    """PyTorch calls that compute the same function on these inputs, where
    there are: a gather whose indices all lie in the window is
    ``torch.gather`` (with the index widened to (NB, M, C)) or advanced
    indexing (with the (NB, M) index).  Both are timed; the faster is
    reported."""
    import torch
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


def phase_ladder(device):
    from repro_torch.kernels import checks
    flips = rows = 0
    calls = checks.ladder(device)
    for name, args in calls:
        res = checks.hold(name, args)
        flips += res["near_tie_flips"]
        rows += res["count_rows"]
    log(f"ladder: {len(calls)} kernel calls match their plain versions "
        f"({flips} near-tie flips, {rows} ball-query counts off by their "
        f"boundary lanes)")


def make_engine(device, params=None):
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=BUCKETS, microbatch=MICROBATCH, variant="pointnet2",
                      task="seg", num_classes=6, th=TH)
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def phase_main_path_kernels(engine):
    """Record the kernel inputs of one full microbatch of the largest
    bucket, served through the engine, then hold and time every kernel
    call on them."""
    import torch
    from repro_torch.kernels import checks
    b = BUCKETS[-1]
    with Recorder() as rec:
        rids = [engine.submit(clustered_cloud(b, 100 + i))
                for i in range(MICROBATCH)]
        engine.flush()
    for rid in rids:
        engine.take(rid)
    rows = {}
    for name, args in rec.calls:
        res = checks.hold(name, args)
        run_kernel, run_plain = checks.runners(name, args)
        ms = median_ms(run_kernel, reps=20)
        plain_ms = median_ms(run_plain, reps=5, warmup=1)
        libs = {label: median_ms(fn, reps=20)
                for label, fn in library_calls(name, args).items()}
        lib_ms = min(libs.values()) if libs else None
        nbytes, ops = work(name, args)
        bms, by = bound_ms(nbytes, ops)
        log(f"  {name:18s} {shape_of(name, args):38s} kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bms:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)  library "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in libs.items()) or "-")
            + f"  max|err| {res['max_abs_err']:.3g}  flips "
            f"{res['near_tie_flips']}  count rows {res['count_rows']}")
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
    missing = set(REPLACES) - set(rows)
    if missing:
        raise AssertionError(f"main path made no call to {sorted(missing)}")
    torch.cuda.synchronize()
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
    idle = [k for k, v in launches.items() if v == 0]
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


def phase_cpu_reference(engine, clouds, results):
    """The 4096-bucket requests again on the CPU (plain versions, same
    weights): |logit difference| <= LOGIT_TOL on >= LOGIT_SHARE of points."""
    import copy
    small = [(i, c) for i, c in enumerate(clouds) if len(c) <= BUCKETS[0]]
    cpu = make_engine("cpu", params=copy.deepcopy(engine.params).cpu())
    rids = [cpu.submit(c) for _, c in small]
    cpu.flush()
    total = over = 0
    worst = 0.0
    for (i, c), rid in zip(small, rids):
        want = cpu.take(rid)
        got = results[i]
        diff = np.abs(got - want).max(-1)
        total += len(diff)
        over += int((diff > LOGIT_TOL).sum())
        worst = max(worst, float(diff.max()))
    share = 1.0 - over / total
    log(f"4096 bucket, card vs CPU: {len(small)} clouds, {total} points, "
        f"{over} over {LOGIT_TOL} (share within {share:.6f}), max |d| "
        f"{worst:.3g}")
    if share < LOGIT_SHARE:
        raise AssertionError("card and CPU logits disagree")


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


def phase_profile(engine):
    """Where the time goes: one full microbatch per bucket under
    torch.profiler; device time by kernel, kernel launches, and the card's
    busy share of the wall time (profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # The kernels of csrc/ live in an anonymous namespace.
    ported = tuple(f"(anonymous namespace)::{k}_kernel"
                   for k in ("fps", "ball_query", "knn", "gather"))
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
        log(f"profile bucket {b} (microbatch {MICROBATCH}): wall "
            f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"(idle share {1 - busy / wall_us:.3f}), {launches} device ops, "
            f"ported kernels {mine / 1e3:.2f} ms")
        for us, count, key in dev[:8]:
            log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")


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

    kernels = []
    for name in REPLACES:
        r = rows[name]
        bms, by = bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": r["library_ms"]})
    log(f"(kernel ms, plain_ms, bound_ms, library_ms: sums over the "
        f"{MICROBATCH}x{BUCKETS[-1]} microbatch's calls; launches: the "
        f"serving run; card: {smi}; total {time.monotonic() - t_start:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
