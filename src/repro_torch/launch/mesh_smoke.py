"""The multi-card PNN path on the cards of one host, checked end to end.

Run one process a card under torchrun::

  python -m torch.distributed.run --nproc-per-node 4 -m \\
      repro_torch.launch.mesh_smoke --model-axis 2 [--measure]

Every rank joins the world over NCCL (``dist/process.py``), lays the
(data, model) mesh over it (``--model-axis 1``: (4, 1), ``2``: (2, 2); one
card: (1, 1)) and runs, through the entry points a user calls:

* serving (``examples.serve_pnn.run``): 8 requests of PointNeXt at its
  published widths through buckets 4096 / 16384 (microbatch 4, th=256) on
  the mesh, against the same engine with no mesh on this rank's card by
  the serving rule (|difference| <= 1e-3 on >= 99.9 % of the points); the
  four serving kernels must have launched on every rank;
* training (``train.pnn.fit``): 5 steps of ``pointnet2_seg`` at 8 x 16,384
  points, uncompressed and with int8 error feedback, each against the
  same run with no mesh on this rank's card (losses within 1e-4), the five
  training kernels launched and the parameters bit for bit the same on
  every rank (hashes all-gathered);
* a 289,000-point scene (``scene.SceneEngine``): each point owned by one
  tile, finite logits, the same bits on every rank.

``--measure`` adds the numbers PERF.md keeps: a 32-request stream's
clouds/s and p50/p95 per bucket, the median training step at 8 and at 32
x 16,384 (on four cards 2 and 8 clouds a card; each uncompressed and
int8), the 1,000,000-point
scene's points/s, and one training step under ``torch.profiler`` on rank
0 (all-reduce, all-gather and broadcast device time, idle share).

Rank 0 prints one line ``MESH_RESULT {json}``.  Nothing is caught: a
failed check raises, the rank exits non-zero and torchrun with it.  It
runs on the cards unless given ``--device cpu`` (gloo, the plain
versions, which launch no kernel: the launch checks then fail).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import scene, serve
from repro_torch.data import synthetic
from repro_torch.dist import elastic, process
from repro_torch.examples import serve_pnn
from repro_torch.kernels import ops
from repro_torch.train import pnn as train

BUCKETS = (4096, 16384)
MICROBATCH = 4
TH = 256
REQUESTS = 8
TRAIN_N = 16384
TRAIN_BATCH = 8
TRAIN_STEPS = 5
SCENE_N = 289_000
SCENE = dict(tile_points=4096, halo=0.15, th=TH, microbatch=MICROBATCH)
LOGIT_TOL = 1e-3      # the serving rule: float32 sums in another order
LOGIT_SHARE = 0.999
LOSS_TOL = 1e-4
SERVING = ("fps_blocks", "ball_query_blocks", "knn_blocks", "gather_blocks")
TRAINING = SERVING + ("scatter_add_blocks",)
MEASURE_REQUESTS = 32
MEASURE_STEPS = 10
MEASURE_BATCHES = (TRAIN_BATCH, 4 * TRAIN_BATCH)   # 2 and 8 clouds a card
MEASURE_SCENE_N = 1_000_000
COLLECTIVES = ("AllReduce", "AllGather", "Broadcast")


def gathered(mesh, obj) -> list:
    """Every rank's ``obj``, in rank order."""
    if mesh.world.backend is None:
        return [obj]
    out = [None] * mesh.world.size
    dist.all_gather_object(out, obj)
    return out


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def same_on_every_rank(mesh, what: str, value: str) -> None:
    seen = gathered(mesh, value)
    if len(set(seen)) != 1:
        raise AssertionError(f"{what} differs across ranks: {seen}")


def check_launched(mesh, what: str, launches: dict, names) -> list:
    every = gathered(mesh, launches)
    idle = [(r, k) for r, row in enumerate(every) for k in names
            if row[k] == 0]
    if idle:
        raise AssertionError(f"{what}: kernels not launched (rank, name) "
                             f"{idle}")
    return every


def serving_rule(got, want, what: str) -> dict:
    total = over = 0
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shapes {g.shape} vs {w.shape}")
        diff = np.abs(g - w).max(-1)
        total += len(diff)
        over += int((diff > LOGIT_TOL).sum())
        worst = max(worst, float(diff.max()))
    share = 1.0 - over / total
    if share < LOGIT_SHARE:
        raise AssertionError(f"{what}: {over} of {total} points over "
                             f"{LOGIT_TOL} (max {worst})")
    return {"points": total, "over": over, "max_abs": worst}


def serve_cfg(mesh_on: bool, model_axis: int) -> serve.ServeConfig:
    return serve.ServeConfig(buckets=BUCKETS, microbatch=MICROBATCH,
                             variant="pointnext", th=TH,
                             mesh="auto" if mesh_on else "none",
                             model_axis=model_axis)


def stream(requests: int, seed: int = 0) -> list:
    sizes = serve.mixed_request_sizes(BUCKETS, requests, seed)
    return [synthetic.segmentation_batch(seed, r, 1, n)[0][0].numpy()
            for r, n in enumerate(sizes)]


def check_serving(mesh, model_axis: int) -> dict:
    clouds = stream(REQUESTS)
    _, want = serve_pnn.run(serve_cfg(False, model_axis), clouds,
                            device=mesh.device, log=process.quiet)
    rep, got = serve_pnn.run(serve_cfg(True, model_axis), clouds, mesh=mesh,
                             log=process.quiet)
    rule = serving_rule(got, want, "mesh serving vs one card")
    every = check_launched(mesh, "mesh serving", ops.launch_counts(),
                           SERVING)
    same_on_every_rank(mesh, "serving logits", digest(got))
    return {"requests": len(clouds), "rule": rule, "launches": every,
            "mesh": rep["mesh"]}


def fit(mesh, model_axis: int, batch: int, steps: int, compression: str,
        on_mesh: bool):
    cfg = train.TrainConfig(preset="pointnet2_seg", n_points=TRAIN_N, th=TH,
                            batch=batch, steps=steps,
                            grad_compression=compression,
                            mesh="auto" if on_mesh else "none",
                            model_axis=model_axis,
                            device=str(mesh.device))
    ops.reset_launch_counts()
    model, _, info = train.fit(cfg, log=process.quiet,
                               mesh=mesh if on_mesh else None)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return ([h["loss"] for h in info["history"]],
            [h["dt"] for h in info["history"]], flat.cpu().numpy(),
            ops.launch_counts())


def check_training(mesh, model_axis: int) -> dict:
    out = {}
    for comp in ("none", "int8"):
        want, _, _, _ = fit(mesh, model_axis, TRAIN_BATCH, TRAIN_STEPS, comp,
                            False)
        got, dts, params, launches = fit(mesh, model_axis, TRAIN_BATCH,
                                         TRAIN_STEPS, comp, True)
        worst = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        if len(got) != TRAIN_STEPS or not np.isfinite(got).all() or \
                worst > LOSS_TOL:
            raise AssertionError(f"mesh training ({comp}): losses {got} vs "
                                 f"one card {want}")
        every = check_launched(mesh, f"mesh training ({comp})", launches,
                               TRAINING)
        same_on_every_rank(mesh, f"parameters after training ({comp})",
                           digest([params]))
        out[comp] = {"losses": got, "one_card_losses": want,
                     "max_abs": worst, "step_ms": [d * 1e3 for d in dts],
                     "launches": every}
    return out


def run_scene(mesh, model_axis: int, n: int) -> dict:
    eng = scene.SceneEngine(scene.SceneConfig(mesh="auto",
                                              model_axis=model_axis,
                                              **SCENE), mesh=mesh)
    eng.warm()
    coords, _ = synthetic.scene(0, n, device=mesh.device)
    sync(mesh)
    t0 = time.monotonic()
    logits, plan = eng.infer(coords)
    dt = time.monotonic() - t0
    owners = np.bincount(np.concatenate([t.owned for t in plan.tiles]),
                         minlength=n)
    if not ((owners == 1).all() and np.isfinite(logits).all()):
        raise AssertionError(f"{n}-point scene on the mesh: a point not "
                             f"owned once, or logits not finite")
    same_on_every_rank(mesh, f"{n}-point scene logits", digest([logits]))
    return {"points": n, "tiles": plan.num_tiles, "infer_s": dt,
            "points_per_s": n / dt}


def sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def median_step_ms(dts) -> float:
    return statistics.median(dts[1:]) * 1e3


def profile_step(mesh, model_axis: int) -> dict:
    """One 8 x 16,384 training step (the trainer's step on the mesh, after
    two unprofiled ones) under torch.profiler on rank 0."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import pnn_cell
    shape = pnn_cell.PNNShape("mesh_16k", TRAIN_N, TRAIN_BATCH, TH)
    cell = pnn_cell.make_cell("pointnet2", shape, kind="train",
                              leaf_chunk=None, mesh=mesh)
    for _ in range(2):
        float(cell.step()["loss"])
    process.barrier(mesh.world)
    if mesh.world.rank != 0:
        float(cell.step()["loss"])
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        float(cell.step()["loss"])
        wall_us = (time.monotonic() - t0) * 1e6
    busy, ops_n = 0.0, 0
    by = {k: 0.0 for k in COLLECTIVES}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and ev.device_type.name == "CUDA":
            busy += us
            ops_n += ev.count
            for k in COLLECTIVES:
                if k.lower() in ev.key.lower():
                    by[k] += us
    if busy <= 0:
        raise AssertionError("mesh training step: the profiler saw no "
                             "device time")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "device_ops": ops_n, "idle_share": 1 - busy / wall_us,
            **{f"{k.lower()}_ms": v / 1e3 for k, v in by.items()}}


def measure(mesh, model_axis: int) -> dict:
    rep, _ = serve_pnn.run(serve_cfg(True, model_axis),
                           stream(MEASURE_REQUESTS, seed=1), mesh=mesh,
                           log=process.quiet)
    out = {"serving": {k: rep[k] for k in ("served", "wall_s",
                                           "clouds_per_s", "buckets")}}
    for batch in MEASURE_BATCHES:
        for comp in ("none", "int8"):
            _, dts, _, _ = fit(mesh, model_axis, batch, MEASURE_STEPS, comp,
                               True)
            out[f"train_{batch}x{TRAIN_N}_{comp}_ms"] = median_step_ms(dts)
    out["scene_1m"] = run_scene(mesh, model_axis, MEASURE_SCENE_N)
    out["profile"] = profile_step(mesh, model_axis)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-axis", type=int, default=2)
    ap.add_argument("--measure", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: this rank's card; 'cpu' joins over gloo")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    mesh = elastic.make_mesh(model_axis=args.model_axis, device=args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = mesh.device.type == "cuda"
    res = {"world": mesh.world.size, "backend": mesh.world.backend,
           "mesh": mesh.shape,
           "card": (torch.cuda.get_device_name(mesh.device) if on_card
                    else "cpu"),
           "serving": check_serving(mesh, args.model_axis),
           "training": check_training(mesh, args.model_axis),
           "scene": run_scene(mesh, args.model_axis, SCENE_N)}
    if args.measure:
        res["measure"] = measure(mesh, args.model_axis)
    res["seconds"] = time.monotonic() - t0
    if mesh.world.rank == 0:
        print("MESH_RESULT " + json.dumps(res, default=str), flush=True)
    process.barrier(mesh.world)
    process.shutdown()
    return res


if __name__ == "__main__":
    main()
