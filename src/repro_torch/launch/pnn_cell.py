"""PNN cells: the paper's own workloads, run on one card or a mesh.

Counterpart of ``repro.launch.pnn_cell``, which lowers and compiles these
cells on a 256-chip TPU mesh; here the step *runs*.  By default a cell is
a *serving* step (the paper is an inference accelerator): Fractal
partition -> BPPO point ops -> PNN feature stages over a batch of clouds,
for PointNet++ / PointNeXt / PointVector segmentation at S3DIS scale (33K /
289K / 1M points, paper Figs. 13/15/18).  With ``kind="train"`` it is one
fine-tune step instead, the trainer's own (``train.pnn.make_train_step``:
the gradient through every point op, then AdamW).  A cell reports the
median step time, the peak device memory, the roofline row
(``launch/roofline.py``) and the kernel launches of the timed steps, and
holds every hand-written kernel call of one step against its plain
version on that call's own inputs (``kernels.checks.hold``): the leaf
chunks of ``leaf_chunk``, the short last one included.

The reference's batches were set for a 256-chip mesh.  On one 80 GB card
a cell given no batch takes the largest of 1, 2, 4, ... up to the
reference's that a probe at batch 1 says stays under ``MEM_LIMIT``
(``fit_batch``); widths and depths are never cut.

    from repro_torch.launch.pnn_cell import run_pnn_cell
    run_pnn_cell("pointnext", "pnn_289k")                 # on the card
    run_pnn_cell("pointnext", "pnn_33k", kind="train")

With ``mesh`` (``launch.mesh.make_host_mesh()`` under torchrun, one process
a card) the cell's batch goes over "data" of the host mesh where it
divides it, as the reference's cell puts it over the production mesh, and
the leaf blocks over "model": each rank steps on its share (a serving
step's logits stay sharded, as the reference's ``out_shardings``; a
training step all-reduces its gradient, ``train.pnn.mean_over_batch``),
and the row names the mesh and its chips.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.dist import logical
from repro_torch.kernels import checks, ops
from repro_torch.launch import roofline as rl
from repro_torch.models import pnn
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import pnn as train

MEM_LIMIT = 70 * 2**30        # bytes: what a cell may take of an 80 GB card
REPS = 5                      # timed steps a cell, after one untimed


@dataclasses.dataclass(frozen=True)
class PNNShape:
    name: str
    n_points: int
    batch: int
    th: int


PNN_SHAPES = {
    "pnn_33k": PNNShape("pnn_33k", 33_000, 16, 256),
    "pnn_289k": PNNShape("pnn_289k", 289_000, 16, 256),
    "pnn_1m": PNNShape("pnn_1m", 1_000_000, 4, 256),
}

PNN_VARIANTS = {
    "pointnet2": pnn.pointnet2_seg,
    "pointnext": pnn.pointnext_seg,
    "pointvector": pnn.pointvector_seg,
}


def _model_flops(cfg: pnn.PNNConfig, n: int, batch: int,
                 kind: str = "serve") -> float:
    """Useful FLOPs: MLP matmuls over grouped features + point-op distance
    updates (3 mul + 3 add per pair); a train step counts 3x (forward +
    backward, the usual 1:2 convention)."""
    total = 0.0
    sizes = cfg.stage_sizes()
    c_in = cfg.in_channels
    for i, s in enumerate(cfg.stages):
        m = sizes[i + 1]
        widths = (c_in + 3,) + tuple(s.widths)
        for a, b in zip(widths[:-1], widths[1:]):
            total += 2.0 * m * s.nsample * a * b
        # FPS within blocks: k iterations x block size; BQ: centers x window
        total += 6.0 * sizes[i] * (s.rate * cfg.th) + \
            6.0 * m * s.nsample * 2 * cfg.th
        c_in = s.widths[-1]
    for widths in cfg.fp_widths:
        m = sizes[-1]
        for a, b in zip((c_in,) + tuple(widths)[:-1], widths):
            total += 2.0 * m * a * b
    total = total * batch
    if kind == "train":
        total *= 3.0
    return total


@dataclasses.dataclass
class Cell:
    """One cell ready to run: ``step()`` is one serving forward (returns
    the logits) or one fine-tune step (returns its metrics) over
    ``batch``."""
    variant: str
    shape: PNNShape              # with the batch the cell runs
    kind: str
    cfg: pnn.PNNConfig
    model: pnn.PNN
    batch: dict                  # {"points", "labels"}, this rank's share
    device: torch.device
    step: Callable
    local_batch: int             # the clouds this rank steps on


def make_cell(variant: str, shape: str | PNNShape, *, batch: int | None = None,
              kind: str = "serve", leaf_chunk: int | None = 512,
              point_ops: str = "bppo", device=None,
              params: pnn.PNN | None = None, mesh=None) -> Cell:
    """Build a cell: the variant's segmentation config at ``shape`` (a name
    of ``PNN_SHAPES`` or a ``PNNShape``), weights ``params`` (moved to the
    device and, for ``kind="train"``, trained in place) or seeded random
    ones (seed 0), and a batch of ``data/synthetic.py`` scenes (seed 11,
    step 0, as ``train.pnn.fit`` draws its first); on ``mesh``, this
    rank's share of it."""
    if kind not in ("serve", "train"):
        raise ValueError(f"kind must be 'serve' or 'train', got {kind!r}")
    device = resolve_device(device) if mesh is None else mesh.device
    shape = PNN_SHAPES[shape] if isinstance(shape, str) else shape
    if batch is not None:
        shape = dataclasses.replace(shape, batch=batch)
    cfg = PNN_VARIANTS[variant](n=shape.n_points, point_ops=point_ops,
                                th=shape.th)
    cfg = dataclasses.replace(cfg, leaf_chunk=leaf_chunk)
    model = (params if params is not None else pnn.init(
        cfg, torch.Generator().manual_seed(0))).to(device)
    pts, labels = synthetic.segmentation_batch(11, 0, shape.batch,
                                               shape.n_points, device=device)
    with logical.mesh_rules(mesh):
        pts = logical.shard(pts, 0, "batch")
        data = {"points": pts, "labels": logical.shard(labels, 0, "batch")}
    if kind == "serve":
        def step():
            with torch.inference_mode(), logical.mesh_rules(mesh):
                return pnn.apply(model, cfg, pts)
    else:
        train_step = train.make_train_step(
            model, cfg, opt_lib.OptConfig(warmup=0),
            reduce=None if mesh is None else
            lambda g, m: train.mean_over_batch(g, m, shape.batch))
        params_d = train.param_dict(model)
        state = opt_lib.init(params_d)

        def step():
            with logical.mesh_rules(mesh):
                return train_step(params_d, state, data)[2]
    return Cell(variant, shape, kind, cfg, model, data, device, step,
                pts.shape[0])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _time(step, device, reps: int) -> list:
    """Seconds per call of ``step``, ``reps`` times: CUDA events around each
    call on the card (the host's enqueue included, as a caller waits for
    it), the host clock on the CPU."""
    out = []
    for _ in range(reps):
        _sync(device)
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            step()
            out.append(time.perf_counter() - t0)
    return out


def _check(cell: Cell, out) -> None:
    """Serving logits of the expected shape, all finite; a finite training
    loss; or raise."""
    if cell.kind == "serve":
        want = (cell.local_batch, cell.shape.n_points, cell.cfg.num_classes)
        ok = tuple(out.shape) == want and bool(torch.isfinite(out).all())
    else:
        ok = bool(torch.isfinite(out["loss"]))
    if not ok:
        raise RuntimeError(f"cell {cell.variant} x {cell.shape.name} "
                           f"({cell.kind}): bad or non-finite output")


def count(step) -> dict:
    """One call of ``step`` under the counters: {flops, bytes, kernel_calls,
    held} with the PyTorch operations' matmul FLOPs and bytes, plus each
    hand-written kernel call's own (``checks.work``).  Each kernel call is
    also held against its plain version on its own inputs before the step
    goes on (``checks.hold``, which raises on a difference); ``held`` is
    {name: {"blocks": the block count of each call, in order,
    "max_abs_err", "count_rows"}}.  What the hold runs is neither counted
    nor timed."""
    held = {}

    def tally(name, args):
        with torch.no_grad():
            res = checks.hold(name, args)
        h = held.setdefault(name, {"blocks": [], "max_abs_err": 0.0,
                                   "count_rows": 0})
        # every call's first argument has the blocks on its leading axis
        h["blocks"].append(next(iter(args.values())).shape[0])
        h["max_abs_err"] = max(h["max_abs_err"], res["max_abs_err"])
        h["count_rows"] += res["count_rows"]
        return checks.work(name, args)

    with checks.Recorder(tally=tally) as rec, \
            FlopCounterMode(display=False) as fc, rl.ByteCounter() as bc:
        step()
    kbytes = sum(w[0] for _, w in rec.calls)
    kops = sum(w[1] for _, w in rec.calls)
    calls = {name: len(h["blocks"]) for name, h in held.items()}
    return {"flops": fc.get_total_flops() + kops, "bytes": bc.bytes + kbytes,
            "kernel_calls": calls, "held": held}


def fit_batch(variant: str, shape: str | PNNShape, *, kind: str = "serve",
              **kw) -> tuple[int, dict]:
    """The largest batch of 1, 2, 4, ... up to the shape's own whose step
    stays under ``MEM_LIMIT`` bytes on the card, from one probe at batch 1:
    what the step adds to the device's allocations scales with the batch,
    what was allocated before it (weights, optimizer state) does not.
    Returns (batch, {"probe_base_gib", "probe_step_gib", "estimate_gib"})."""
    shape = PNN_SHAPES[shape] if isinstance(shape, str) else shape
    cell = make_cell(variant, shape, batch=1, kind=kind, **kw)
    if cell.device.type != "cuda":
        raise ValueError("fit_batch measures device memory: it needs the "
                         "card")
    cell.step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell.step()
    torch.cuda.synchronize()
    per = torch.cuda.max_memory_allocated() - base
    b = shape.batch
    while b > 1 and base + b * per > MEM_LIMIT:
        b //= 2
    del cell
    torch.cuda.empty_cache()
    return b, {"probe_base_gib": base / 2**30, "probe_step_gib": per / 2**30,
               "estimate_gib": (base + b * per) / 2**30}


def run_pnn_cell(variant: str, shape: str | PNNShape, *,
                 batch: int | None = None, kind: str = "serve",
                 leaf_chunk: int | None = 512, point_ops: str = "bppo",
                 device=None, verbose: bool = True,
                 reps: int = REPS, mesh=None) -> dict:
    """Run one cell and return its row: the roofline terms
    (``Roofline.to_dict``) and ``kind``, ``batch``, ``ref_batch``,
    ``warm_s`` (the first call, the kernels' build included when it is the
    process's first launch), ``step_s`` (median of ``reps`` calls),
    ``steps_s``, ``launches`` (each kernel's launches over those ``reps``
    calls), ``kernel_calls`` and ``held`` of the counted step (``count``),
    ``device`` and the probe of ``fit_batch`` where the batch was fitted
    (on the card, given no batch).  On the CPU, times are the host's,
    memory is not measured (NaN) and nothing is launched.  On ``mesh``
    each rank runs its share and reports its own counts and times, and
    the caller names the batch: a probe on one card does not say what
    fits a shard."""
    t0 = time.monotonic()
    dev = resolve_device(device) if mesh is None else mesh.device
    shape = PNN_SHAPES[shape] if isinstance(shape, str) else shape
    kw = dict(leaf_chunk=leaf_chunk, point_ops=point_ops, device=dev,
              mesh=mesh)
    probe = None
    if mesh is not None and batch is None:
        raise ValueError("a cell on a mesh needs its batch named")
    if batch is None and dev.type == "cuda":
        batch, probe = fit_batch(variant, shape, kind=kind, **kw)
    cell = make_cell(variant, shape, batch=batch, kind=kind, **kw)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        argument_bytes = torch.cuda.memory_allocated()
    t1 = time.monotonic()
    out = cell.step()
    _sync(dev)
    warm_s = time.monotonic() - t1
    _check(cell, out)
    counts = count(cell.step)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    times = _time(cell.step, dev, reps)
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else float("nan")
    output_bytes = (out.numel() * out.element_size() if kind == "serve"
                    else 0)
    n, b = cell.shape.n_points, cell.shape.batch
    tag = f"{shape.name}_train" if kind == "train" else shape.name
    row = rl.analyze(
        arch=variant, shape=tag, flops=counts["flops"],
        nbytes=counts["bytes"], peak_bytes=peak,
        argument_bytes=argument_bytes if cuda else float("nan"),
        output_bytes=output_bytes, step_s=statistics.median(times),
        model_flops=_model_flops(cell.cfg, n, b, kind=kind),
        mesh_name=(f"1x{dev.type}" if mesh is None else
                   "x".join(map(str, mesh.devices.shape))),
        chips=1 if mesh is None else mesh.devices.size)
    d = row.to_dict()
    d.update({"kind": kind, "batch": b, "local_batch": cell.local_batch,
              "ref_batch": shape.batch,
              "warm_s": warm_s, "steps_s": times, "total_s":
              time.monotonic() - t0, "launches": launches,
              "kernel_calls": counts["kernel_calls"], "held": counts["held"],
              "device": (torch.cuda.get_device_name(dev) if cuda
                         else "cpu"), "probe": probe})
    if verbose:
        mem = d["mem_per_device"]
        print(f"[dryrun:pnn] {variant} x {tag} batch {b} (reference "
              f"{shape.batch}) on {d['device']}: step "
              f"{d['step_s'] * 1e3:.1f} ms (warm {warm_s:.1f} s) | peak "
              f"{mem['peak_mb'] / 1024:.2f} GiB | flops "
              f"{d['hlo_flops_per_chip']:.3e} | bytes "
              f"{d['hlo_bytes_per_chip']:.3e} | bound={d['bottleneck']} "
              f"{d['bound_fraction'] * 100:.1f}% of the step | held "
              f"{sum(d['kernel_calls'].values())} kernel calls", flush=True)
    return d
