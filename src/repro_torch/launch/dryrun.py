"""Run the LM and PNN cells on one card and print their roofline table.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles every
(arch x shape) cell for a TPU pod; here each cell *runs* on the card:
``run_cell`` for the LM cells (``train_4k`` one ``lm.steps`` train step,
``prefill_32k`` one prefill, ``decode_32k`` and ``long_500k`` one decode
step at a cache of ``seq_len``), ``pnn_cell.run_pnn_cell`` for the PNN
ones.  An LM cell reports its median step (CUDA events), peak memory,
counted FLOPs (``FlopCounterMode``) and bytes (``roofline.ByteCounter``),
``model_flops``, ``n_params`` and ``n_active`` (of the full config, the
reference's numbers) and the ``Roofline`` row.

The reference's batches and depths were set for a 256-chip mesh.  On one
80 GB card a cell keeps every width.  Its depth is cut to the most
repetitions that fit: for a serving cell, whose weights would pass
``WEIGHT_SHARE`` of ``pnn_cell.MEM_LIMIT``, by their bytes; for a train
cell, whose saved activations grow with the depth too, by probes of its
step at batch 1 with 1 and 2 repetitions and at the depth they point to
(``probe_reps``).  A cell given no batch then takes the largest power of
two up to the reference's that a probe at batch 1 keeps under
``MEM_LIMIT``.  Each cut is listed in the
row's ``reduced``.  A train cell accumulates over the reference's
``MICROBATCH`` slices where its batch still divides by them; the depth is
priced with that accumulator only where the batch is given, since a
fitted batch is fitted at the depth of batch 1, which has none.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k [--batch 8] [--out rows.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch pointnext \\
        --shape pnn_289k [--train]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

``--device cpu`` runs on the CPU (small shapes only).  A cell that fails
ends the run with a non-zero exit, after the rows done so far are written
to ``--out``.  Under ``--all`` a cell whose one repetition cannot fit the
card (``DoesNotFit``) is recorded as skipped, with its reason, as a cell
that ``applicable`` skips is; named alone it raises.  The reference's XLA-only pieces (metric compiles and their
linear fit, the xLSTM flop add-back, sharding rules, ``--multi-pod``,
``--both-meshes``, ``--no-metrics``) have no counterpart: a counted run
sees every loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from typing import Callable

import torch
import torch.utils._pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.device import resolve_device
from repro_torch.dist import elastic, logical
from repro_torch.launch import roofline as rl
from repro_torch.launch.pnn_cell import (MEM_LIMIT, PNN_SHAPES, PNN_VARIANTS,
                                         REPS, _sync, _time, run_pnn_cell)
from repro_torch.launch.train import make_batch
from repro_torch.lm import model as M
from repro_torch.lm import steps as steps_lib
from repro_torch.train import optimizer as opt_lib

# Gradient-accumulation policy for train cells (the reference's table).
MICROBATCH = {"llama4-scout-17b-16e": 4, "chameleon-34b": 4,
              "zamba2-7b": 4, "gemma3-12b": 4, "minitron-4b": 2,
              "gemma2-2b": 2, "granite-moe-3b-a800m": 8, "xlstm-1.3b": 4}
# Share of MEM_LIMIT a serving cell's weights may take; the rest is for
# activations and caches.
WEIGHT_SHARE = 0.75


class DoesNotFit(ValueError):
    """One repetition of a cell cannot fit the card at batch 1."""


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _weight_bytes(cfg: M.LMConfig, model: M.LM) -> tuple[int, int]:
    """(bytes of the parameters outside the repeated stack, bytes of one
    repetition's); a shared block counts once, outside."""
    shared = {id(p) for p in model.shared.parameters()}
    per_rep = _bytes({id(p): p for b in model.blocks[:len(cfg.pattern)]
                      for p in b.parameters()
                      if id(p) not in shared}.values())
    return _bytes(model.parameters()) - cfg.reps * per_rep, per_rep


def _cut(cfg: M.LMConfig, reps: int) -> M.LMConfig:
    return dataclasses.replace(cfg, n_layers=reps * len(cfg.pattern))


def fit_reps(cfg: M.LMConfig, model: M.LM, kind: str,
             microbatch: int = 1) -> int:
    """The most repetitions, up to ``cfg.reps``, whose weights stay under
    ``WEIGHT_SHARE * MEM_LIMIT`` (a serving cell); ``model`` may be on the
    meta device.  For a train cell, whose saved activations grow with the
    depth too, ``probe_reps`` decides; here it raises where one
    repetition's weights, gradients, two moments (and an accumulator)
    alone pass ``MEM_LIMIT``."""
    fixed, per_rep = _weight_bytes(cfg, model)
    if kind == "train":
        copies = 5 if microbatch > 1 else 4
        if copies * (fixed + per_rep) > MEM_LIMIT:
            raise DoesNotFit(
                f"{cfg.name} (train): one repetition's weights and "
                f"optimizer state ({copies * (fixed + per_rep) / 2**30:.1f}"
                f" GiB) pass the card's {MEM_LIMIT / 2**30:.0f} GiB")
        return cfg.reps
    reps = min(cfg.reps, int((WEIGHT_SHARE * MEM_LIMIT - fixed) // per_rep))
    if reps < 1:
        raise DoesNotFit(
            f"{cfg.name} ({kind}): one repetition's weights "
            f"({(fixed + per_rep) / 2**30:.1f} GiB) pass {WEIGHT_SHARE} of "
            f"the card's {MEM_LIMIT / 2**30:.0f} GiB")
    return reps


def _step_peak(arch, shape, cfg, device) -> int:
    """The allocation peak of a train cell's second step at batch 1."""
    model, _ = M.init(cfg, torch.Generator(device).manual_seed(0),
                      device=device)
    cell = make_cell(arch, shape, cfg, model, batch=1)
    cell.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cell.step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def probe_reps(arch: str, shape: ShapeSpec, cfg: M.LMConfig, meta: M.LM,
               reps: int, *, microbatch: int = 1,
               device=None) -> tuple[int, dict]:
    """For a train cell on the card: the most repetitions, up to ``reps``,
    whose step at batch 1 peaks under ``MEM_LIMIT`` (plus an accumulator
    of the weights' size where the cell microbatches; ``meta``: the model,
    on the meta device).  The peaks at 1 and 2 repetitions give a linear
    guess, and the guess is probed too and stepped down until its peak
    fits: the peak's moment moves with the depth (the loss's logits at a
    shallow one, the backward's gradients at a deep one), so it grows
    faster than the two probes show.  1 where the step at 2 does not fit;
    raises ``DoesNotFit`` where the step at 1 does not.  Returns
    (repetitions, {"rep_probe_gib": {repetitions: peak}, "estimate_gib":
    the chosen depth's peak})."""
    fixed_w, per_w = _weight_bytes(cfg, meta)
    peaks = {}

    def peak(r: int) -> float:
        if r not in peaks:
            try:
                peaks[r] = _step_peak(arch, shape, _cut(cfg, r), device)
            except torch.OutOfMemoryError:
                peaks[r] = math.inf
            finally:
                torch.cuda.empty_cache()
            if microbatch > 1:
                peaks[r] += fixed_w + r * per_w
        return peaks[r]

    if peak(1) > MEM_LIMIT:
        raise DoesNotFit(
            f"{cfg.name} (train): one repetition's step at batch 1 "
            + ("runs out of the card's memory" if math.isinf(peaks[1]) else
               f"peaks at {peaks[1] / 2**30:.1f} GiB, past the card's "
               f"{MEM_LIMIT / 2**30:.0f} GiB"))
    fit = 1
    if reps > 1 and peak(2) <= MEM_LIMIT:
        per = max(peaks[2] - peaks[1], 1)
        fit = min(reps, int((MEM_LIMIT - peaks[1] + per) // per))
        while fit > 2 and peak(fit) > MEM_LIMIT:
            over = peaks[fit] - MEM_LIMIT
            fit -= 1 if math.isinf(over) else max(1, math.ceil(over / per))
        fit = max(fit, 2)
    return fit, {"rep_probe_gib": {r: p / 2**30 for r, p in peaks.items()},
                 "estimate_gib": peaks[fit] / 2**30}


@dataclasses.dataclass
class LMCell:
    """One LM cell ready to run: ``step()`` is one train step (returns its
    metrics), one prefill or one decode step (return (logits, cache)) over
    ``inputs``."""
    arch: str
    shape: ShapeSpec             # with the batch the cell runs
    cfg: M.LMConfig              # with the depth the cell runs
    model: M.LM
    microbatch: int
    inputs: dict
    device: torch.device
    step: Callable


def _microbatch(arch: str, batch: int) -> int:
    mb = MICROBATCH.get(arch, 1)
    return mb if mb > 1 and batch % mb == 0 else 1


def make_cell(arch: str, shape: ShapeSpec, cfg: M.LMConfig, model: M.LM, *,
              batch: int) -> LMCell:
    """A cell of ``model`` (``cfg``) at ``batch``: its inputs made from
    seed 0 (``launch.train.make_batch``, step 0) and, for a decode cell,
    zero caches of ``seq_len`` and the last position."""
    dev = model.emb.w.device
    s = shape.seq_len
    shape = dataclasses.replace(shape, global_batch=batch)
    mb = _microbatch(arch, batch)
    mesh = elastic.make_mesh(devices=[dev])
    data = make_batch(cfg, 0, 0, batch, s if shape.kind != "decode" else 1,
                      dev)
    if shape.kind == "train":
        ts = steps_lib.make_train_step(model, cfg, opt_lib.OptConfig(),
                                       microbatch=mb)
        params = steps_lib.param_dict(model)
        state = opt_lib.init(params)
        inputs = data

        def run():
            return ts(params, state, data)[2]
    elif shape.kind == "prefill":
        pf = steps_lib.make_prefill_step(cfg, max_len=s)
        inputs = {k: v for k, v in data.items() if k != "labels"}

        def run():
            return pf(model, inputs)
    else:
        dc = steps_lib.make_decode_step(cfg)
        if cfg.frontend == "embeddings" and not cfg.encoder_layers:
            token = data["frames"]
        else:
            token = data["dec_tokens" if cfg.encoder_layers else "tokens"]
        cache = M.init_cache(model, cfg, batch, s,
                             enc_len=s if cfg.encoder_layers else None)
        inputs = {"token": token, "cache": cache}

        def run():
            return dc(model, token, cache, s - 1)

    def step():
        with logical.logical_rules(mesh, logical.RULES_V0):
            return run()

    return LMCell(arch, shape, cfg, model, mb, inputs, dev, step)


def _input_bytes(inputs) -> int:
    return _bytes(t for t in pytree.tree_leaves(inputs)
                  if isinstance(t, torch.Tensor))


def fit_batch(arch: str, shape: ShapeSpec, cfg: M.LMConfig,
              model: M.LM) -> tuple[int, dict]:
    """The largest batch of 1, 2, 4, ... up to the shape's own whose cell
    stays under ``MEM_LIMIT`` bytes on the card, from one probe at batch
    1: its inputs (and caches) scale with the batch, what a step adds to
    the allocations with the batch of one slice, the weights and optimizer
    state not (a microbatched step also holds an accumulator).  Returns
    (batch, {"probe_base_gib", "probe_step_gib", "probe_inputs_gib",
    "estimate_gib"})."""
    if model.emb.w.device.type != "cuda":
        raise ValueError("fit_batch measures device memory: it needs the "
                         "card")
    cell = make_cell(arch, shape, cfg, model, batch=1)
    cell.step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell.step()
    torch.cuda.synchronize()
    per = torch.cuda.max_memory_allocated() - base
    inp = _input_bytes(cell.inputs)
    acc = _bytes(model.parameters()) if shape.kind == "train" else 0
    del cell
    torch.cuda.empty_cache()

    def estimate(b):
        mb = _microbatch(arch, b)
        return base - inp + b * inp + (b // mb) * per + (acc if mb > 1
                                                          else 0)

    b = shape.global_batch
    while b > 1 and estimate(b) > MEM_LIMIT:
        b //= 2
    return b, {"probe_base_gib": base / 2**30, "probe_step_gib": per / 2**30,
               "probe_inputs_gib": inp / 2**30,
               "estimate_gib": estimate(b) / 2**30}


def _check(cell: LMCell, out) -> None:
    if cell.shape.kind == "train":
        ok = bool(torch.isfinite(out["loss"]))
    else:
        logits = out[0]
        ok = (tuple(logits.shape) == (cell.shape.global_batch, 1,
                                      cell.cfg.padded_vocab)
              and bool(torch.isfinite(logits[..., :cell.cfg.vocab]).all()))
    if not ok:
        raise RuntimeError(f"cell {cell.arch} x {cell.shape.name}: bad or "
                           f"non-finite output")


def count(step) -> dict:
    """One call of ``step`` under the counters: {flops, bytes} of the
    PyTorch operations (matmul FLOPs; each input read and each output
    written once)."""
    with FlopCounterMode(display=False) as fc, rl.ByteCounter() as bc:
        step()
    return {"flops": fc.get_total_flops(), "bytes": bc.bytes}


def run_cell(arch: str, shape_name: str | ShapeSpec, *, cfg_overrides=None,
             batch: int | None = None, device=None, verbose: bool = True,
             reps: int = REPS) -> dict:
    """Run one (arch x shape) LM cell and return its row: the roofline
    terms (``Roofline.to_dict``, compute against the bfloat16 peak where
    the activations are bfloat16) and ``kind``, ``batch``, ``ref_batch``,
    ``microbatch``, ``reps``/``ref_reps`` (pattern repetitions run / of the
    config), ``reduced`` (each cut, e.g. ``"batch 256->8"``), ``warm_s``,
    ``step_s`` (median of ``reps`` calls), ``steps_s``, ``n_params`` and
    ``n_active`` (the full config's), ``run_params``/``run_active`` (what
    ran), ``device``, the probe of ``fit_batch`` where the batch was
    fitted and of ``probe_reps`` where a train cell's depth was; or ``{"arch", "shape", "mesh", "skipped"}`` for a cell that
    ``applicable`` skips.  On the CPU nothing is cut, times are the
    host's and memory is not measured (NaN)."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg = configs.lm_config(arch, **(cfg_overrides or {}))
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": f"1x{dev.type}",
                "skipped": why}
    meta, _ = steps_lib.eval_shape_init(cfg)
    n_total, n_active = rl.count_params(meta), rl.active_params(cfg, meta)
    cuts = []
    run_cfg = cfg
    rep_probe = None
    if cuda:
        # a fitted batch is fitted at the depth of batch 1: no accumulator
        mb = _microbatch(arch, batch) if batch else 1
        r = fit_reps(cfg, meta, shape.kind, mb)
        if shape.kind == "train" and r > 1:
            r, rep_probe = probe_reps(arch, shape, cfg, meta, r,
                                      microbatch=mb, device=dev)
        if r < cfg.reps:
            cuts.append(f"reps {cfg.reps}->{r}")
            run_cfg = _cut(cfg, r)
    del meta
    model, _ = M.init(run_cfg, torch.Generator(dev).manual_seed(0),
                      device=dev)
    probe = None
    if batch is None and cuda:
        batch, probe = fit_batch(arch, shape, run_cfg, model)
    batch = batch or shape.global_batch
    if batch != shape.global_batch:
        cuts.insert(0, f"batch {shape.global_batch}->{batch}")
    cell = make_cell(arch, shape, run_cfg, model, batch=batch)
    if cuda:
        torch.cuda.synchronize()
        argument_bytes = torch.cuda.memory_allocated()
    t1 = time.monotonic()
    out = cell.step()
    _sync(dev)
    warm_s = time.monotonic() - t1
    _check(cell, out)
    del out
    counts = count(cell.step)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = _time(cell.step, dev, reps)
    peak = torch.cuda.max_memory_allocated() if cuda else float("nan")
    run_active = rl.active_params(run_cfg, model)
    bf16 = run_cfg.dtype == "bfloat16"
    row = rl.analyze(
        arch=arch, shape=shape.name, flops=counts["flops"],
        nbytes=counts["bytes"], peak_bytes=peak,
        argument_bytes=argument_bytes if cuda else float("nan"),
        output_bytes=0, step_s=statistics.median(times),
        model_flops=rl.model_flops_for(run_cfg, shape.kind, shape.seq_len,
                                       batch, run_active),
        mesh_name=f"1x{dev.type}",
        peak_flops=rl.PEAK_FLOPS_BF16 if bf16 else rl.PEAK_FLOPS_FP32)
    d = row.to_dict()
    d.update({"kind": shape.kind, "batch": batch,
              "ref_batch": shape.global_batch, "microbatch": cell.microbatch,
              "reps": run_cfg.reps, "ref_reps": cfg.reps, "reduced": cuts,
              "warm_s": warm_s, "steps_s": times,
              "total_s": time.monotonic() - t0, "n_params": n_total,
              "n_active": n_active, "run_params": rl.count_params(model),
              "run_active": run_active,
              "peak_flops": row.peak_flops,
              "device": (torch.cuda.get_device_name(dev) if cuda
                         else "cpu"), "probe": probe,
              "rep_probe": rep_probe})
    if verbose:
        mem = d["mem_per_device"]
        print(f"[dryrun] {arch} x {shape.name} batch {batch} microbatch "
              f"{cell.microbatch} reps {run_cfg.reps}/{cfg.reps} (cuts: "
              f"{', '.join(cuts) or 'none'}) on {d['device']}: step "
              f"{d['step_s'] * 1e3:.1f} ms (warm {warm_s:.1f} s) | peak "
              f"{mem['peak_mb'] / 1024:.2f} GiB | flops "
              f"{d['hlo_flops_per_chip']:.3e} | bytes "
              f"{d['hlo_bytes_per_chip']:.3e} | bound={d['bottleneck']} "
              f"{d['bound_fraction'] * 100:.1f}% of the step | useful "
              f"{d['usefulness'] * 100:.0f}%", flush=True)
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help=f"one of {sorted(configs.ARCHS)} or "
                         f"{sorted(PNN_VARIANTS)}")
    ap.add_argument("--shape", default=None,
                    help=f"one of {sorted(SHAPES)} or {sorted(PNN_SHAPES)}")
    ap.add_argument("--all", action="store_true",
                    help="the 10 x 4 LM cells, then the three PNN variants "
                         "at pnn_289k")
    ap.add_argument("--train", action="store_true",
                    help="PNN cells: run the fine-tune step (gradient "
                         "through the point ops + AdamW) instead of the "
                         "serving step")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in configs.ARCHS for shape in SHAPES]
        cells += [(variant, "pnn_289k") for variant in PNN_VARIANTS]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    for arch, shape in cells:
        if arch in PNN_VARIANTS:
            if shape not in PNN_SHAPES:
                raise ValueError(f"--shape {shape!r}: have "
                                 f"{sorted(PNN_SHAPES)}")
        elif arch not in configs.ARCHS:
            raise ValueError(f"--arch {arch!r}: have {sorted(configs.ARCHS)}"
                             f" and {sorted(PNN_VARIANTS)}")
        elif shape not in SHAPES:
            raise ValueError(f"--shape {shape!r}: have {sorted(SHAPES)}")

    rows = []
    for arch, shape in cells:
        if arch in PNN_VARIANTS:
            rows.append(run_pnn_cell(arch, shape, batch=args.batch,
                                     kind="train" if args.train else "serve",
                                     device=args.device))
        else:
            try:
                rows.append(run_cell(arch, shape, batch=args.batch,
                                     device=args.device))
            except DoesNotFit as e:   # recorded, as ``applicable``'s skips
                if not args.all:
                    raise
                rows.append({"arch": arch, "shape": shape,
                             "mesh": "1xcuda", "skipped": str(e)})
        if args.out:  # incremental: a failed cell keeps the rows before it
            with open(args.out, "w") as f:
                json.dump({"rows": rows}, f, indent=1)
        torch.cuda.empty_cache()
    print(rl.format_table([r for r in rows if "skipped" not in r]))
    for r in rows:
        if "skipped" in r:
            print(f"[skip] {r['arch']} x {r['shape']}: {r['skipped']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
