"""End to end: train a PointNet++ classifier on synthetic shapes with
FractalCloud block-parallel point ops, with checkpoint/restart + straggler
monitoring (the full training substrate).

Counterpart of ``examples/train_pointnet.py``.  Compare the final accuracy
across ``--point-ops`` to reproduce the paper's accuracy-preservation claim
(Fig. 14) at laptop scale.  The step is ``train.pnn``'s (its loss for a
classifier is the example's unmasked mean cross-entropy) under AdamW with
the example's schedule.  It runs on the card unless asked for the CPU::

  PYTHONPATH=src python -m repro_torch.examples.train_pointnet \\
      [--steps 300] [--point-ops bppo|global] [--ckpt DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import pnn
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import pnn as train_pnn
from repro_torch.train.monitor import StepMonitor

LR, WARMUP, WEIGHT_DECAY = 2e-3, 20, 1e-4
EVAL_EVERY, EVAL_BATCHES, FINAL_EVAL_BATCHES = 25, 4, 8
CKPT_EVERY = 100


@torch.no_grad()
def accuracy(model: pnn.PNN, mcfg: pnn.PNNConfig, pts, labels) -> float:
    logits = pnn.apply(model, mcfg, pts)
    return float((logits.argmax(-1) == labels).float().mean())


def train(model: pnn.PNN, mcfg: pnn.PNNConfig, *, steps: int, next_batch,
          eval_batch, ckpt: str = "", log=print) -> dict:
    """Train ``model`` (in place) to ``steps`` steps on ``next_batch(step)
    -> (points, labels)``, evaluating on ``eval_batch(i) -> (points,
    labels)``: ``EVAL_BATCHES`` of them every ``EVAL_EVERY`` steps,
    ``FINAL_EVAL_BATCHES`` at the end.  With ``ckpt`` it resumes at the
    latest checkpoint's ``next_step`` and saves every ``CKPT_EVERY`` steps
    and at the end.  Returns the printed numbers and every step's loss."""
    params = train_pnn.param_dict(model)
    opt_cfg = opt_lib.OptConfig(lr=LR, warmup=WARMUP, total_steps=steps,
                                weight_decay=WEIGHT_DECAY)
    opt_state = opt_lib.init(params)
    start, resumed = 0, None
    saver = ckpt_lib.AsyncCheckpointer(ckpt) if ckpt else None
    if saver and (last := ckpt_lib.latest_step(ckpt)) is not None:
        live = {"params": params, "opt": opt_state}
        state, manifest = ckpt_lib.restore(ckpt, last, live)
        ckpt_lib.assign(live, state)
        opt_state["step"] = state["opt"]["step"]
        start, resumed = manifest["extra"]["next_step"], last
        log(f"resumed from step {last}")
    step_fn = train_pnn.make_train_step(model, mcfg, opt_cfg)

    def eval_acc(batches):
        return float(np.mean([accuracy(model, mcfg, *eval_batch(s))
                              for s in range(batches)]))

    monitor = StepMonitor()
    losses, logged = [], []
    for step in range(start, steps):
        pts, labels = next_batch(step)
        t0 = time.monotonic()
        params, opt_state, metrics = step_fn(
            params, opt_state, {"points": pts, "labels": labels})
        loss = float(metrics["loss"])      # waits for the step
        straggler = monitor.record(step, time.monotonic() - t0)
        losses.append(loss)
        if step % EVAL_EVERY == 0:
            acc = eval_acc(EVAL_BATCHES)
            logged.append({"step": step, "loss": loss, "eval_acc": acc})
            log(f"step {step:4d} loss {loss:.4f} eval_acc {acc:.3f}"
                f"{' [straggler]' if straggler else ''}")
        if saver and step and step % CKPT_EVERY == 0:
            saver.save(step, {"params": params, "opt": opt_state},
                       extra={"next_step": step + 1})

    acc = eval_acc(FINAL_EVAL_BATCHES)
    summary = monitor.summary()
    log(f"FINAL [{mcfg.point_ops}] accuracy: {acc:.3f} ({summary})")
    if saver:
        saver.save(steps, {"params": params, "opt": opt_state},
                   extra={"next_step": steps})
        saver.wait()
    return {"point_ops": mcfg.point_ops, "start_step": start,
            "resumed_from": resumed, "steps": steps, "losses": losses,
            "logged": logged, "final_accuracy": acc, "monitor": summary}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-points", type=int, default=512)
    ap.add_argument("--point-ops", default="bppo",
                    choices=["bppo", "global"])
    ap.add_argument("--th", type=int, default=64)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> pnn.PNNConfig:
    return pnn.pointnet2_cls(n=args.n_points, point_ops=args.point_ops,
                             th=args.th)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    mcfg = config(args)
    model = pnn.init(mcfg, torch.Generator().manual_seed(args.seed)).to(
        device)

    def batch_of(seed):
        return lambda step: synthetic.classification_batch(
            seed, step, args.batch, args.n_points, device=device)

    return train(model, mcfg, steps=args.steps,
                 next_batch=batch_of(args.seed),
                 eval_batch=batch_of(args.seed + 999), ckpt=args.ckpt)


if __name__ == "__main__":
    main()
