"""LM-substrate smoke run: pretrain a reduced assigned-arch config on a
synthetic token stream with the full fault-tolerant loop (checkpoint/
restart, straggler monitor, optional gradient compression).

Counterpart of ``examples/lm_pretrain_smoke.py``.  The stream's tokens
come from a CPU ``torch.Generator`` seeded by ``(42, step)``, labels
``(token * 7 + position) % vocab``; the weights from seed 0.  A rerun
with the same ``--ckpt`` resumes at the checkpoint's step (at or past
``--steps``: nothing left to train).  It runs on the card unless asked
for the CPU::

  PYTHONPATH=src python -m repro_torch.examples.lm_pretrain_smoke \\
      [--arch smollm-135m] [--steps 60] [--compression int8] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.train import draw_batch
from repro_torch.lm import model as M
from repro_torch.lm import steps as steps_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib

STREAM_SEED = 42
CKPT_EVERY, LOG_EVERY = 20, 10


def stream(cfg, batch: int, seq: int, device=None):
    """``next_batch(step)``: the synthetic structured stream, next token =
    (token * 7 + position) % vocab."""
    def next_batch(step):
        gen = torch.Generator().manual_seed((STREAM_SEED << 32) + step)
        return draw_batch(cfg, gen, batch, seq, device)
    return next_batch


def run(cfg, model, *, steps: int, next_batch, ckpt: str = "",
        compression: str = "none", log=print) -> dict:
    """Train ``model`` (in place) to ``steps`` steps of ``next_batch`` under
    ``loop.run``; returns the printed numbers and every step's loss."""
    opt_cfg = opt_lib.OptConfig(lr=1e-3, warmup=10, total_steps=steps)
    step = steps_lib.make_train_step(model, cfg, opt_cfg)

    def train_step(params, opt_state, batch, return_grads=False):
        if return_grads:
            # The reference reports the total (loss + aux) on this path.
            g, m = step(params, opt_state, batch, return_grads=True)
            return g, {"loss": m["loss"] + m["aux"]}
        return step(params, opt_state, batch)

    resumed = ckpt_lib.latest_step(ckpt) if ckpt else None
    loop_cfg = loop_lib.LoopConfig(
        total_steps=steps, ckpt_dir=ckpt, ckpt_every=CKPT_EVERY,
        log_every=LOG_EVERY, grad_compression=compression)
    _, _, info = loop_lib.run(
        loop_cfg, init_params=lambda: steps_lib.param_dict(model),
        train_step=train_step, next_batch=next_batch, opt_cfg=opt_cfg,
        log=log, ckpt_tree=steps_lib.ckpt_tree(cfg, model),
        decay=steps_lib.decay_names(cfg, model))
    h = info["history"]
    losses = [r["loss"] for r in h]
    if h:
        log(f"[{cfg.name}] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
            f"{len(h)} steps; monitor={info['monitor']}")
    else:
        log(f"[{cfg.name}] nothing to train: checkpoint step {resumed} is at "
            f"or past {steps} steps")
    return {"arch": cfg.name, "resumed_from": resumed,
            "start_step": h[0]["step"] if h else steps, "steps_run": len(h),
            "losses": losses, "monitor": info["monitor"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_lm_ckpt"))
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.lm_reduced(args.arch)
    model, _ = M.init(cfg, torch.Generator().manual_seed(0), device=device)
    return run(cfg, model, steps=args.steps,
               next_batch=stream(cfg, args.batch, args.seq, device),
               ckpt=args.ckpt, compression=args.compression)


if __name__ == "__main__":
    main()
