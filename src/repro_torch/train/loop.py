"""Fault-tolerant training loop: checkpoint/restart, straggler monitoring,
resumable data, optional gradient compression with error feedback.

Counterpart of ``repro.train.loop``.  ``params`` is a dict {name: tensor}
that the step updates in place (``optimizer.update``); a restored
checkpoint is copied into those same tensors, so a model whose parameters
they are sees it.  With ``grad_compression`` set, each step's gradients go
through ``repro_torch.dist.compression``'s error feedback (keyed by
``(seed, step)``) before AdamW, as the reference does on any number of
devices; the residual is not checkpointed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.dist import compression
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.monitor import StepMonitor


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    grad_compression: str = "none"   # none | bf16 | int8
    seed: int = 0


@torch.no_grad()
def _assign(dst: dict, src: dict) -> None:
    for k, t in dst.items():
        t.copy_(src[k])


def run(loop_cfg: LoopConfig, *, init_params: Callable,
        train_step: Callable, next_batch: Callable, opt_cfg=None,
        params=None, log: Callable = print, fail_at: int | None = None):
    """Restore the latest checkpoint if there is one, train to
    ``total_steps``, checkpoint asynchronously, record stragglers.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``metrics["loss"]`` a scalar tensor, and, when
    ``grad_compression`` is set, ``train_step(params, opt_state, batch,
    return_grads=True) -> (grads, metrics)``; ``fail_at`` injects a crash
    (fault-tolerance tests).  Each step is timed up to the read of its
    loss, which waits for everything the step queued on the card.  Returns
    (params, opt_state, {"history", "monitor"})."""
    opt_cfg = opt_cfg or opt_lib.OptConfig(total_steps=loop_cfg.total_steps)
    if params is None:
        params = init_params()
    opt_state = opt_lib.init(params)
    start_step = 0
    saver = (ckpt_lib.AsyncCheckpointer(loop_cfg.ckpt_dir, loop_cfg.keep)
             if loop_cfg.ckpt_dir else None)
    residual = (compression.init_residual(params)
                if loop_cfg.grad_compression != "none" else None)

    if saver and (last := ckpt_lib.latest_step(loop_cfg.ckpt_dir)) is not None:
        state, manifest = ckpt_lib.restore(
            loop_cfg.ckpt_dir, last, {"params": params, "opt": opt_state})
        _assign(params, state["params"])
        _assign(opt_state["m"], state["opt"]["m"])
        _assign(opt_state["v"], state["opt"]["v"])
        opt_state["step"] = state["opt"]["step"]
        start_step = manifest["extra"].get("next_step", last)
        log(f"[loop] restored step {last}, resuming at {start_step}")

    monitor = StepMonitor()
    history = []
    for step in range(start_step, loop_cfg.total_steps):
        if fail_at is not None and step == fail_at:
            if saver:
                saver.wait()
            raise RuntimeError(f"injected failure at step {step}")
        batch = next_batch(step)
        t0 = time.monotonic()
        if residual is not None:
            grads, metrics = train_step(params, opt_state, batch,
                                        return_grads=True)
            grads, residual = compression.apply_error_feedback(
                grads, residual, loop_cfg.grad_compression,
                (loop_cfg.seed, step))
            params, opt_state, om = opt_lib.update(opt_cfg, grads,
                                                   opt_state, params)
            metrics = {**metrics, **om}
        else:
            params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        straggler = monitor.record(step, dt)
        history.append({"step": step, "dt": dt, "loss": loss,
                        "straggler": straggler})
        if step % loop_cfg.log_every == 0:
            log(f"[loop] step {step} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms{' STRAGGLER' if straggler else ''})")
        if saver and step and step % loop_cfg.ckpt_every == 0:
            saver.save(step, {"params": params, "opt": opt_state},
                       extra={"next_step": step + 1})
    if saver:
        saver.save(loop_cfg.total_steps,
                   {"params": params, "opt": opt_state},
                   extra={"next_step": loop_cfg.total_steps})
        saver.wait()
    return params, opt_state, {"history": history,
                               "monitor": monitor.summary()}
