"""AdamW with a warmup + cosine schedule and global-norm clipping.

Counterpart of ``repro.train.optimizer``, written as a short update over a
dict of tensors rather than ``torch.optim.AdamW``, so that it follows the
JAX package step for step: ``b2 = 0.95``; the schedule is read at the
1-based step; the clip scale is ``min(1, clip / (norm + 1e-9))``; decoupled
weight decay applies only to parameters with ``ndim >= 2``.  The state is
``{"m": {name: tensor}, "v": {name: tensor}, "step": int}``, the JAX
state's ``{"m", "v", "step"}`` with the parameter tree flattened to
``/``-joined paths, so checkpoints of the two packages line up.

Unlike the JAX update, which is pure, ``update`` changes the parameters
and the moments in place: training holds one copy of each.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: int) -> float:
    """Learning rate at the 1-based ``step``: linear warmup, then cosine
    decay to ``min_lr_frac * lr`` at ``total_steps``."""
    warm = min(step / max(cfg.warmup, 1), 1.0)
    t = min(max((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                0.0), 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + math.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params: dict) -> dict:
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tensors))


@torch.no_grad()
def update(cfg: OptConfig, grads: dict, opt_state: dict, params: dict):
    """One AdamW step over ``params`` ({name: tensor}) with ``grads`` of the
    same names, in place.  Returns ``(params, opt_state, {"lr",
    "grad_norm"})``; the norm stays on the device (no host sync)."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c1 = 1 - cfg.b1 ** step
    c2 = 1 - cfg.b2 ** step
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(g * g, alpha=1 - cfg.b2)
        delta = (m / c1) / ((v / c2).sqrt() + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
