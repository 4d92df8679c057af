"""LM training launcher on one card.

Counterpart of ``repro.launch.train``: an architecture's reduced config
(or its full one), weights drawn from ``--seed``, the train step of
``lm/steps.py`` (AdamW, ``--microbatch`` gradient accumulation) under the
one-card mesh's logical rules, and the fault-tolerant loop of
``train/loop.py`` (checkpoint and restart, straggler monitor, optional
gradient compression with error feedback).  Batches are a pure function
of ``(seed, step)``, drawn on the host and then moved, so a restart
replays the stream and the card trains on the CPU's tokens.  Checkpoints
have the reference's layout (stacked ``params/scan/...``) and restore
across the two packages.  ``--model-axis`` has no counterpart: it cannot
change a (1, 1) mesh.  It runs on the card unless asked for the CPU::

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --steps 3 --batch 2 --seq 32 --device cpu [--ckpt DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --full-config --seq 4096 --batch 8 --microbatch 8 --steps 20

  # resume after a crash: rerun the same command (restores latest step)
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.dist import elastic, logical
from repro_torch.lm import model as M
from repro_torch.lm import steps as steps_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib


def make_batch(cfg, seed: int, step: int, batch: int, seq: int,
               device=None) -> dict:
    """The batch of ``step``: ``draw_batch`` from a CPU generator seeded by
    ``(seed + 7, step)``, moved to ``device``."""
    gen = torch.Generator().manual_seed(((seed + 7) << 32) + step)
    return draw_batch(cfg, gen, batch, seq, device)


def draw_batch(cfg, gen: torch.Generator, batch: int, seq: int,
               device=None) -> dict:
    """Tokens uniform over the vocabulary drawn from ``gen``, labels
    ``(tokens * 7 + position) % vocab`` (the reference's rule), ``frames``
    (normal, x 0.1) for an encoder-decoder or the embeddings frontend;
    moved to ``device``."""
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen)
    out = {"labels": (toks * 7 + torch.arange(seq)[None, :]) % cfg.vocab}
    if cfg.encoder_layers or cfg.frontend == "embeddings":
        out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                    generator=gen) * 0.1
        if cfg.encoder_layers:
            out["dec_tokens"] = toks
    else:
        out["tokens"] = toks
    return {k: v.to(device) for k, v in out.items()}


def main(argv=None, log=print):
    """Train as the flags say.  Returns the loop's info ({"history",
    "monitor"}) and what it trained: "cfg", "model", "params",
    "opt_state", "train_step" and "next_batch", so a caller can count or
    profile a further step of the same run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(configs.ARCHS))
    ap.add_argument("--full-config", action="store_true",
                    help="use the full config instead of the reduced one")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.lm_config(args.arch) if args.full_config
           else configs.lm_reduced(args.arch))
    mesh = elastic.make_mesh(devices=[device])
    log(f"[train] {mesh}, arch {cfg.name}, on {device}")
    opt_cfg = opt_lib.OptConfig(lr=args.lr, warmup=min(10, args.steps // 5),
                                total_steps=args.steps)
    model, _ = M.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    step = steps_lib.make_train_step(model, cfg, opt_cfg,
                                     microbatch=args.microbatch)

    def train_step(params, opt_state, batch, return_grads=False):
        with logical.logical_rules(mesh, logical.RULES_V0):
            return step(params, opt_state, batch, return_grads=return_grads)

    loop_cfg = loop_lib.LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every, log_every=10,
        grad_compression=args.compression, seed=args.seed)
    def next_batch(s):
        return make_batch(cfg, args.seed, s, args.batch, args.seq, device)

    params, opt_state, info = loop_lib.run(
        loop_cfg, init_params=lambda: steps_lib.param_dict(model),
        train_step=train_step, next_batch=next_batch,
        opt_cfg=opt_cfg, log=log, ckpt_tree=steps_lib.ckpt_tree(cfg, model),
        decay=steps_lib.decay_names(cfg, model))
    h = info["history"]
    if h:
        log(f"[train] done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
            f"{info['monitor']}")
    else:
        log("[train] nothing to do: checkpoint already at "
            f"step >= {args.steps}")
    return {**info, "cfg": cfg, "model": model, "params": params,
            "opt_state": opt_state, "train_step": train_step,
            "next_batch": next_batch}


if __name__ == "__main__":
    main()
