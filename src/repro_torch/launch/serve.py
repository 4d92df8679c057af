"""LM serving launcher: batched greedy decoding on one card.

Counterpart of ``repro.launch.serve``: the reduced config of an
architecture with weights drawn from ``--seed``, prefill of a random
prompt batch, then the greedy decode loop over the KV caches, all under
the elastic mesh's logical rules.  It runs on the card unless asked for
the CPU::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 2 --prompt-len 16 --max-new 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.dist import elastic, logical
from repro_torch.lm import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg, tokens, max_new: int, mesh, *, max_len=None,
             on_step=None):
    """Greedy decoding under the mesh's logical rules: prefill ``tokens``
    (B, S) into caches for ``max_len`` positions (default S + max_new),
    then ``max_new`` steps.  ``on_step(logits)``, when given, is called
    with the prefill's last logits and then with each step's (it may sync
    the device to time the step).  Returns (generated ids (B, max_new),
    the last logits, the cache, prefill s, decode s)."""
    device = tokens.device
    s = tokens.shape[1]
    with logical.logical_rules(mesh, logical.RULES_V0):
        _sync(device)
        t0 = time.monotonic()
        logits, cache = M.prefill(model, cfg, tokens=tokens,
                                  max_len=max_len or s + max_new)
        _sync(device)
        t_prefill = time.monotonic() - t0
        if on_step is not None:
            on_step(logits)
        out = []
        nxt = torch.argmax(logits, -1)
        t0 = time.monotonic()
        for i in range(max_new):
            out.append(nxt)
            logits, cache = M.decode_step(model, cfg, nxt, cache, s + i)
            nxt = torch.argmax(logits, -1)
            if on_step is not None:
                on_step(logits)
        _sync(device)
        t_decode = time.monotonic() - t0
    return torch.cat(out, dim=1), logits, cache, t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(configs.ARCHS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = configs.lm_reduced(args.arch)
    if cfg.encoder_layers:
        raise SystemExit("enc-dec serving demo: this launcher serves "
                         "decoder-only architectures")
    device = resolve_device(args.device)
    mesh = elastic.make_mesh(devices=[device])
    model, _ = M.init(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                         generator=torch.Generator().manual_seed(1))
    gen, _, _, t_prefill, t_decode = generate(model, cfg, toks.to(device),
                                              args.max_new, mesh)
    print(f"[serve] {cfg.name} on {device}, {mesh}: prefill "
          f"{args.prompt_len} toks in {t_prefill*1e3:.0f} ms; "
          f"{args.max_new} decode steps in {t_decode*1e3:.0f} ms "
          f"({args.max_new * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"[serve] generated ids: {gen.tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
