"""Config registry: the ten LM architectures + the paper's PNN configs.

Counterpart of ``repro.configs``; each config is the reference's,
verbatim.

``get(arch_id)`` returns the module (with ``config()`` / ``reduced()``);
``lm_config(arch_id)`` / ``lm_reduced(arch_id)`` return LMConfig instances.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable

ARCHS = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "zamba2-7b": "zamba2_7b",
    "minitron-4b": "minitron_4b",
    "smollm-135m": "smollm_135m",
    "gemma2-2b": "gemma2_2b",
    "gemma3-12b": "gemma3_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "chameleon-34b": "chameleon_34b",
    "xlstm-1.3b": "xlstm_1_3b",
}

PNN_ARCHS = ("pointnet2", "pointnext", "pointvector")


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")


def lm_config(arch_id: str, **kw):
    return get(arch_id).config(**kw)


def lm_reduced(arch_id: str, **kw):
    return get(arch_id).reduced(**kw)


__all__ = ["ARCHS", "PNN_ARCHS", "SHAPES", "ShapeSpec", "applicable",
           "get", "lm_config", "lm_reduced"]
