"""Where the port runs: one rule for every entry point (serving, training).

``None`` means the card, and raises where there is none; the CPU, where
each kernel's plain version runs, is asked for explicitly with ``"cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card, raising if there is none; else the given
    device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
