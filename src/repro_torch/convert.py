"""Carry weights of the JAX package's PNN over to the port's modules.

The JAX parameters are a tree of dicts and lists (``repro.models.pnn.init``)
whose leaves are arrays; pass it with its leaves converted to numpy (e.g.
``jax.tree.map(np.asarray, params)``).  The port's modules mirror the tree:
a dict key is an attribute, a list position is a ``ModuleList`` index, and
a leaf (``w``, ``b``, ``g``) is a parameter of the same shape.  Dense
weights stay ``(din, dout)``, used as ``x @ w``: nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import pnn


def _load(module, tree, path: str, seen: set) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _load(getattr(module, key), sub, f"{path}.{key}", seen)
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{path}: {len(tree)} entries in the JAX tree, "
                             f"{len(module)} in the module")
        for i, sub in enumerate(tree):
            _load(module[i], sub, f"{path}[{i}]", seen)
    else:
        if not isinstance(module, nn.Parameter):
            raise TypeError(f"{path}: leaf lands on {type(module).__name__}")
        arr = np.array(tree, dtype=np.float32)
        if tuple(arr.shape) != tuple(module.shape):
            raise ValueError(f"{path}: shape {arr.shape} vs "
                             f"{tuple(module.shape)}")
        with torch.no_grad():
            module.copy_(torch.from_numpy(arr))
        seen.add(id(module))


def from_jax(params, cfg: pnn.PNNConfig,
             device: str | torch.device = "cpu") -> pnn.PNN:
    """A ``PNN`` for ``cfg`` holding the JAX parameter tree ``params``.
    Raises if the tree and the module differ in any name, length or shape,
    or if a module parameter is left unset."""
    model = pnn.init(cfg)
    seen: set = set()
    _load(model, params, "params", seen)
    missing = [n for n, p in model.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"parameters not in the JAX tree: {missing}")
    return model.to(device)
