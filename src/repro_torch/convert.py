"""Carry weights of the JAX package's PNN and LM over to the port's modules.

The JAX parameters are a tree of dicts and lists (``repro.models.pnn.init``)
whose leaves are arrays; pass it with its leaves converted to numpy (e.g.
``jax.tree.map(np.asarray, params)``).  The port's modules mirror the tree:
a dict key is an attribute, a list position is a ``ModuleList`` index, and
a leaf (``w``, ``b``, ``g``) is a parameter of the same shape.  Dense
weights stay ``(din, dout)``, used as ``x @ w``: nothing is transposed.

An LM tree (``repro.lm.model.init``) stacks each pattern position's layer
parameters over reps (``scan`` / ``enc_scan``); ``lm_from_jax`` splits
that leading axis into the port's per-layer blocks.  A shared position's
block (``shared``, zamba2's attention) is one unstacked subtree, copied
into the one block every rep uses.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.lm import model as lm_model
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


def _flatten(tree, path=()) -> dict:
    """{path tuple: leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, path + (key,)))
        return out
    return {path: tree}


def lm_from_jax(params, cfg: lm_model.LMConfig,
                device: str | torch.device = "cpu") -> lm_model.LM:
    """An ``LM`` for ``cfg`` holding the JAX parameter tree ``params``
    (leaves as numpy).  A stacked leaf fills one block a rep, a shared
    leaf its one block.  Raises if a leaf is missing, left over or of
    another shape (for a stacked leaf: reps, then the block parameter's
    shape)."""
    model, _ = lm_model.init(cfg, device=device)
    leaves = _flatten(params)
    want = lm_model.reference_leaves(cfg, model)
    extra = sorted("/".join(p) for p in set(leaves) - set(want))
    missing = sorted("/".join(p) for p in set(want) - set(leaves))
    if extra or missing:
        raise ValueError(f"LM tree vs module: not in the module {extra}, "
                         f"not in the JAX tree {missing}")
    for path, targets in want.items():
        arr = np.array(leaves[path], dtype=np.float32)
        stacked = path[0] in lm_model.STACKS
        shape = tuple(targets[0].shape)
        expect = (len(targets),) + shape if stacked else shape
        if arr.shape != expect:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} vs "
                             f"{expect}")
        with torch.no_grad():
            for i, t in enumerate(targets):
                src = torch.from_numpy(arr[i] if stacked else arr)
                t.copy_(src.to(t.dtype))
    return model
