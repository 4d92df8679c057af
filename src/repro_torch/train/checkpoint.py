"""Step-scoped, atomic, optionally asynchronous checkpoints.

Counterpart of ``repro.train.checkpoint``, with its file layout:
``<dir>/step_%08d/arrays.npz`` plus ``manifest.json`` (step, time, the
caller's ``extra`` such as the data cursor, the keys), written into a
``.tmp-<step>`` directory that is renamed into place, and garbage
collection that keeps the last ``keep`` steps.

Arrays are keyed by their ``/``-joined tree path, in the JAX tree's form:
a dict key or a list position is one part, so the port's training state
``{"params": {"stages/0/mlp/0/dense/w": ...}, "opt": {"m": ..., "v": ...,
"step": ...}}`` writes ``params/stages/0/mlp/0/dense/w``, ``opt/m/...``,
``opt/v/...`` and ``opt/step``, exactly the keys the JAX trainer writes.
A checkpoint of either package restores into the other.  Where the JAX
tree stacks several of the port's tensors into one leaf (an LM's layers,
reps first), the caller's tree holds them as one ``Stacked`` leaf: saved
as the stacked array, restored slice by slice (``lm/steps.ckpt_tree``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_SEP = "/"


class Stacked:
    """One checkpoint leaf made of several tensors of one shape: the JAX
    tree's stacked leaf, whose slices along its first axis are ``parts``."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self):
        return (len(self.parts),) + tuple(self.parts[0].shape)


def _leaves(tree, prefix=()):
    """Yield (key, leaf) in tree order; a dict key or list position is one
    part of the key."""
    if isinstance(tree, dict):
        for k, sub in tree.items():
            yield from _leaves(sub, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Stacked):
        return np.stack([_to_numpy(p) for p in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # npz has no bf16: store f32
            leaf = leaf.float()
        return leaf.numpy().copy()
    a = np.asarray(leaf)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        a = a.astype(np.int32)
    return a


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """Synchronous save (see ``AsyncCheckpointer`` for the async one)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: _to_numpy(v) for k, v in _leaves(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    # Manifest times are read by other processes (restore tooling, age
    # based clean-up), so the wall clock is the right domain.
    manifest = {"step": step, "time": time.time(),  # repolint: disable=CLK003
                "extra": extra or {}, "keys": sorted(arrays)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir, keep):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(arr: np.ndarray, like):
    """``arr`` as the kind of leaf ``like`` is: a tensor of its dtype on its
    device, a ``Stacked`` of such tensors, or a Python scalar (the
    optimizer's step)."""
    if isinstance(like, Stacked):
        return Stacked(_like(a, p) for a, p in zip(arr, like.parts))
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
    return type(like)(arr)


def _rebuild(like, flat, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(sub, flat, prefix + (str(k),))
                for k, sub in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, flat, prefix + (str(i),))
                          for i, sub in enumerate(like))
    key = _SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    want = like.shape if isinstance(like, Stacked) else np.shape(like)
    if tuple(arr.shape) != tuple(want):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                         f"{tuple(want)}")
    return _like(arr, like)


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf comes back as
    the kind, dtype and device of the leaf it replaces.  Returns (tree,
    manifest); raises on a missing key or a shape that differs."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return _rebuild(like_tree, flat), manifest


@torch.no_grad()
def assign(dst, src) -> None:
    """Copy the tensors of ``src`` into the tensors of ``dst``, a tree of
    the same structure, in place; leaves that are no tensors are left."""
    if isinstance(dst, dict):
        for k, sub in dst.items():
            assign(sub, src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            assign(a, b)
    elif isinstance(dst, Stacked):
        assign(dst.parts, src.parts)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


class AsyncCheckpointer:
    """Saves on a background thread, so training does not wait on the disk;
    ``wait()`` drains before exit.  The arrays are copied to the host
    before the hand-off, so later in-place updates cannot reach them."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread = None
        self.last_saved = None

    def save(self, step: int, tree, extra=None):
        host = {k: _to_numpy(v) for k, v in _leaves(tree)}
        self.wait()
        self._thread = threading.Thread(
            target=self._run, args=(step, host, extra), daemon=True)
        self._thread.start()

    def _run(self, step, flat, extra):
        save(self.ckpt_dir, step, flat, extra, keep=self.keep)
        self.last_saved = step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
