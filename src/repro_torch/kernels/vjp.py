"""Gradient rules of the point ops, as ``torch.autograd.Function``s.

Counterpart of ``repro.kernels.vjp``.  Only the ops that move features
carry a useful gradient:

* ``Gathering``: ``gather_blocks`` differentiates in ``window_feats``; its
  backward scatter-adds the output's gradient rows back into the window
  tile (``scatter_add_blocks``: the CUDA kernel for a CUDA gradient, the
  plain version for a CPU one).  Rows whose index lay outside [0, W)
  fetched zeros, so they receive nothing.
* ``IndexProducer``: FPS, ball query and kNN return indices, counts and
  distances that depend on coordinates only, never on parameters.  Every
  output is marked non-differentiable, so no gradient reaches any input
  (the JAX package's zero cotangents).

Both take already-specialised callables, so this module knows nothing of
the dispatch layer (``kernels/ops.py`` wires them).
"""
from __future__ import annotations

import torch


class IndexProducer(torch.autograd.Function):
    """``IndexProducer.apply(fn, *args)``: ``fn(*args)``, with every output
    non-differentiable."""

    @staticmethod
    def forward(ctx, fn, *args):
        out = fn(*args)
        ctx.mark_non_differentiable(*(out if isinstance(out, tuple)
                                      else (out,)))
        ctx.n_args = len(args)
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * (1 + ctx.n_args)


class Gathering(torch.autograd.Function):
    """``Gathering.apply(fwd_fn, bwd_fn, window_feats, idx)``:
    ``fwd_fn(window_feats, idx) -> (NB, M, C)`` forward, and
    ``bwd_fn(g, idx, w=W) -> (NB, W, C)`` for the gradient of
    ``window_feats``; ``idx`` gets none."""

    @staticmethod
    def forward(ctx, fwd_fn, bwd_fn, window_feats, idx):
        ctx.save_for_backward(idx)
        ctx.bwd_fn = bwd_fn
        ctx.w = window_feats.shape[1]
        return fwd_fn(window_feats, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, None, ctx.bwd_fn(g.contiguous(), idx, w=ctx.w), None
