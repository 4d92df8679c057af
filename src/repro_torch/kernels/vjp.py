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
* ``Blending``: ``interp_blend`` writes the FP stage's blended rows into
  ``out`` in place and differentiates in ``vals`` alone:
  ``g_vals[nb, 3j + k] = wgt[nb, j, k] * g_out[b, leaf_start[nb] + j]`` on
  an occupied lane, 0 on a padded one (the former multiply-and-sum's
  products, bit for bit).  The weights come from the kNN's distances, an
  index producer's output, and need none; the rows the call overwrote pass
  no gradient back to what ``out`` held.  Plain PyTorch on both devices.

Both take already-specialised callables, so this module knows nothing of
the dispatch layer (``kernels/ops.py`` wires them).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interp_blend import occupied_rows


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


class Blending(torch.autograd.Function):
    """``Blending.apply(fn, out, vals, wgt, leaf_start, count)``: ``fn`` (the
    kernel or its plain version) writes the blended rows into ``out`` (B, R,
    C) in place, and ``out`` is returned; ``vals`` (NB, bs * 3, C) gets the
    gradient."""

    @staticmethod
    def forward(ctx, fn, out, vals, wgt, leaf_start, count):
        fn(out, vals, wgt, leaf_start, count)
        ctx.mark_dirty(out)
        ctx.save_for_backward(wgt, leaf_start, count)
        return out

    @staticmethod
    def backward(ctx, g):
        wgt, leaf_start, count = ctx.saved_tensors
        b, r, c = g.shape
        nb, bs = wgt.shape[:2]
        row, keep = occupied_rows(r, leaf_start, count, bs)
        cloud = (torch.arange(nb, device=g.device)
                 // (nb // b))[:, None].expand(nb, bs)
        g_rows = torch.where(keep[..., None], g[cloud, row.clamp(0, r - 1)],
                             0.0)
        g_vals = (g_rows[:, :, None, :] * wgt[..., None]).reshape(
            nb, bs * 3, c)
        g_out = None
        if ctx.needs_input_grad[1]:
            g_out = g.index_put((cloud[keep], row[keep]), g.new_zeros(()))
        return None, g_out, g_vals, None, None, None
