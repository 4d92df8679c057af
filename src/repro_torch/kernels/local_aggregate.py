"""PointNeXt's InvResMLP local aggregation, pooled: a CUDA kernel and its
plain version.

No TPU kernel stands behind this one: the JAX package has no InvResMLP
block.  The block's local aggregation is ReLU(BN(W [rel_ij ; f_j])) over
each centre i's neighbour slots j, max-pooled over the valid ones.  With
BatchNorm folded into W and b, and W split into its offset rows ``w_r``
(3, C) and its feature rows W_f, the layer is ``rel_ij . w_r + g_j + b``
with ``g = f @ W_f`` (B, m, C) computed once a point, so neither the
grouped features nor their layer output is ever built.  The caller,
``models.pnn.InvResMLP``, computes g.

``local_aggregate`` launches ``csrc/local_aggregate.cu`` for CUDA tensors
and runs ``local_aggregate_plain`` for CPU ones; the two agree bit for bit
on the card, as every point kernel and its plain version do.  On the card
the op is inference-only: it has no backward, and raises if an input
would need one.  On the CPU the plain version differentiates through
PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import launching_on, on_card, require


def local_aggregate_plain(g, nidx, gmask, rel, w_r, bias):
    """g (B, m, C), nidx (B, m, ns) rows of g, gmask (B, m, ns), rel
    (B, m, ns, 3), w_r (3, C), bias (C,) -> (B, m, C): for each centre and
    channel the largest of 0 and, over its slots whose mask bit is set and
    whose index j lies in [0, m), ``(((rel0 * w_r[0] + rel1 * w_r[1]) +
    rel2 * w_r[2]) + g[j]) + bias``, each operation rounded on its own, a
    slot at a time.  A slot that is masked or out of range is never read."""
    m = g.shape[1]
    ok = gmask & (nidx >= 0) & (nidx < m)
    safe = torch.where(ok, nidx, 0).long()
    rows = torch.arange(g.shape[0], device=g.device)[:, None]
    out = g.new_zeros(g.shape)
    for s in range(nidx.shape[2]):
        r = rel[:, :, s, :, None]
        x = (r[:, :, 0] * w_r[0] + r[:, :, 1] * w_r[1]) + r[:, :, 2] * w_r[2]
        x = (x + g[rows, safe[:, :, s]]) + bias
        out = torch.maximum(out, torch.where(ok[:, :, s, None], x, 0.0))
    return out


def local_aggregate(g, nidx, gmask, rel, w_r, bias):
    """g (B, m, C) f32, nidx (B, m, ns) int32, gmask (B, m, ns) bool, rel
    (B, m, ns, 3) f32, w_r (3, C) f32, bias (C,) f32 -> (B, m, C) f32, the
    function of ``local_aggregate_plain``.

    On the card this launches ``csrc/local_aggregate.cu``; on the CPU it
    runs ``local_aggregate_plain``."""
    if not on_card(g, nidx, gmask, rel, w_r, bias):
        return local_aggregate_plain(g, nidx, gmask, rel, w_r, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (g, rel, w_r, bias)):
        raise RuntimeError(
            "local_aggregate on the card is inference-only and has no "
            "backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or on CPU tensors, whose plain "
            "version differentiates")
    b, m, c = g.shape
    ns = nidx.shape[2]
    require(g, "g", torch.float32, (b, m, c))
    require(nidx, "nidx", torch.int32, (b, m, ns))
    require(gmask, "gmask", torch.bool, (b, m, ns))
    require(rel, "rel", torch.float32, (b, m, ns, 3))
    require(w_r, "w_r", torch.float32, (3, c))
    require(bias, "bias", torch.float32, (c,))
    out = torch.empty((b, m, c), dtype=torch.float32, device=g.device)
    if b == 0 or m == 0 or c == 0:
        return out
    with launching_on(g) as stream:
        err = _build.library().fc_local_aggregate(
            g.data_ptr(), nidx.data_ptr(), gmask.data_ptr(), rel.data_ptr(),
            w_r.data_ptr(), bias.data_ptr(), out.data_ptr(), b, m, c, ns,
            stream)
    _build.check(err, "local_aggregate")
    local_aggregate.launches += 1
    return out


local_aggregate.launches = 0
