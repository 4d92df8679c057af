"""Point Transformer's vector attention over each point's neighbour slots:
a CUDA kernel and its plain version.

No TPU kernel stands behind this one: the JAX package has no Point
Transformer.  The layer (``models/point_transformer.py``) on C channels,
k neighbour slots and N = C / G weight channels (G = ``share_planes``),
with q, k and v computed once a point as one matrix product onto
``qkv`` = [q | k | v] (B, m, 3C), the BatchNorm on a_ij folded in as
q * s and k * s + t::

    h_ij     = ReLU(rel_ij @ p1w + p1b)                 (p1, BN folded)
    delta_ij = h_ij @ p2w + p2b
    a_ij     = ReLU(k_j - q_i + delta_ij * s)
    w_ij     = ReLU(a_ij @ w1w + w1b) @ w2w + w2b       (w1, BN folded)
    y_i[c]   = sum_j softmax_j(w_ij)[c mod N] * (v_j + delta_ij)[c]
    out_i    = ReLU(y_i * bn_scale + bn_shift)

The softmax runs over the valid slots only: those whose mask bit is set and
whose index lies in [0, m); a point with none gets y = 0, so its output is
ReLU(bn_shift).  A slot that is masked or out of range is never read.

``vector_attention`` launches ``csrc/vector_attention.cu`` for CUDA tensors
and runs ``vector_attention_plain`` for CPU ones.  The kernel sums in float32
FMAs in its own order (the C-long sums of w1 a channel at a time), so it
agrees with the plain version within a tolerance (``kernels/checks.py``),
not bit for bit.  On the card the op is inference-only: it has no backward,
and raises if an input would need one.  On the CPU the plain version
differentiates through PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import NEG, launching_on, on_card, require

WEIGHTS = ("p1w", "p1b", "p2w", "p2b", "s", "w1w", "w1b", "w2w", "w2b",
           "bn_scale", "bn_shift")
VECTORS = (0, 6, 7, 8, 13, 14)   # qkv, p2w, p2b, s, bn_scale, bn_shift


def vector_attention_plain(qkv, nidx, mask, rel, p1w, p1b, p2w, p2b, s, w1w,
                           w1b, w2w, w2b, bn_scale, bn_shift):
    """qkv (B, m, 3C), nidx (B, m, k) rows of qkv, mask (B, m, k), rel
    (B, m, k, 3), p1w (3, 3), p1b (3,), p2w (3, C), p2b (C,), s (C,), w1w
    (C, N), w1b (N,), w2w (N, N), w2b (N,), bn_scale (C,), bn_shift (C,) ->
    (B, m, C): the module docstring's function, as the attention layer's
    PyTorch sequence and the BatchNorm and ReLU after it computed it, with a
    masked or out-of-range slot's row taken from row 0 and weighted 0."""
    b, m, c3 = qkv.shape
    c, k, n = c3 // 3, nidx.shape[2], w2w.shape[0]
    ok = mask & (nidx >= 0) & (nidx < m)
    safe = torch.where(ok, nidx, 0).long()
    rows = torch.arange(b, device=qkv.device)[:, None]
    kv = qkv[rows, safe.reshape(b, -1), c:].view(b, m, k, 2 * c)
    h = torch.relu(torch.addmm(p1b, rel.reshape(-1, 3), p1w))
    delta = torch.addmm(p2b, h, p2w).view(b, m, k, c)
    a = torch.addcmul(kv[..., :c] - qkv[:, :, None, :c], delta, s).relu_()
    w = torch.addmm(w2b, torch.relu(torch.addmm(w1b, a.reshape(-1, c), w1w)),
                    w2w).view(b, m, k, n)
    w = torch.softmax(w.masked_fill(~ok[..., None], NEG), dim=2)
    w = w * ok[..., None]
    y = (kv[..., c:] + delta).view(b, m, k, c // n, n) * w[..., None, :]
    return torch.addcmul(bn_shift, y.sum(2).view(b, m, c), bn_scale).relu_()


def vector_attention(qkv, nidx, mask, rel, p1w, p1b, p2w, p2b, s, w1w, w1b,
                     w2w, w2b, bn_scale, bn_shift):
    """qkv (B, m, 3C) f32, nidx (B, m, k) int32, mask (B, m, k) bool, rel
    (B, m, k, 3) f32 and the f32 weights of ``vector_attention_plain`` ->
    (B, m, C) f32, its function.

    On the card this launches ``csrc/vector_attention.cu``, which takes C a
    multiple of 4 (it moves four channels at a time) and N up to 256; on
    the CPU it runs ``vector_attention_plain``."""
    args = (qkv, nidx, mask, rel, p1w, p1b, p2w, p2b, s, w1w, w1b, w2w, w2b,
            bn_scale, bn_shift)
    if not on_card(*args):
        return vector_attention_plain(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "vector_attention on the card is inference-only and has no "
            "backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or on CPU tensors, whose plain "
            "version differentiates")
    b, m, c3 = qkv.shape
    c, k, n = c3 // 3, nidx.shape[2], w2w.shape[0]
    if c3 != 3 * c or n == 0 or c % n or c % 4:
        raise ValueError(f"qkv's {c3} channels and w2w's {n} do not make "
                         f"3 C channels, C a multiple of 4, in groups of N")
    require(qkv, "qkv", torch.float32, (b, m, 3 * c))
    require(nidx, "nidx", torch.int32, (b, m, k))
    require(mask, "mask", torch.bool, (b, m, k))
    require(rel, "rel", torch.float32, (b, m, k, 3))
    for t, name, shape in zip(
            args[4:], WEIGHTS,
            ((3, 3), (3,), (3, c), (c,), (c,), (c, n), (n,), (n, n), (n,),
             (c,), (c,))):
        require(t, name, torch.float32, shape)
    out = torch.empty((b, m, c), dtype=torch.float32, device=qkv.device)
    if b == 0 or m == 0 or c == 0:
        return out
    # The kernel reads qkv and the per-channel weights as float4s.
    args = tuple(t.clone() if i in VECTORS and t.data_ptr() % 16 else t
                 for i, t in enumerate(args))
    with launching_on(qkv) as stream:
        err = _build.library().fc_vector_attention(
            *(t.data_ptr() for t in args), out.data_ptr(), b, m, c, k, n,
            stream)
    _build.check(err, "vector_attention")
    vector_attention.launches += 1
    return out


vector_attention.launches = 0
