"""Gradient compression codecs + error feedback.

Counterpart of ``repro.dist.compression``: ``bf16`` (2x, deterministic,
round to nearest even) or ``int8`` (4x, per-tensor scale with *stochastic
rounding*, so the quantizer is unbiased).  Both codecs are lossy;
``apply_error_feedback`` keeps the per-tensor quantization residual and
re-injects it into the next step's gradient (EF-SGD), which restores
convergence to the uncompressed optimum.  The trainer runs them on one
card as the reference does, so a compressed fine-tune follows the same
trajectory.

The int8 arithmetic is the reference's, step for step in float32; only the
random source differs.  A ``key`` is a tuple of ints, e.g. ``(seed,
step)``, in the place of the reference's PRNG key: its uniforms are a
counter-based hash of ``(*key, element index)`` (``data/synthetic.py``'s
``_hash`` / ``_uniform``), the same on the CPU and on the card.
``_quantize_int8(x, u)`` takes the uniforms explicitly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.data.synthetic import _hash, _uniform

METHODS = ("bf16", "int8")


def _unknown(method):
    return ValueError(f"unknown compression method {method!r}; "
                      f"have {METHODS}")


def uniform(key: tuple, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` on ``device``, hashed from
    the int tuple ``key`` and each element's index (24 bits of
    resolution); the key's words are hashed on the host."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return _uniform(_hash(*(int(k) for k in key), i)).reshape(shape)


def _quantize_int8(x: torch.Tensor, u: torch.Tensor):
    """(int8 payload, float32 scale = max|x|) given the uniforms ``u``.

    Every division is tensor by tensor on ``x``'s device: PyTorch computes
    ``127.0 / t`` as ``127 * (1 / t)``, and divides a CUDA tensor by a
    Python number through its reciprocal, either of which can differ from
    the reference's quotient in the last bit."""
    x = x.float()
    scale = x.abs().max()
    y = x * torch.div(scale.new_tensor(127.0),
                      scale.clamp(min=torch.finfo(torch.float32).tiny))
    lo = torch.floor(y)
    q = lo + (u < y - lo).float()
    return q.clamp(-127, 127).to(torch.int8), scale


def compress(x: torch.Tensor, method: str, key=None):
    """x -> (payload, meta).  ``meta`` is the int8 per-tensor scale
    (max |x|), or None for bf16.  ``key`` drives stochastic rounding and is
    required for int8."""
    if method == "bf16":
        return x.to(torch.bfloat16), None
    if method == "int8":
        if key is None:
            raise ValueError("int8 compression needs a PRNG key "
                             "(stochastic rounding)")
        return _quantize_int8(x, uniform(key, tuple(x.shape), x.device))
    raise _unknown(method)


def decompress(payload: torch.Tensor, meta, method: str) -> torch.Tensor:
    if method == "bf16":
        return payload.float()
    if method == "int8":
        return payload.float() * torch.div(meta, meta.new_tensor(127.0))
    raise _unknown(method)


def roundtrip(x: torch.Tensor, method: str, key=None) -> torch.Tensor:
    """Compress-then-decompress (what the receiving end of the reduce
    sees), dtype-preserving."""
    payload, meta = compress(x, method, key)
    return decompress(payload, meta, method).to(x.dtype)


def init_residual(params: dict) -> dict:
    """Zero error-feedback residuals, one float32 tensor per parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def apply_error_feedback(grads: dict, residual: dict, method: str, key):
    """EF step: compress (grad + residual), carry the quantization error.

    ``grads`` and ``residual`` are ``{name: tensor}``; leaf ``i`` (in
    ``grads``' key order) draws from ``key`` with ``i`` appended, as the
    reference splits its key over the leaves.  Returns (decompressed grads
    to feed the optimizer, new residual)."""
    out, new_res = {}, {}
    for i, (k, g) in enumerate(grads.items()):
        acc = g.float() + residual[k]
        dec = roundtrip(acc, method, None if key is None else (*key, i))
        out[k] = dec.to(g.dtype)
        new_res[k] = acc - dec
    return out, new_res
