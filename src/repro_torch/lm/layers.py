"""Base layers of the LM: dense, RMSNorm, embedding, RoPE, softcap, MLP.

Counterpart of ``repro.lm.layers``.  A layer's parameters live in a small
``nn.Module`` whose attribute names are the reference's tree keys (``w``,
``g``, ``wi``/``wg``/``wo``), so ``convert.lm_from_jax`` maps one onto the
other by name.  Every ``*_init`` returns (module, logical-axes tree), the
tree equal to the reference's, for ``dist.logical.param_specs``.

Weights are drawn on the generator's device and moved by the caller.
Dense weights are ``(din, dout)`` and used as ``x @ w``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.logical import lc


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> nn.Parameter:
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return nn.Parameter(w.to(dtype))


class Dense(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = w


class RMSNorm(nn.Module):
    def __init__(self, g):
        super().__init__()
        self.g = g


class Embed(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = w


def dense_init(gen, din, dout, axes=("embed_fsdp", "ff"), scale=None,
               dtype=torch.float32):
    scale = (2.0 / (din + dout)) ** 0.5 if scale is None else scale
    return Dense(_normal(gen, (din, dout), scale, dtype)), {"w": axes}


def dense(p: Dense, x):
    # Params may be float32 while activations run bfloat16: the weight is
    # cast into the activation dtype at each call, as the reference does.
    return x @ p.w.to(x.dtype)


def rmsnorm_init(d, dtype=torch.float32, device=None):
    return RMSNorm(nn.Parameter(torch.ones((d,), dtype=dtype,
                                           device=device))), {"g": None}


def rmsnorm(p: RMSNorm, x, eps=1e-5):
    # Mean of squares in float32; rsqrt cast to x's dtype before the product.
    var = x.float().square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    return out * p.g.to(x.dtype)


def embed_init(gen, vocab, d, dtype=torch.float32):
    return Embed(_normal(gen, (vocab, d), 0.02, dtype)), \
        {"w": ("vocab", "embed_fsdp")}


def rope(x, positions, theta: float):
    """x (..., S, H, hd), positions (..., S) -> rotated x.  Split halves
    (not interleaved pairs), float32 angles."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def softcap(x, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# --- MLP variants -----------------------------------------------------------

class MLP(nn.Module):
    """``wi`` and ``wo``, and ``wg`` for the gated kinds."""


def mlp_init(gen, d, d_ff, kind, dtype=torch.float32):
    if kind not in ("swiglu", "geglu", "relu2"):
        raise ValueError(kind)
    p, a = MLP(), {}
    p.wi, a["wi"] = dense_init(gen, d, d_ff, ("embed_fsdp", "ff"),
                               dtype=dtype)
    if kind != "relu2":
        p.wg, a["wg"] = dense_init(gen, d, d_ff, ("embed_fsdp", "ff"),
                                   dtype=dtype)
    p.wo, a["wo"] = dense_init(gen, d_ff, d, ("ff", "embed_fsdp"),
                               dtype=dtype)
    return p, a


def silu(x):
    """``jax.nn.silu`` op for op in x's dtype, the logistic as XLA lowers it
    (``1 / (1 + exp(-x))``): in bfloat16 each op rounds, where ``F.silu``
    rounds once."""
    return x * (1 / (1 + torch.exp(-x)))


def rounded(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as a Python number (a constant the
    reference casts into the activation dtype, with no host-to-device
    copy a call)."""
    return torch.tensor(c, dtype=dtype).item()


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` op for op in x's dtype."""
    c = rounded(math.sqrt(2 / math.pi), x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3)))))


def mlp(p: MLP, x, kind):
    if kind == "swiglu":
        h = silu(dense(p.wg, x)) * dense(p.wi, x)
    elif kind == "geglu":
        h = gelu_tanh(dense(p.wg, x)) * dense(p.wi, x)
    elif kind == "relu2":
        h = torch.square(F.relu(dense(p.wi, x)))
    else:
        raise ValueError(kind)
    h = lc(h, "batch", None, "ff")
    return dense(p.wo, h)
