"""Mamba2 (SSD) block: chunked prefill / full forward, recurrent decode.

Counterpart of ``repro.lm.ssm``.  Within a chunk of ``L`` steps the output
is an attention-like masked product; across chunks a loop carries the
(H, N, P) state (the reference's ``lax.scan``).  The arithmetic follows
the reference's, in its dtypes:

* the causal conv multiplies the activations by the float32 ``conv_w``,
  so its output is float32 wherever the activations are bfloat16 (JAX's
  promotion; ``torch.einsum`` refuses mixed dtypes, so decode promotes
  explicitly);
* steps padded to a chunk multiple have ``dt = 0`` and log-decay 0: they
  leave the carried state as it is;
* the intra-chunk decay ``exp(lac[l] - lac[s])`` is masked to ``-inf``
  above the diagonal before the exp (the reference masks after it, where
  the exp overflows to ``inf`` at full width: its forward selects 0 there,
  but its backward gives NaN).  The forward is the reference's.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.logical import lc
from repro_torch.lm.layers import _normal, dense, dense_init, rmsnorm, \
    rmsnorm_init, silu


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    headdim: int = 64
    conv_kernel: int = 4
    chunk: int = 128

    def d_inner(self, d):
        return self.expand * d

    def n_heads(self, d):
        return self.d_inner(d) // self.headdim


class Mamba2(nn.Module):
    """``in`` (a dense to [z, x, B, C, dt]), ``conv_w``, ``conv_b``,
    ``A_log``, ``dt_bias``, ``D``, ``norm`` and ``out``."""

    @property
    def proj(self):
        return self._modules["in"]


def mamba2_init(gen, d, cfg: SSMConfig, dtype=torch.float32):
    di = cfg.d_inner(d)
    h = cfg.n_heads(d)
    n = cfg.d_state
    conv_dim = di + 2 * n
    dev = gen.device
    p, a = Mamba2(), {}
    # in_proj -> [z(di), x(di), B(n), C(n), dt(h)]
    dense_in, a["in"] = dense_init(gen, d, 2 * di + 2 * n + h,
                                   ("embed_fsdp", "ff"), dtype=dtype)
    p.add_module("in", dense_in)
    p.conv_w = _normal(gen, (cfg.conv_kernel, conv_dim), 0.1, dtype)
    a["conv_w"] = (None, "ff")
    p.conv_b = nn.Parameter(torch.zeros((conv_dim,), dtype=dtype,
                                        device=dev))
    a["conv_b"] = ("ff",)
    p.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h,
                                                    device=dev)).to(dtype))
    a["A_log"] = ("ssm_heads",)
    lo, hi = torch.log(torch.tensor(0.001)), torch.log(torch.tensor(0.1))
    u = torch.rand((h,), generator=gen, device=dev)
    dt0 = torch.exp(u * (hi - lo) + lo)
    p.dt_bias = nn.Parameter((dt0 + torch.log(-torch.expm1(-dt0)))
                             .to(dtype))
    a["dt_bias"] = ("ssm_heads",)
    p.D = nn.Parameter(torch.ones((h,), dtype=dtype, device=dev))
    a["D"] = ("ssm_heads",)
    p.norm, a["norm"] = rmsnorm_init(di, dtype, dev)
    p.out, a["out"] = dense_init(gen, di, d, ("ff", "embed_fsdp"),
                                 dtype=dtype)
    return p, a


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_proj(p: Mamba2, x, d, cfg: SSMConfig):
    di = cfg.d_inner(d)
    n = cfg.d_state
    zxbcdt = dense(p.proj, x)
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    bm = zxbcdt[..., 2 * di:2 * di + n]
    cm = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xin, bm, cm, dt


def _conv_full(p: Mamba2, u, k):
    """Causal depthwise conv over (B, S, C); float32 for bfloat16 ``u``
    under float32 weights."""
    pad = torch.nn.functional.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * p.conv_w[i] for i in range(k))
    return out + p.conv_b


def _intra_weights(cb, lac, causal):
    """``cb`` (B,nc,L,L) times the decay ``exp(lac[l] - lac[s])`` (B,nc,L,H)
    on and below the diagonal, 0 above.  The exponent is masked to -inf
    before the exp: above the diagonal it is positive and overflows
    float32 at full width, and the exp's backward would give inf * 0 =
    NaN.  The causal entries are the reference's."""
    decay = torch.exp(torch.where(
        causal, lac[:, :, :, None, :] - lac[:, :, None, :, :], -torch.inf))
    return torch.where(causal, cb[..., None] * decay, 0.0)


def mamba2_forward(p: Mamba2, x, *, d, cfg: SSMConfig, return_state=False):
    """x (B, S, D) -> y (B, S, D) [, the state for decode]."""
    b, s, _ = x.shape
    di, h, n, L = cfg.d_inner(d), cfg.n_heads(d), cfg.d_state, cfg.chunk
    ph = cfg.headdim
    f32 = torch.float32
    z, xin, bm, cm, dt = _split_proj(p, x, d, cfg)
    conv_in = torch.cat([xin, bm, cm], -1)
    conv_out = silu(_conv_full(p, conv_in, cfg.conv_kernel))
    xin = conv_out[..., :di]
    bm = conv_out[..., di:di + n]
    cm = conv_out[..., di + n:]
    dt = softplus(dt.float() + p.dt_bias)                        # (B,S,H)
    A = -torch.exp(p.A_log.float())                               # (H,)
    la = dt * A                                                   # log-decay

    # Pad to a chunk multiple; padded steps are identity (a=1, dt=0) so the
    # carried state and real outputs are unaffected.
    pad = (-s) % L
    if pad:
        xin, bm, cm, dt, la = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                               for t in (xin, bm, cm, dt, la))
    sp = s + pad
    nc = sp // L
    xh = lc(xin.reshape(b, nc, L, h, ph),
            "batch", None, None, "ssm_heads", None).to(f32)
    dtc = dt.reshape(b, nc, L, h)
    lac = torch.cumsum(la.reshape(b, nc, L, h), dim=2)           # (B,nc,L,H)
    bmc = bm.reshape(b, nc, L, n).to(f32)
    cmc = cm.reshape(b, nc, L, n).to(f32)

    # Intra-chunk (attention-like, causal):
    cb = torch.einsum("bcln,bcsn->bcls", cmc, bmc)               # (B,nc,L,L)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    m = _intra_weights(cb, lac, causal)                           # (B,nc,L,L,H)
    m = m * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bclsh,bcshp->bclhp", m, xh)

    # Chunk states + the inter-chunk loop:
    dec_out = torch.exp(lac[:, :, -1:, :] - lac)                 # (B,nc,L,H)
    sloc = torch.einsum("bclh,bcln,bclhp->bchnp", dec_out * dtc, bmc, xh)
    chunk_decay = torch.exp(lac[:, :, -1, :])                    # (B,nc,H)
    carry = torch.zeros((b, h, n, ph), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + sloc[:, c]
    s_prev = torch.stack(prev, 1)                                # (B,nc,H,N,P)
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp",
                           cmc, torch.exp(lac), s_prev)

    y = (y_intra + y_inter).reshape(b, sp, h, ph)[:, :s]
    y = y + xin[:, :s].reshape(b, s, h, ph).to(f32) * \
        p.D.to(f32)[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm(p.norm, y * silu(z))
    out = dense(p.out, y)
    if not return_state:
        return out
    conv_tail = conv_in[:, -(cfg.conv_kernel - 1):, :].transpose(1, 2)
    return out, {"ssd": carry, "conv": conv_tail.contiguous()}


def init_state(batch, d, cfg: SSMConfig, dtype=torch.float32, device=None):
    di, h, n = cfg.d_inner(d), cfg.n_heads(d), cfg.d_state
    return {
        "ssd": torch.zeros((batch, h, n, cfg.headdim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, di + 2 * n, cfg.conv_kernel - 1),
                            dtype=dtype, device=device),
    }


def state_axes():
    return {"ssd": ("batch", "ssm_heads", None, None),
            "conv": ("batch", "ff", None)}


def mamba2_decode(p: Mamba2, x, state, *, d, cfg: SSMConfig):
    """One-token step, x (B, 1, D).  Returns (y, the new state)."""
    b = x.shape[0]
    di, h, n, ph = cfg.d_inner(d), cfg.n_heads(d), cfg.d_state, cfg.headdim
    f32 = torch.float32
    z, xin, bm, cm, dt = _split_proj(p, x, d, cfg)
    u = torch.cat([xin, bm, cm], -1)[:, 0, :]                     # (B, convdim)
    hist = torch.cat([state["conv"],
                      u[:, :, None].to(state["conv"].dtype)], -1)
    wt = torch.promote_types(hist.dtype, p.conv_w.dtype)
    conv = torch.einsum("bck,kc->bc", hist.to(wt), p.conv_w.to(wt)) \
        + p.conv_b
    conv = silu(conv)
    xin = conv[:, :di].reshape(b, h, ph).to(f32)
    bmv = conv[:, di:di + n].to(f32)
    cmv = conv[:, di + n:].to(f32)
    dtv = softplus(dt[:, 0, :].float() + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    a = torch.exp(dtv * A)                                        # (B,H)
    ssd = state["ssd"] * a[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dtv, bmv, xin)
    y = torch.einsum("bn,bhnp->bhp", cmv, ssd)
    y = y + xin * p.D.to(f32)[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(p.norm, y * silu(z))
    out = dense(p.out, y)
    return out, {"ssd": ssd, "conv": hist[:, :, 1:]}
