"""xLSTM blocks: mLSTM (matrix memory; chunked prefill, recurrent decode)
and sLSTM (scalar memory with a block-diagonal recurrence, step by step).

Counterpart of ``repro.lm.xlstm``, its arithmetic in its order:

* mLSTM: within a chunk the exp-input / sigmoid-forget gate products are
  taken in log space under a per-row stabilizer; across chunks a loop
  (the reference's ``lax.scan``) carries ``(C, n, m)`` per head, ``m``
  starting at -1e30.  Steps padded to a chunk multiple have forget gate
  1 and input gate ``exp(-1e30)``;
* sLSTM: one step a token over the sequence, the reference's scan kept a
  Python loop (a prefill of S tokens makes ~15 launches a step and layer).

The reference's ``XLSTMConfig.unroll`` only lays out its XLA scan; the
port has no such field, so a config that sets it is refused.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.logical import lc
from repro_torch.lm.layers import _normal, dense, dense_init, gelu_tanh, \
    rmsnorm, rmsnorm_init, rounded, silu
from repro_torch.lm.ssm import softplus

NEGINF = -1.0e30


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    proj_factor: float = 2.0     # mLSTM up-projection
    slstm_ff: float = 4.0 / 3.0  # sLSTM post-FFN
    chunk: int = 64

    def d_inner(self, d):
        return int(self.proj_factor * d)


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def sigmoid(x):
    """``jax.nn.sigmoid``, the logistic as XLA lowers it."""
    return 1 / (1 + torch.exp(-x))


# --- mLSTM -------------------------------------------------------------------

class MLSTM(nn.Module):
    """``up``, ``wq``, ``wk``, ``wv``, ``wif``, ``if_b``, ``norm``,
    ``down``."""


def mlstm_init(gen, d, cfg: XLSTMConfig, dtype=torch.float32):
    di = cfg.d_inner(d)
    nh = cfg.n_heads
    p, a = MLSTM(), {}
    p.up, a["up"] = dense_init(gen, d, 2 * di, ("embed_fsdp", "ff"),
                               dtype=dtype)
    for nm in ("wq", "wk", "wv"):
        proj, a[nm] = dense_init(gen, di, di, ("ff", None), dtype=dtype)
        setattr(p, nm, proj)
    p.wif, a["wif"] = dense_init(gen, di, 2 * nh, ("ff", None), dtype=dtype)
    p.if_b = nn.Parameter(torch.cat([
        torch.zeros((nh,)),                 # input gate bias
        torch.linspace(3.0, 6.0, nh),       # forget gate bias (open)
    ]).to(dtype=dtype, device=gen.device))
    a["if_b"] = (None,)
    p.norm, a["norm"] = rmsnorm_init(di, dtype, gen.device)
    p.down, a["down"] = dense_init(gen, di, d, ("ff", "embed_fsdp"),
                                   dtype=dtype)
    return p, a


def _mlstm_gates(p: MLSTM, h, nh):
    pre = dense(p.wif, h) + p.if_b
    li = pre[..., :nh].float()                               # log input gate
    lf = log_sigmoid(pre[..., nh:].float())
    return li, lf


def _mlstm_chunk(carry, qc, kc, vc, lic, lfcc, causal):
    """One chunk: (the carried (C, n, m) at its end, y (B, L, H, hd))."""
    C, n, m = carry
    scc = (lfcc[:, :, None, :] - lfcc[:, None, :, :]
           + lic[:, None, :, :])                             # (B,L,L,H)
    scc = torch.where(causal, scc, NEGINF)
    mloc = scc.amax(2)                                       # (B,L,H)
    qkc = torch.einsum("blhd,bshd->blsh", qc, kc)
    # inter log-decay for queries: lfc_t + m_prev
    b_inter = lfcc + m[:, None, :]                           # (B,L,H)
    mrow = torch.maximum(mloc, b_inter)
    w_intra = torch.exp(scc - mrow[:, :, None, :]) * qkc     # (B,L,L,H)
    y_num = torch.einsum("blsh,bshd->blhd", w_intra, vc)
    y_den = w_intra.sum(2)                                   # (B,L,H)
    w_inter = torch.exp(b_inter - mrow)                      # (B,L,H)
    y_num = y_num + w_inter[..., None] * torch.einsum("blhk,bhkv->blhv",
                                                      qc, C)
    y_den = y_den + w_inter * torch.einsum("blhk,bhk->blh", qc, n)
    denom = torch.maximum(torch.abs(y_den), torch.exp(-mrow)) + 1e-6
    y = y_num / denom[..., None]
    # state update to the end of the chunk
    lfl = lfcc[:, -1, :]                                     # (B,H)
    dec_k = lfl[:, None, :] - lfcc + lic                     # (B,L,H)
    m_new = torch.maximum(lfl + m, dec_k.amax(1))
    wk = torch.exp(dec_k - m_new[:, None, :])
    fw = torch.exp(lfl + m - m_new)
    C_new = fw[:, :, None, None] * C + torch.einsum(
        "blh,blhk,blhv->bhkv", wk, kc, vc)
    n_new = fw[:, :, None] * n + torch.einsum("blh,blhk->bhk", wk, kc)
    return (C_new, n_new, m_new), y


def mlstm_forward(p: MLSTM, x, *, d, cfg: XLSTMConfig, return_state=False):
    b, s, _ = x.shape
    di, nh, L = cfg.d_inner(d), cfg.n_heads, cfg.chunk
    hd = di // nh
    f32 = torch.float32
    up = dense(p.up, x)
    hin, gate = up[..., :di], up[..., di:]
    scale = rounded(hd ** -0.5, x.dtype)
    q = dense(p.wq, hin).reshape(b, s, nh, hd) * scale
    k = dense(p.wk, hin).reshape(b, s, nh, hd) * scale
    v = dense(p.wv, hin).reshape(b, s, nh, hd)
    li, lf = _mlstm_gates(p, hin, nh)                        # (B,S,H)

    # Pad to a chunk multiple; padded steps are identity (f=1, i=0).
    pad = (-s) % L
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        lf = torch.nn.functional.pad(lf, (0, 0, 0, pad))
        li = torch.nn.functional.pad(li, (0, 0, 0, pad), value=NEGINF)
    sp = s + pad
    nc = sp // L

    def chunks(t):
        return t.reshape(b, nc, L, *t.shape[2:])

    q, k, v = chunks(q), chunks(k), chunks(v)
    q = lc(q, "batch", None, None, "heads", None)
    li, lf = chunks(li), chunks(lf)
    lfc = torch.cumsum(lf, dim=2)                            # (B,nc,L,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]

    # The carried state: C (B,H,dk,dv), n (B,H,dk), m (B,H).  The (L,L,H)
    # scores are built a chunk at a time.
    carry = mlstm_state(b, d, cfg, device=x.device)
    carry = (carry["C"], carry["n"], carry["m"])
    ys = []
    for c in range(nc):
        carry, y = _mlstm_chunk(carry, q[:, c].to(f32), k[:, c].to(f32),
                                v[:, c].to(f32), li[:, c], lfc[:, c], causal)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, sp, di)[:, :s].to(x.dtype)
    y = rmsnorm(p.norm, y) * silu(gate)
    out = dense(p.down, y)
    if return_state:
        Cf, nf, mf = carry
        return out, {"C": Cf, "n": nf, "m": mf}
    return out


def mlstm_state(batch, d, cfg: XLSTMConfig, device=None):
    nh = cfg.n_heads
    hd = cfg.d_inner(d) // nh
    f32 = torch.float32
    return {"C": torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, nh, hd), dtype=f32, device=device),
            "m": torch.full((batch, nh), NEGINF, dtype=f32, device=device)}


def mlstm_state_axes():
    return {"C": ("batch", "heads", None, None),
            "n": ("batch", "heads", None), "m": ("batch", "heads")}


def mlstm_decode(p: MLSTM, x, state, *, d, cfg: XLSTMConfig):
    b = x.shape[0]
    di, nh = cfg.d_inner(d), cfg.n_heads
    hd = di // nh
    up = dense(p.up, x)
    hin, gate = up[..., :di], up[..., di:]
    q = dense(p.wq, hin).reshape(b, nh, hd).float() * hd ** -0.5
    k = dense(p.wk, hin).reshape(b, nh, hd).float() * hd ** -0.5
    v = dense(p.wv, hin).reshape(b, nh, hd).float()
    li, lf = _mlstm_gates(p, hin, nh)
    li, lf = li[:, 0], lf[:, 0]                               # (B,H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    C = fw[:, :, None, None] * C + iw[:, :, None, None] * \
        torch.einsum("bhk,bhv->bhkv", k, v)
    n = fw[:, :, None] * n + iw[:, :, None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                        torch.exp(-m_new)) + 1e-6
    y = (num / den[..., None]).reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(p.norm, y) * silu(gate)
    return dense(p.down, y), {"C": C, "n": n, "m": m_new}


# --- sLSTM -------------------------------------------------------------------

class SLSTM(nn.Module):
    """``wx``, ``r`` (H, hd, 4 hd), ``b``, ``norm``, ``ff_i``, ``ff_o``."""


def slstm_init(gen, d, cfg: XLSTMConfig, dtype=torch.float32):
    nh = cfg.n_heads
    hd = d // nh
    dff = int(cfg.slstm_ff * d)
    p, a = SLSTM(), {}
    p.wx, a["wx"] = dense_init(gen, d, 4 * d, ("embed_fsdp", "ff"),
                               dtype=dtype)
    p.r = _normal(gen, (nh, hd, 4 * hd), hd ** -0.5, dtype)
    a["r"] = ("heads", None, None)
    p.b = nn.Parameter(torch.cat([
        torch.zeros((2 * d,)), torch.linspace(3.0, 6.0, d),
        torch.zeros((d,)),
    ]).to(dtype=dtype, device=gen.device))
    a["b"] = (None,)
    p.norm, a["norm"] = rmsnorm_init(d, dtype, gen.device)
    p.ff_i, a["ff_i"] = dense_init(gen, d, dff, ("embed_fsdp", "ff"),
                                   dtype=dtype)
    p.ff_o, a["ff_o"] = dense_init(gen, dff, d, ("ff", "embed_fsdp"),
                                   dtype=dtype)
    return p, a


def _slstm_bias(p: SLSTM, nh, hd):
    """The gate-major bias ``[z | i | f | o]`` (each d) reordered head
    major, (H, 4 hd), by the reference's reshape/transpose chain."""
    return p.b.reshape(nh * 4, hd).reshape(4, nh, hd).permute(1, 0, 2) \
        .reshape(nh, 4 * hd)


def _slstm_cell(p: SLSTM, xt, state, nh, hd, bias):
    """xt (B, 4d) preactivations from W x; state dict of (B,H,hd)."""
    c, n, hprev, m = state["c"], state["n"], state["h"], state["m"]
    b = xt.shape[0]
    wt = torch.promote_types(hprev.dtype, p.r.dtype)
    rec = torch.einsum("bhk,hkj->bhj", hprev.to(wt), p.r.to(wt))
    pre = xt.reshape(b, nh, 4 * hd) + rec + bias
    z = torch.tanh(pre[..., :hd].float())
    li = pre[..., hd:2 * hd].float()
    lf = log_sigmoid(pre[..., 2 * hd:3 * hd].float())
    o = sigmoid(pre[..., 3 * hd:].float())
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    c = fw * c + iw * z
    n = fw * n + iw
    h = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def _slstm_out(p: SLSTM, y):
    y = rmsnorm(p.norm, y)
    return dense(p.ff_o, gelu_tanh(dense(p.ff_i, y)))


def slstm_forward(p: SLSTM, x, *, d, cfg: XLSTMConfig, return_state=False):
    b, s, _ = x.shape
    nh = cfg.n_heads
    hd = d // nh
    xs = dense(p.wx, x)                                      # (B,S,4d)
    state = slstm_state(b, d, cfg, device=x.device)
    bias = _slstm_bias(p, nh, hd)
    hs = []
    for t in range(s):
        state, h = _slstm_cell(p, xs[:, t], state, nh, hd, bias)
        hs.append(h)
    y = _slstm_out(p, torch.stack(hs, 1).reshape(b, s, d).to(x.dtype))
    if return_state:
        return y, state
    return y


def slstm_state(batch, d, cfg: XLSTMConfig, device=None):
    nh = cfg.n_heads
    hd = d // nh
    f32 = torch.float32

    def z():
        return torch.zeros((batch, nh, hd), dtype=f32, device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, nh, hd), NEGINF, dtype=f32,
                            device=device)}


def slstm_state_axes():
    ax = ("batch", "heads", None)
    return {"c": ax, "n": ax, "h": ax, "m": ax}


def slstm_decode(p: SLSTM, x, state, *, d, cfg: XLSTMConfig):
    b = x.shape[0]
    nh = cfg.n_heads
    hd = d // nh
    xt = dense(p.wx, x)[:, 0, :]
    state, h = _slstm_cell(p, xt, state, nh, hd, _slstm_bias(p, nh, hd))
    return _slstm_out(p, h.reshape(b, 1, d).to(x.dtype)), state
