"""Mixture-of-Experts with sort-based (dropping) dispatch.

Counterpart of ``repro.lm.moe``.  Tokens are routed top-k, their
assignments sorted by expert, cut to a per-expert capacity, and run
through grouped ``(E, C, d) x (E, d, f)`` matmuls.  The reference's
contracts are kept exactly:

* the selection is ``jax.lax.top_k``'s: the largest scores, the lowest
  expert first on ties (``torch.topk`` promises no order on ties, so it
  runs on int64 keys of the order-preserving float bits and the index);
* the sort by expert is stable, so capacity drops the same assignments
  (``rank < cap``, in token order within an expert);
* every dropped assignment is written to the sentinel slot ``E * cap``,
  which is cut off; an empty slot points at the zero pad row ``t``;
* the combine sums each token's kept contributions in ascending slot
  order (row-major over ``(E, C)``), the order of the reference's
  scatter-add on the CPU, with no atomics: the same inputs give the same
  bits on every run, on the card and on the CPU.

The full forward calls ``moe_apply`` (``y`` and the aux losses) with
dropping dispatch at ``capacity_factor``; prefill calls ``moe_ffn``
(``y`` alone) the same way, and a decode step with ``no_drop=True``
(capacity ``T * k``), as the reference's model does.  Nothing on this
path copies a value back to the host.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.dist.logical import lc
from repro_torch.lm.layers import _normal, dense, dense_init, gelu_tanh, \
    mlp, mlp_init, silu


class MoE(nn.Module):
    """``router`` (a dense ``(d, E)``), the expert weights ``wi``, ``wg``
    (gated kinds) and ``wo``, each ``(E, din, dout)``, and ``shared`` (an
    MLP) with a shared expert."""


def moe_init(gen, d, d_ff, n_experts, *, kind="swiglu", shared_ff=0,
             dtype=torch.float32):
    scale = (2.0 / (d + d_ff)) ** 0.5
    p, a = MoE(), {}
    p.router, a["router"] = dense_init(gen, d, n_experts,
                                       ("embed_fsdp", None), dtype=dtype)
    p.wi = _normal(gen, (n_experts, d, d_ff), scale, dtype)
    a["wi"] = ("experts", None, "ff")
    if kind in ("swiglu", "geglu"):
        p.wg = _normal(gen, (n_experts, d, d_ff), scale, dtype)
        a["wg"] = ("experts", None, "ff")
    p.wo = _normal(gen, (n_experts, d_ff, d), scale, dtype)
    a["wo"] = ("experts", "ff", None)
    if shared_ff:
        p.shared, a["shared"] = mlp_init(gen, d, shared_ff, kind,
                                         dtype=dtype)
    return p, a


def _expert_ffn(p: MoE, xb, kind):
    """Grouped expert matmuls on an (E, C, d) buffer."""
    hi = torch.bmm(xb, p.wi.to(xb.dtype))
    if kind == "swiglu":
        h = silu(torch.bmm(xb, p.wg.to(xb.dtype))) * hi
    elif kind == "geglu":
        h = gelu_tanh(torch.bmm(xb, p.wg.to(xb.dtype))) * hi
    else:  # relu2
        h = torch.square(torch.relu(hi))
    h = lc(h, "experts", None, "ff")
    return torch.bmm(h, p.wo.to(xb.dtype))


def lax_top_k(scores, k):
    """``jax.lax.top_k`` over the last axis of float32 ``scores``: (values,
    int64 indices), descending, the lowest index first on ties."""
    n = scores.shape[-1]
    bits = scores.contiguous().view(torch.int32)
    # Negative floats order backwards as ints: flip their magnitude bits.
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = (n - 1) - torch.arange(n, device=scores.device)
    key = (ordered << 32) | rev
    top = torch.topk(key, k, dim=-1, largest=True, sorted=True).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, idx), idx


def _softmax(x):
    """``jax.nn.softmax``: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _route(logits, k, router_act):
    """(gate (T, k), expert ids (T, k), router probabilities (T, E))."""
    if router_act == "softmax":
        probs = _softmax(logits)
        gate, eidx = lax_top_k(probs, k)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    else:  # sigmoid (llama4-style): independent expert scores
        gate, eidx = lax_top_k(logits, k)
        gate = 1 / (1 + torch.exp(-gate))
        probs = _softmax(logits)
    return gate, eidx, probs


def _sort_dispatch(flat_e, t, k, n_experts, cap):
    """Sort assignments by expert (stable); returns (order, sorted expert
    ids, slot (T*k,), keep).  A dropped assignment's slot is the sentinel
    ``E * cap``."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # The rank within an expert: the place in the sorted list less the
    # expert's first place.  No per-expert counts, so no host round trip.
    rank = torch.arange(t * k, device=flat_e.device) - \
        torch.searchsorted(se, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, n_experts * cap)
    return order, se, slot, keep


def _moe(p: MoE, x, *, n_experts, top_k, kind, capacity_factor, router_act,
         shared, no_drop):
    """-> (y (B, S, D), (router logits, probabilities, expert ids, keep)):
    the routed FFN and what the aux losses read."""
    b, s, d = x.shape
    t = b * s
    k = top_k
    xf = x.reshape(t, d)
    logits = dense(p.router, xf).float()                     # (T, E)
    gate, eidx, probs = _route(logits, k, router_act)

    cap = t * k if no_drop else \
        max(int(math.ceil(t * k * capacity_factor / n_experts)), 1)
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(t * k, device=x.device) // k
    flat_g = gate.reshape(-1).to(x.dtype)
    order, se, slot, keep = _sort_dispatch(flat_e, t, k, n_experts, cap)
    stok, sg = flat_t[order], flat_g[order]

    # Token buffer (E, C, D): kept slots are distinct, every dropped one
    # lands on the sentinel row, which is cut off.
    nslot = n_experts * cap
    buf_tok = torch.full((nslot + 1,), t, dtype=torch.int64, device=x.device)
    buf_tok[slot] = stok
    buf_tok2 = lc(buf_tok[:-1].reshape(n_experts, cap),
                  "experts", "expert_cap")
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xb = lc(xpad[buf_tok2], "experts", "expert_cap", None)
    yb = lc(_expert_ffn(p, xb, kind), "experts", "expert_cap", None)
    g_buf = torch.zeros((nslot + 1,), dtype=x.dtype, device=x.device)
    g_buf[slot] = torch.where(keep, sg, 0)

    # Return path: each token's contributions in ascending slot order.
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot                      # slot of assignment (t, j)
    slots = torch.sort(slot_of.reshape(t, k), dim=-1).values
    contrib = torch.cat([yb.reshape(nslot, d) * g_buf[:-1, None],
                         yb.new_zeros((1, d))], 0)[slots]    # (T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    y = lc(y.reshape(b, s, d), "batch", None, None).reshape(t, d)

    if shared and hasattr(p, "shared"):
        y = y + mlp(p.shared, x, kind).reshape(t, d)
    return y.reshape(b, s, d), (logits, probs, eidx, keep)


def _aux(logits, probs, eidx, keep, n_experts):
    """The switch load-balance loss, the router z-loss and the share of
    assignments dropped."""
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(eidx[:, 0], n_experts).float().mean(0)
    return {"aux_lb": n_experts * torch.sum(me * ce),
            "aux_z": torch.mean(torch.square(torch.logsumexp(logits, -1))),
            "frac_dropped": 1.0 - keep.sum() / keep.numel()}


def moe_apply(p: MoE, x, *, n_experts, top_k, kind="swiglu",
              capacity_factor=1.25, router_act="softmax",
              shared: bool = False, no_drop: bool = False):
    """x (B, S, D) -> (y (B, S, D), {"aux_lb", "aux_z", "frac_dropped"}).

    ``no_drop=True`` sets the capacity to ``T * k`` (a decode step).  The
    reference's ``dispatch="grouped_a2a"`` routes per data-shard group of
    several devices; on one card it is this dispatch, so the port does not
    take the option."""
    y, r = _moe(p, x, n_experts=n_experts, top_k=top_k, kind=kind,
                capacity_factor=capacity_factor, router_act=router_act,
                shared=shared, no_drop=no_drop)
    return y, _aux(*r, n_experts)


def moe_ffn(p: MoE, x, *, n_experts, top_k, kind="swiglu",
            capacity_factor=1.25, router_act="softmax", shared: bool = False,
            no_drop: bool = False):
    """``moe_apply``'s ``y`` alone, without the aux losses: the serving
    path (prefill and decode), which has no use for them."""
    return _moe(p, x, n_experts=n_experts, top_k=top_k, kind=kind,
                capacity_factor=capacity_factor, router_act=router_act,
                shared=shared, no_drop=no_drop)[0]
