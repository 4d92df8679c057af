"""GQA attention: the full/prefill path and decode with a KV cache.

Counterpart of ``repro.lm.attention``, with its arithmetic in its order:

* ``_sdpa`` computes the scores in the query dtype (bfloat16 at the full
  configs), softcaps and masks them with ``NEG``, takes the softmax in
  float32 and casts the probabilities back before the product with ``v``;
* GQA never repeats K/V: head ``h`` is group ``h % g`` of KV head
  ``h // g`` (``q.reshape(b, s, kv, g, hd)``);
* ``_sdpa_flash`` is the online-softmax form over KV chunks, float32
  throughout, taken when the KV length exceeds ``FLASH_THRESHOLD``.

Both are written with ``torch.einsum``: attention is no TPU kernel in the
reference (the flash form is a ``lax.scan``), and a fused kernel for it
is a later performance question (ROADMAP.md).

Local layers keep a rolling cache of ``window`` slots, the key of
absolute position ``a`` at slot ``a % window``.  Decode updates the cache
in place.  Where the reference's ``dynamic_update_slice`` would clamp a
write past the end of a non-rolling cache onto its last slot, decode
raises ``ValueError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.logical import lc
from repro_torch.lm.layers import dense, dense_init, rmsnorm, rmsnorm_init, \
    rope, softcap

NEG = -2.0e38
FLASH_THRESHOLD = 4096  # KV lengths above this use the chunked form


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo``, and ``qn``/``kn`` with QK-norm."""


def attn_init(gen, d, n_heads, n_kv, head_dim, *, qk_norm=False,
              dtype=torch.float32):
    p, a = Attention(), {}
    p.wq, a["wq"] = dense_init(gen, d, n_heads * head_dim,
                               ("embed_fsdp", "ff"), dtype=dtype)
    p.wk, a["wk"] = dense_init(gen, d, n_kv * head_dim,
                               ("embed_fsdp", "ff"), dtype=dtype)
    p.wv, a["wv"] = dense_init(gen, d, n_kv * head_dim,
                               ("embed_fsdp", "ff"), dtype=dtype)
    p.wo, a["wo"] = dense_init(gen, n_heads * head_dim, d,
                               ("ff", "embed_fsdp"), dtype=dtype)
    if qk_norm:
        p.qn, a["qn"] = rmsnorm_init(head_dim, dtype, gen.device)
        p.kn, a["kn"] = rmsnorm_init(head_dim, dtype, gen.device)
    return p, a


def _project_qkv(p, xq, xkv, n_heads, n_kv, head_dim, *, positions_q,
                 positions_kv, rope_theta, qk_norm, use_rope=True):
    b, sq, _ = xq.shape
    sk = xkv.shape[1]
    q = dense(p.wq, xq).reshape(b, sq, n_heads, head_dim)
    k = dense(p.wk, xkv).reshape(b, sk, n_kv, head_dim)
    v = dense(p.wv, xkv).reshape(b, sk, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(p.qn, q)
        k = rmsnorm(p.kn, k)
    if use_rope:
        q = rope(q, positions_q, rope_theta)
        k = rope(k, positions_kv, rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, *, scale, cap):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable to
    (B,KV,G,Sq,Sk) or None."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * scale
    scores = softcap(scores, cap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_flash(q, k, v, *, scale, cap, causal, window, chunk):
    """Online-softmax attention over KV chunks of ``chunk`` keys: score
    memory O(Sq * chunk) instead of O(Sq * Sk)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    dev = q.device
    qg = q.reshape(b, sq, kv, g, hd).float()
    iq = torch.arange(sq, device=dev)[:, None]
    nc = -(-sk // chunk)
    m = torch.full((b, kv, g, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, sq, hd), dtype=torch.float32, device=dev)
    for c in range(nc):
        k0 = c * chunk
        kcb = k[:, k0:k0 + chunk].float()
        vcb = v[:, k0:k0 + chunk].float()
        pad = chunk - kcb.shape[1]
        if pad:  # the last chunk, zero-padded to ``chunk`` keys
            kcb = torch.nn.functional.pad(kcb, (0, 0, 0, 0, 0, pad))
            vcb = torch.nn.functional.pad(vcb, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kcb) * scale
        s = softcap(s, cap)
        col = k0 + torch.arange(chunk, device=dev)[None, :]
        ok = col < sk
        if causal:
            ok = ok & (col <= iq)
        if window is not None:
            ok = ok & (col > iq - window)
        s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                   vcb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.movedim(-2, 1)  # (b, sq, kv, g, hd)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _dispatch_sdpa(q, k, v, *, scale, cap, causal, window, flash_chunk):
    sq, sk = q.shape[1], k.shape[1]
    if sk > FLASH_THRESHOLD:
        return _sdpa_flash(q, k, v, scale=scale, cap=cap, causal=causal,
                           window=window, chunk=flash_chunk)
    iq = torch.arange(sq, device=q.device)[:, None]
    ik = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= ik <= iq
    if window is not None:
        m &= ik > iq - window
    return _sdpa(q, k, v, m[None, None, None, :, :], scale=scale, cap=cap)


def _positions(b, s, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def full_attention(p, x, *, n_heads, n_kv, head_dim, rope_theta,
                   causal=True, window=None, cap=None, qk_norm=False,
                   scale=None, x_kv=None, use_rope=True,
                   return_kv=False, flash_chunk=1024):
    """Train/prefill attention, x (B,S,D); cross-attention when ``x_kv``
    is given (no rope, no causal mask, no window)."""
    b, s, _ = x.shape
    xkv = x if x_kv is None else x_kv
    sk = xkv.shape[1]
    q, k, v = _project_qkv(p, x, xkv, n_heads, n_kv, head_dim,
                           positions_q=_positions(b, s, x.device),
                           positions_kv=_positions(b, sk, x.device),
                           rope_theta=rope_theta, qk_norm=qk_norm,
                           use_rope=use_rope and x_kv is None)
    q = lc(q, "batch", "seq_shard", "heads", None)
    k = lc(k, "batch", None, "heads", None)
    v = lc(v, "batch", None, "heads", None)
    scale = (head_dim ** -0.5) if scale is None else scale
    out = _dispatch_sdpa(q, k, v, scale=scale, cap=cap,
                         causal=causal and x_kv is None,
                         window=window if x_kv is None else None,
                         flash_chunk=flash_chunk)
    out = lc(out, "batch", "seq_shard", "heads", None)
    y = dense(p.wo, out.reshape(b, s, n_heads * head_dim))
    y = lc(y, "batch", None, "embed")
    if return_kv:
        return y, (k, v)
    return y


def cache_len(max_len, window):
    """Local layers keep a rolling cache of ``window`` slots."""
    return max_len if window is None else min(window, max_len)


def init_cache(batch, max_len, n_kv, head_dim, dtype=torch.float32,
               window=None, device=None):
    w = cache_len(max_len, window)
    return {"k": torch.zeros((batch, w, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, w, n_kv, head_dim), dtype=dtype,
                             device=device)}


def cache_axes():
    return {"k": ("batch", "kv_seq", "heads", None),
            "v": ("batch", "kv_seq", "heads", None)}


def prefill_attention(p, x, *, n_heads, n_kv, head_dim, rope_theta,
                      max_len, window=None, cap=None, qk_norm=False,
                      scale=None, use_rope=True, flash_chunk=1024):
    """Full causal attention, and the cache filled for ``max_len``
    positions (a rolling cache keeps the last ``w`` keys, key ``a`` at
    slot ``a % w``)."""
    b, s, _ = x.shape
    pos = _positions(b, s, x.device)
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv, head_dim,
                           positions_q=pos, positions_kv=pos,
                           rope_theta=rope_theta, qk_norm=qk_norm,
                           use_rope=use_rope)
    q = lc(q, "batch", "seq_shard", "heads", None)
    scale_ = (head_dim ** -0.5) if scale is None else scale
    out = _dispatch_sdpa(q, k, v, scale=scale_, cap=cap, causal=True,
                         window=window, flash_chunk=flash_chunk)
    y = dense(p.wo, out.reshape(b, s, n_heads * head_dim))
    w = cache_len(max_len, window)
    if w < s:
        slots = torch.arange(s - w, s, device=x.device) % w
        cache = init_cache(b, w, n_kv, head_dim, k.dtype, device=x.device)
        cache["k"][:, slots] = k[:, s - w:]
        cache["v"][:, slots] = v[:, s - w:]
    else:
        cache = init_cache(b, max_len, n_kv, head_dim, x.dtype, window,
                           device=x.device)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    cache = {kk: lc(vv, "batch", "kv_seq", "heads", None)
             for kk, vv in cache.items()}
    return y, cache


def decode_attention(p, x, cache, pos, *, n_heads, n_kv, head_dim,
                     rope_theta, window=None, cap=None, qk_norm=False,
                     scale=None, cross=False, use_rope=True):
    """One-token decode, x (B,1,D) at position ``pos`` (an int).

    Writes the new key and value into ``cache`` in place and returns
    (y, cache).  A rolling cache (``window`` slots) writes at
    ``pos % window``; keys are stored rotated at their absolute
    positions.  ``cross=True``: the cache holds the projected encoder K/V
    and is not written."""
    b = x.shape[0]
    pos = int(pos)
    clen = cache["k"].shape[1]
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(
        p, x, x, n_heads, n_kv, head_dim, positions_q=posb,
        positions_kv=posb, rope_theta=rope_theta, qk_norm=qk_norm,
        use_rope=use_rope and not cross)
    windowed = window is not None and clen == window
    slot = (pos % clen) if windowed else pos
    if not cross:
        if not 0 <= slot < clen:
            raise ValueError(
                f"decode at position {pos} past a cache of {clen} slots "
                f"(prefill with a larger max_len)")
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache = {kk: lc(vv, "batch", "kv_seq", "heads", None)
                 for kk, vv in cache.items()}
    ik = torch.arange(clen, device=x.device)[None, :]
    if cross:
        m = torch.ones((1, clen), dtype=torch.bool, device=x.device)
    elif windowed:
        m = ik <= pos  # the rolling buffer holds exactly the last W
    else:
        m = ik <= pos
        if window is not None:
            m &= ik > pos - window
    scale_ = (head_dim ** -0.5) if scale is None else scale
    out = _sdpa(q, cache["k"], cache["v"], m[:, None, None, None, :],
                scale=scale_, cap=cap)
    y = dense(p.wo, out.reshape(b, 1, n_heads * head_dim))
    return y, cache
