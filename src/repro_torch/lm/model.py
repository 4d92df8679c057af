"""The LM: ``reps`` repetitions of a block ``pattern``: the full forward
and loss that training differentiates (``lm/steps.py``), and prefill and
greedy decode for serving.

Counterpart of ``repro.lm.model``, for every block kind of the ten
architectures of ``configs``: the attention kinds (``attn``, ``local``,
``xattn``, ``enc_attn``), ``moe`` (attention and a mixture-of-experts
FFN), ``mamba``, ``mlstm``, ``slstm`` (``ln1`` and a mixer ``mix``, no
FFN) and ``shared_attn``.  The reference stacks each pattern position's
parameters over reps and runs the stack under ``lax.scan``; here an
``LM`` holds one ``Block`` a layer in a ``ModuleList`` (rep major: layer
``r * len(pattern) + i`` is pattern position ``i`` of rep ``r``), and the
stack is a Python loop.  A ``shared_attn`` position is one ``Block``,
held once under ``LM.shared`` and placed at that position of every rep
(the same module, so its parameters count once); each rep keeps its own
cache.  The reference's ``scan_layers``, ``remat`` and ``unroll_inner``
(how XLA lays out the stack; no ported config sets them) are not fields
here, so a config that sets one is refused; so is ``MoEOpts.dispatch``,
whose ``grouped_a2a`` is ``global_sort`` on one card.  The decode cache
is a list with one dict a rep (the reference stacks it over reps), and
``decode_step`` updates it in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist.logical import _is_axes_leaf, lc, tree_map
from repro_torch.lm import attention as attn
from repro_torch.lm import moe as moe_lib
from repro_torch.lm import ssm as ssm_lib
from repro_torch.lm import xlstm as xlstm_lib
from repro_torch.lm.layers import embed_init, mlp, mlp_init, rmsnorm, \
    rmsnorm_init, rounded, softcap


@dataclasses.dataclass(frozen=True)
class MoEOpts:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_ff: int = 0
    router_act: str = "softmax"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    n_layers: int                       # decoder layers (== reps*len(pattern))
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    pattern: tuple = ("attn",)
    rope_theta: float = 10_000.0
    window: int | None = None           # for "local" blocks
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    attn_scale: float | None = None
    post_norm: bool = False             # gemma2 sandwich
    mlp_kind: str = "swiglu"
    moe: MoEOpts | None = None
    ssm: ssm_lib.SSMConfig | None = None
    xlstm: xlstm_lib.XLSTMConfig | None = None
    encoder_layers: int = 0             # >0 => encoder-decoder
    emb_scale: bool = False
    tie_embeddings: bool = True
    vocab_pad_to: int = 256
    param_dtype: str = "float32"
    dtype: str = "bfloat16"             # activation/compute dtype
    frontend: str = "tokens"            # tokens | embeddings (audio stub)
    long_context_ok: bool = False       # sub-quadratic: run long_500k
    loss_chunk: int = 1024
    flash_chunk: int = 1024             # KV-chunked attention block size

    @property
    def hd(self):
        return self.head_dim or self.d_model // self.n_heads

    @property
    def reps(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers % "
                             f"pattern {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self):
        m = self.vocab_pad_to
        return (self.vocab + m - 1) // m * m

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def attn_kwargs(self, kind):
        return dict(n_heads=self.n_heads, n_kv=self.n_kv_heads,
                    head_dim=self.hd, rope_theta=self.rope_theta,
                    window=self.window
                    if kind in ("local", "shared_attn") else None,
                    cap=self.attn_softcap, qk_norm=self.qk_norm,
                    scale=self.attn_scale)


ATTN_KINDS = ("attn", "local", "moe", "shared_attn", "xattn", "enc_attn")
SHARED_KINDS = ("shared_attn",)
# The reference's parameter subtrees stacked over reps (a leading axis).
STACKS = ("scan", "enc_scan")


class Mixer(NamedTuple):
    """A mixer kind's functions: ``init``, ``forward``, ``decode``, its
    decode ``state(batch, d, cfg, dtype, device)`` and ``state_axes()``."""
    init: Callable
    forward: Callable
    decode: Callable
    state: Callable
    state_axes: Callable


# The mixer kinds: ``ln1`` and ``mix``.
MIXERS = {
    "mamba": Mixer(ssm_lib.mamba2_init, ssm_lib.mamba2_forward,
                   ssm_lib.mamba2_decode,
                   lambda b, d, c, dt, dev: ssm_lib.init_state(
                       b, d, c, dt, device=dev),
                   ssm_lib.state_axes),
    "mlstm": Mixer(xlstm_lib.mlstm_init, xlstm_lib.mlstm_forward,
                   xlstm_lib.mlstm_decode,
                   lambda b, d, c, dt, dev: xlstm_lib.mlstm_state(
                       b, d, c, device=dev),
                   xlstm_lib.mlstm_state_axes),
    "slstm": Mixer(xlstm_lib.slstm_init, xlstm_lib.slstm_forward,
                   xlstm_lib.slstm_decode,
                   lambda b, d, c, dt, dev: xlstm_lib.slstm_state(
                       b, d, c, device=dev),
                   xlstm_lib.slstm_state_axes)}


def _mix_cfg(cfg: LMConfig, kind):
    return cfg.ssm if kind == "mamba" else cfg.xlstm


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer.  Attention kinds: ``ln1``, ``attn``, ``ln2``, ``ffn`` (a
    ``moe.MoE`` for ``moe``); ``pn1``/``pn2`` with ``post_norm``;
    ``xattn``/``lnx`` for ``xattn``.  ``mamba``/``mlstm``/``slstm``:
    ``ln1`` and ``mix``."""


class LM(nn.Module):
    """``emb``, ``blocks`` (reps x pattern, rep major), ``shared`` (the
    shared positions' blocks, also placed in ``blocks``), ``lnf``; ``head``
    when the embeddings are not tied; ``enc_blocks`` and ``enc_lnf`` for an
    encoder-decoder."""


def _check_kinds(cfg: LMConfig) -> None:
    if cfg.frontend not in ("tokens", "embeddings"):
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r}")
    for kind in cfg.pattern:
        if kind not in ATTN_KINDS and kind not in MIXERS:
            raise ValueError(kind)


def _block_init(gen, cfg: LMConfig, kind: str):
    d, dt = cfg.d_model, cfg.pdtype
    p, a = Block(), {}
    p.ln1, a["ln1"] = rmsnorm_init(d, dt, gen.device)
    if kind in MIXERS:
        p.mix, a["mix"] = MIXERS[kind].init(gen, d, _mix_cfg(cfg, kind),
                                            dt)
        return p, a
    p.attn, a["attn"] = attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.hd, qk_norm=cfg.qk_norm, dtype=dt)
    p.ln2, a["ln2"] = rmsnorm_init(d, dt, gen.device)
    if cfg.post_norm:
        p.pn1, a["pn1"] = rmsnorm_init(d, dt, gen.device)
        p.pn2, a["pn2"] = rmsnorm_init(d, dt, gen.device)
    if kind == "xattn":
        p.xattn, a["xattn"] = attn.attn_init(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, qk_norm=False,
            dtype=dt)
        p.lnx, a["lnx"] = rmsnorm_init(d, dt, gen.device)
    if kind == "moe":
        p.ffn, a["ffn"] = moe_lib.moe_init(
            gen, d, cfg.moe.d_ff_expert, cfg.moe.num_experts,
            kind=cfg.mlp_kind, shared_ff=cfg.moe.shared_ff, dtype=dt)
    else:
        p.ffn, a["ffn"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind, dtype=dt)
    return p, a


def _stack_init(gen, cfg: LMConfig, pattern, reps):
    """(ModuleList of reps x pattern blocks, the reference's axes tree of
    the stacked params: a leading "layers" axis on every named leaf; the
    shared positions' blocks, made once and placed in every rep, and their
    axes)."""
    blocks, axes = nn.ModuleList(), {}
    shared, shared_axes = nn.ModuleDict(), {}
    for i, kind in enumerate(pattern):
        if kind in SHARED_KINDS:
            name = f"b{i}_{kind}"
            shared[name], shared_axes[name] = _block_init(gen, cfg, kind)
    for _ in range(reps):
        for i, kind in enumerate(pattern):
            name = f"b{i}_{kind}"
            if kind in SHARED_KINDS:
                blocks.append(shared[name])
                continue
            block, a = _block_init(gen, cfg, kind)
            blocks.append(block)
            axes[name] = tree_map(
                lambda ax: None if ax is None else ("layers",) + tuple(ax),
                a, is_leaf=_is_axes_leaf)
    return blocks, axes, shared, shared_axes


def init(cfg: LMConfig, generator: torch.Generator | None = None,
         device=None):
    """Returns (``LM``, the reference's logical-axes tree).

    Weights are drawn from ``generator`` (default: a CPU generator seeded
    0) on its device and moved to ``device``: ``None`` is the card, and
    raises where there is none."""
    device = resolve_device(device)
    _check_kinds(cfg)
    gen = torch.Generator().manual_seed(0) if generator is None \
        else generator
    p, a = LM(), {}
    p.emb, a["emb"] = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                 cfg.pdtype)
    p.blocks, a["scan"], p.shared, a["shared"] = _stack_init(
        gen, cfg, cfg.pattern, cfg.reps)
    p.lnf, a["lnf"] = rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device)
    if not cfg.tie_embeddings:
        p.head, a["head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       cfg.pdtype)
    if cfg.encoder_layers:
        p.enc_blocks, a["enc_scan"], _, _ = _stack_init(
            gen, cfg, ("enc_attn",), cfg.encoder_layers)
        p.enc_lnf, a["enc_lnf"] = rmsnorm_init(cfg.d_model, cfg.pdtype,
                                               gen.device)
    return p.to(device), a


def reference_leaves(cfg: LMConfig, model: LM) -> dict:
    """{path in the reference's parameter tree: [parameters]}: one
    parameter for a plain leaf and for a shared block's leaf (under
    ``shared``), one a rep (in rep order) for a leaf of a stacked layer
    (under ``scan`` / ``enc_scan``)."""
    out = {("emb", "w"): [model.emb.w], ("lnf", "g"): [model.lnf.g]}
    if not cfg.tie_embeddings:
        out[("head", "w")] = [model.head.w]
    for block_name, block in model.shared.items():
        for name, param in block.named_parameters():
            out[("shared", block_name, *name.split("."))] = [param]
    stacks = [("scan", model.blocks, cfg.pattern)]
    if cfg.encoder_layers:
        out[("enc_lnf", "g")] = [model.enc_lnf.g]
        stacks.append(("enc_scan", model.enc_blocks, ("enc_attn",)))
    for key, blocks, pattern in stacks:
        n = len(pattern)
        for i, kind in enumerate(pattern):
            if kind in SHARED_KINDS:
                continue
            reps = blocks[i::n]
            for name, _ in reps[0].named_parameters():
                out[(key, f"b{i}_{kind}", *name.split("."))] = [
                    r.get_parameter(name) for r in reps]
    return out



# ---------------------------------------------------------------------------
# forward blocks (full-sequence path)
# ---------------------------------------------------------------------------

def _moe_kw(cfg: LMConfig):
    return dict(n_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                kind=cfg.mlp_kind, capacity_factor=cfg.moe.capacity_factor,
                router_act=cfg.moe.router_act, shared=cfg.moe.shared_ff > 0)


def _block_fwd(p, cfg: LMConfig, kind, x, enc_out=None):
    """-> (x, the block's MoE aux loss or None)."""
    if kind in MIXERS:
        y = MIXERS[kind].forward(p.mix, rmsnorm(p.ln1, x), d=cfg.d_model,
                                 cfg=_mix_cfg(cfg, kind))
        return lc(x + y, "batch", None, "embed"), None
    h = rmsnorm(p.ln1, x)
    y = attn.full_attention(p.attn, h, causal=kind != "enc_attn",
                            flash_chunk=cfg.flash_chunk,
                            **cfg.attn_kwargs(kind))
    if cfg.post_norm:
        y = rmsnorm(p.pn1, y)
    x = x + y
    if kind == "xattn":
        h = rmsnorm(p.lnx, x)
        y = attn.full_attention(p.xattn, h, x_kv=enc_out, causal=False,
                                use_rope=False, flash_chunk=cfg.flash_chunk,
                                **cfg.attn_kwargs(kind))
        x = x + y
    h = rmsnorm(p.ln2, x)
    aux = None
    if kind == "moe":
        y, mo = moe_lib.moe_apply(p.ffn, h, **_moe_kw(cfg))
        aux = 0.01 * mo["aux_lb"] + 0.001 * mo["aux_z"]
    else:
        y = mlp(p.ffn, h, cfg.mlp_kind)
    if cfg.post_norm:
        y = rmsnorm(p.pn2, y)
    x = x + y
    return lc(x, "batch", None, "embed"), aux


def _layers(blocks, pattern):
    """(kind, block) over the stack, rep by rep."""
    n = len(pattern)
    return [(pattern[j % n], b) for j, b in enumerate(blocks)]


def _run_stack(blocks, cfg: LMConfig, x, pattern, enc_out=None):
    """-> (x, the sum of the MoE blocks' aux losses, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in _layers(blocks, pattern):
        x, a = _block_fwd(p, cfg, kind, x, enc_out)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: LMConfig, tokens):
    x = params.emb.w[tokens].to(cfg.act_dtype)
    if cfg.emb_scale:
        x = x * rounded(cfg.d_model ** 0.5, cfg.act_dtype)
    return lc(x, "batch", None, "embed")


def encode(params: LM, cfg: LMConfig, frames):
    """Encoder of an enc-dec model; frames (B, S, D) from the frontend
    stub."""
    x = lc(frames.to(cfg.act_dtype), "batch", None, "embed")
    x, _ = _run_stack(params.enc_blocks, cfg, x, ("enc_attn",))
    return rmsnorm(params.enc_lnf, x)


def _inputs(params, cfg, tokens, frames, dec_tokens):
    """(decoder input embeddings, encoder output or None).  The
    ``embeddings`` frontend (an audio stub) feeds ``frames`` (B, S, D) to
    the decoder as they are."""
    if cfg.encoder_layers:
        return (embed_tokens(params, cfg, dec_tokens),
                encode(params, cfg, frames))
    if cfg.frontend == "embeddings":
        return lc(frames.to(cfg.act_dtype), "batch", None, "embed"), None
    return embed_tokens(params, cfg, tokens), None


def forward(params: LM, cfg: LMConfig, tokens=None, frames=None,
            dec_tokens=None):
    """Full-sequence forward -> (hidden (B,S,D), aux): aux is the sum over
    the MoE layers of ``0.01 * aux_lb + 0.001 * aux_z`` (0 without one)."""
    x, enc_out = _inputs(params, cfg, tokens, frames, dec_tokens)
    x, aux = _run_stack(params.blocks, cfg, x, cfg.pattern, enc_out=enc_out)
    return rmsnorm(params.lnf, x), aux


def _head(params: LM, cfg: LMConfig):
    return params.emb.w if cfg.tie_embeddings else params.head.w


def logits_for(params: LM, cfg: LMConfig, hidden):
    """(B, T, D) -> (B, T, padded_vocab); the padded vocab is masked to
    -1e30 after the final softcap."""
    w = _head(params, cfg)
    logits = hidden @ w.to(hidden.dtype).T
    logits = softcap(logits, cfg.final_softcap)
    mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(mask, logits, -1e30)


def lm_loss(params: LM, cfg: LMConfig, hidden, targets, loss_mask=None):
    """Sequence-chunked cross entropy (no (T, V) logits at once)."""
    b, s, d = hidden.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} % loss_chunk {c}")
    w = _head(params, cfg)
    mask = torch.arange(cfg.padded_vocab, device=hidden.device) < cfg.vocab
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.bool,
                               device=hidden.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        h = hidden[:, i * c:(i + 1) * c]
        t = targets[:, i * c:(i + 1) * c]
        m = loss_mask[:, i * c:(i + 1) * c]
        logits = (h @ w.to(h.dtype).T).float()
        logits = softcap(logits, cfg.final_softcap)
        logits = torch.where(mask, logits, -1e30)
        logits = lc(logits, "batch", None, "vocab")
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, t[..., None].long())[..., 0]
        nll = torch.where(m, lse - ll, 0.0)
        tot = tot + nll.sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# serving: prefill + decode (a list of per-rep cache dicts)
# ---------------------------------------------------------------------------

def init_cache(params: LM, cfg: LMConfig, batch, max_len, enc_len=None):
    """Zero caches: one dict a rep, one entry a pattern position."""
    device = params.emb.w.device
    dt = cfg.act_dtype

    def one(kind):
        if kind == "xattn":
            return {"self": attn.init_cache(batch, max_len, cfg.n_kv_heads,
                                            cfg.hd, dt, device=device),
                    "cross": attn.init_cache(batch, enc_len, cfg.n_kv_heads,
                                             cfg.hd, dt, device=device)}
        if kind in MIXERS:
            return MIXERS[kind].state(batch, cfg.d_model,
                                      _mix_cfg(cfg, kind), dt, device)
        return attn.init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dt,
                               window=cfg.window if kind in
                               ("local", "shared_attn") else None,
                               device=device)

    return [{f"b{i}_{kind}": one(kind) for i, kind in enumerate(cfg.pattern)}
            for _ in range(cfg.reps)]


def cache_axes(cfg: LMConfig):
    """The reference's logical axes of the (stacked) cache."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "xattn":
            one = {"self": attn.cache_axes(), "cross": attn.cache_axes()}
        elif kind in MIXERS:
            one = MIXERS[kind].state_axes()
        else:
            one = attn.cache_axes()
        out[f"b{i}_{kind}"] = tree_map(lambda ax: ("layers",) + tuple(ax),
                                       one, is_leaf=_is_axes_leaf)
    return out


def _ffn(p, cfg: LMConfig, kind, h, no_drop=False):
    """The FFN half of an attention block: the MoE (dropping at the
    capacity factor, or none dropped for a decode step) or the MLP."""
    if kind == "moe":
        return moe_lib.moe_ffn(p.ffn, h, no_drop=no_drop, **_moe_kw(cfg))
    return mlp(p.ffn, h, cfg.mlp_kind)


def _block_decode(p, cfg: LMConfig, kind, x, cache, pos):
    if kind in MIXERS:
        y, cache = MIXERS[kind].decode(p.mix, rmsnorm(p.ln1, x), cache,
                                        d=cfg.d_model, cfg=_mix_cfg(cfg, kind))
        return x + y, cache
    if kind == "xattn":
        h = rmsnorm(p.ln1, x)
        y, new_self = attn.decode_attention(p.attn, h, cache["self"], pos,
                                            **cfg.attn_kwargs(kind))
        x = x + y
        h = rmsnorm(p.lnx, x)
        y, _ = attn.decode_attention(p.xattn, h, cache["cross"], pos,
                                     cross=True, use_rope=False,
                                     **cfg.attn_kwargs(kind))
        x = x + y
        h = rmsnorm(p.ln2, x)
        x = x + mlp(p.ffn, h, cfg.mlp_kind)
        return x, {"self": new_self, "cross": cache["cross"]}
    h = rmsnorm(p.ln1, x)
    y, cache = attn.decode_attention(p.attn, h, cache, pos,
                                     **cfg.attn_kwargs(kind))
    if cfg.post_norm:
        y = rmsnorm(p.pn1, y)
    x = x + y
    h = rmsnorm(p.ln2, x)
    y = _ffn(p, cfg, kind, h, no_drop=True)
    if cfg.post_norm:
        y = rmsnorm(p.pn2, y)
    return x + y, cache


@torch.inference_mode()
def decode_step(params: LM, cfg: LMConfig, token, cache, pos):
    """One decode step: token (B,1) (or (B,1,D) embeddings) at position
    ``pos``.  Returns (logits (B,1,V), cache), the cache updated in
    place."""
    if cfg.frontend == "embeddings" and token.ndim == 3:
        x = token.to(cfg.act_dtype)
    else:
        x = embed_tokens(params, cfg, token)
    n = len(cfg.pattern)
    for j, (kind, p) in enumerate(_layers(params.blocks, cfg.pattern)):
        rep, name = cache[j // n], f"b{j % n}_{kind}"
        x, rep[name] = _block_decode(p, cfg, kind, x, rep[name], pos)
    h = rmsnorm(params.lnf, x)
    return logits_for(params, cfg, h), cache


def _block_prefill(p, cfg: LMConfig, kind, x, max_len, enc_out=None):
    if kind in MIXERS:
        y, state = MIXERS[kind].forward(p.mix, rmsnorm(p.ln1, x),
                                        d=cfg.d_model, cfg=_mix_cfg(cfg, kind),
                                        return_state=True)
        return x + y, state
    h = rmsnorm(p.ln1, x)
    y, kv = attn.prefill_attention(p.attn, h, max_len=max_len,
                                   flash_chunk=cfg.flash_chunk,
                                   **cfg.attn_kwargs(kind))
    if kind == "xattn":
        x = x + y
        h = rmsnorm(p.lnx, x)
        y, xkv = attn.full_attention(p.xattn, h, x_kv=enc_out,
                                     causal=False, use_rope=False,
                                     return_kv=True,
                                     flash_chunk=cfg.flash_chunk,
                                     **cfg.attn_kwargs(kind))
        x = x + y
        h = rmsnorm(p.ln2, x)
        x = x + mlp(p.ffn, h, cfg.mlp_kind)
        return x, {"self": kv, "cross": {"k": xkv[0], "v": xkv[1]}}
    if cfg.post_norm:
        y = rmsnorm(p.pn1, y)
    x = x + y
    h = rmsnorm(p.ln2, x)
    y = _ffn(p, cfg, kind, h)
    if cfg.post_norm:
        y = rmsnorm(p.pn2, y)
    return x + y, kv


@torch.inference_mode()
def prefill(params: LM, cfg: LMConfig, tokens=None, frames=None,
            dec_tokens=None, max_len=None):
    """The full forward that also fills the caches for ``max_len``
    positions.  Returns (last-position logits (B,1,V), cache)."""
    s = (dec_tokens if dec_tokens is not None else
         tokens if tokens is not None else frames).shape[1]
    max_len = max_len or s
    x, enc_out = _inputs(params, cfg, tokens, frames, dec_tokens)
    n = len(cfg.pattern)
    cache = [{} for _ in range(cfg.reps)]
    for j, (kind, p) in enumerate(_layers(params.blocks, cfg.pattern)):
        x, cache[j // n][f"b{j % n}_{kind}"] = _block_prefill(
            p, cfg, kind, x, max_len, enc_out)
    h = rmsnorm(params.lnf, x)
    return logits_for(params, cfg, h[:, -1:, :]), cache
