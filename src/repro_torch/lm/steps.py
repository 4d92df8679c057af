"""Step functions and input specs for every (arch x shape) cell.

Counterpart of ``repro.lm.steps``.  ``make_train_step`` returns the step
``train/loop.py`` calls: the loss of ``loss_fn`` (cross entropy plus the
MoE aux terms), its gradient with respect to every parameter, summed over
``microbatch`` equal slices in slice order where asked, then AdamW
(``train/optimizer.py``) in place.  ``make_prefill_step`` and
``make_decode_step`` are the serving steps.  ``batch_specs``,
``prefill_specs`` and ``decode_specs`` give the reference's input shapes
and dtypes as meta tensors, and ``eval_shape_init`` the model on the meta
device: nothing is allocated and nothing drawn, so full configs that do
not fit one card can still be counted (``launch/roofline.py``).

The port holds one tensor a layer where the reference stacks each
pattern position's parameters over reps.  Two rules read the reference's
rank and so see a stacked leaf one axis higher: AdamW's weight decay
(``decay_names``) and the checkpoint layout (``ckpt_tree``, the stacked
``params/scan/...`` arrays of the reference's checkpoints).
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.lm import model as M
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import Stacked


def param_dict(model: M.LM) -> dict:
    """{module path ("blocks/3/attn/wq/w"): parameter} of ``model``, each
    parameter once (a shared block under its first place); the tensors are
    the module's own."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def _layout(cfg: M.LMConfig, model: M.LM) -> dict:
    """{reference path: [names in ``param_dict``]}: one name for a plain or
    shared leaf, one a rep for a stacked one."""
    name_of = {id(p): k for k, p in param_dict(model).items()}
    return {path: [name_of[id(p)] for p in ps]
            for path, ps in M.reference_leaves(cfg, model).items()}


def decay_names(cfg: M.LMConfig, model: M.LM) -> set:
    """The names that AdamW decays: those whose reference leaf has rank
    >= 2.  A stacked leaf has a reps axis more than the port's tensor, so
    every norm gain, bias, ``A_log``, ``D`` and ``dt_bias`` of a layer is
    decayed, and ``lnf/g``, ``enc_lnf/g`` and a shared block's 1-D leaves
    are not, as in the reference."""
    params = param_dict(model)
    out = set()
    for path, names in _layout(cfg, model).items():
        if params[names[0]].ndim + (path[0] in M.STACKS) >= 2:
            out.update(names)
    return out


def ckpt_tree(cfg: M.LMConfig, model: M.LM):
    """``tree(params, opt_state)`` for ``loop.run``: the training state in
    the reference's checkpoint tree, ``{"params", "opt": {"m", "v",
    "step"}}`` keyed by reference path, a stacked leaf a ``Stacked`` of
    the per-layer tensors (reps first).  The leaves are the live tensors:
    a save stacks them on the host, a restore copies into them."""
    layout = _layout(cfg, model)

    def nest(flat: dict) -> dict:
        out = {}
        for path, names in layout.items():
            leaf = (Stacked([flat[n] for n in names])
                    if path[0] in M.STACKS else flat[names[0]])
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return out

    def tree(params: dict, opt_state: dict) -> dict:
        return {"params": nest(params),
                "opt": {"m": nest(opt_state["m"]), "v": nest(opt_state["v"]),
                        "step": opt_state["step"]}}

    return tree


def loss_fn(model: M.LM, cfg: M.LMConfig, batch: dict):
    """-> (loss + aux, (loss, aux)) for a batch of ``tokens`` (or
    ``frames`` + ``dec_tokens`` for an encoder-decoder, ``frames`` for the
    embeddings frontend), ``labels`` and an optional ``loss_mask``."""
    if cfg.encoder_layers:
        hidden, aux = M.forward(model, cfg, frames=batch["frames"],
                                dec_tokens=batch["dec_tokens"])
    elif cfg.frontend == "embeddings":
        hidden, aux = M.forward(model, cfg, frames=batch["frames"])
    else:
        hidden, aux = M.forward(model, cfg, tokens=batch["tokens"])
    loss = M.lm_loss(model, cfg, hidden, batch["labels"],
                     batch.get("loss_mask"))
    return loss + aux, (loss, aux)


def grads_fn(model: M.LM, cfg: M.LMConfig, microbatch: int = 0):
    """``grads(params, batch) -> (grads {name: tensor}, loss, aux)`` of
    ``loss_fn``'s total for ``params`` (``param_dict(model)``).  With
    ``microbatch > 1`` the batch is cut into that many equal slices along
    its first axis; their gradients are summed in slice order from zero
    and divided by ``microbatch``, and so are loss and aux, as the
    reference's ``lax.scan`` does.  A parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives."""
    def one(params, batch):
        tot, (loss, aux) = loss_fn(model, cfg, batch)
        gs = torch.autograd.grad(tot, list(params.values()),
                                 allow_unused=True)
        return ({k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), gs)},
                loss.detach(), aux.detach())

    def grads(params, batch):
        if not microbatch or microbatch <= 1:
            return one(params, batch)
        n = next(iter(batch.values())).shape[0]
        if n % microbatch:
            raise ValueError(f"batch {n} % microbatch {microbatch}")
        mb = n // microbatch
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        loss = aux = 0.0
        for i in range(microbatch):
            g, l_, a = one(params, {k: v[i * mb:(i + 1) * mb]
                                    for k, v in batch.items()})
            for k, t in g.items():
                acc[k].add_(t)
            loss, aux = loss + l_, aux + a
            del g
        return ({k: t / microbatch for k, t in acc.items()},
                loss / microbatch, aux / microbatch)

    return grads


def make_train_step(model: M.LM, cfg: M.LMConfig,
                    opt_cfg: opt_lib.OptConfig, microbatch: int = 0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "aux", "lr", "grad_norm"})``, one AdamW step on ``model``'s
    parameters (``param_dict(model)``) in place, with the reference's
    decay rule (``decay_names``); ``return_grads=True`` returns ``(grads,
    {"loss", "aux"})`` instead, for the loop's error-feedback path."""
    grads = grads_fn(model, cfg, microbatch)
    decay = decay_names(cfg, model)

    def train_step(params, opt_state, batch, return_grads=False):
        g, loss, aux = grads(params, batch)
        if return_grads:
            return g, {"loss": loss, "aux": aux}
        params, opt_state, om = opt_lib.update(opt_cfg, g, opt_state, params,
                                               decay=decay)
        return params, opt_state, {"loss": loss, "aux": aux, **om}

    return train_step


def make_prefill_step(cfg: M.LMConfig, max_len=None):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, tokens=batch.get("tokens"),
                         frames=batch.get("frames"),
                         dec_tokens=batch.get("dec_tokens"),
                         max_len=max_len)

    return prefill_step


def make_decode_step(cfg: M.LMConfig):
    def decode_step(params, token, cache, pos):
        return M.decode_step(params, cfg, token, cache, pos)

    return decode_step


# ---------------------------------------------------------------------------
# Input specs and shapes: meta tensors, nothing allocated
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: M.LMConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.encoder_layers:
        return {"frames": _meta((b, s, cfg.d_model), torch.float32),
                "dec_tokens": _meta((b, s), i32),
                "labels": _meta((b, s), i32)}
    if cfg.frontend == "embeddings":
        return {"frames": _meta((b, s, cfg.d_model), torch.float32),
                "labels": _meta((b, s), i32)}
    return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}


def prefill_specs(cfg: M.LMConfig, shape: ShapeSpec) -> dict:
    sp = batch_specs(cfg, shape)
    sp.pop("labels")
    return sp


def decode_specs(cfg: M.LMConfig, shape: ShapeSpec):
    """(token, cache, pos): one new token, the caches at ``seq_len``."""
    b, s = shape.global_batch, shape.seq_len
    model, _ = eval_shape_init(cfg)
    cache = M.init_cache(model, cfg, b, s,
                         enc_len=s if cfg.encoder_layers else None)
    if cfg.frontend == "embeddings" and not cfg.encoder_layers:
        token = _meta((b, 1, cfg.d_model), torch.float32)
    else:
        token = _meta((b, 1), torch.int32)
    return token, cache, _meta((), torch.int32)


class _OnMeta(TorchFunctionMode):
    """Every factory call that names a device makes its tensor on the meta
    device instead, and draws nothing (``generator`` dropped)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def eval_shape_init(cfg: M.LMConfig):
    """(the ``LM`` on the meta device, the reference's logical-axes tree):
    the shapes and dtypes of ``model.init(cfg)`` with nothing allocated
    and nothing drawn."""
    with _OnMeta():
        return M.init(cfg, device="meta")
