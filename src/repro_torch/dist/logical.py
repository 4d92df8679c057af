"""Logical axis -> mesh axis rules (MaxText-style), and the shards they
give on a mesh of processes.

Counterpart of ``repro.dist.logical``.  Every tensor dimension in the
model code is named once with a *logical* axis ("batch", "blocks", "ff",
...); a rules dict maps logical names to mesh axes, ``logical_rules``
activates (mesh, rules) for a region of code, and ``lc`` applies the
resulting constraint to a value.

The resolution is the reference's, exactly:

* a rule value is a mesh axis (``"model"``), a tuple of mesh axes
  (``("pod", "data")``) or ``None`` (replicate);
* mesh axes absent from the current mesh are dropped;
* within one spec each mesh axis is used at most once, contested axes
  going to the logical name that comes first in the rules dict.

The port has no ``jax.sharding``: ``P``, ``Mesh`` and ``NamedSharding``
below are small stand-ins with the same fields (``P`` compares as jax's
``PartitionSpec`` does).  Eager PyTorch has no sharding propagation, so
the layouts GSPMD gives the reference implicitly are explicit here:
``shard(x, dim, name)`` is this rank's slice of ``dim`` along the mesh
axes ``name`` maps to, and ``unshard(y, dim, name, size)`` all-gathers it
back.  Both follow ``fit_specs``' rule: where the device count does not
divide the dim, the tensor stays whole on every rank.  A mesh made by
``elastic.make_mesh`` is laid over the ranks of the process world
(``dist/process.py``) and holds one process group for each combination
of its axes; ``lc`` keeps a tensor as it lies (its rank checked), and
refuses only a stand-in mesh of several devices that no process world
backs.  Outside a ``logical_rules`` context ``lc``, ``shard`` and
``unshard`` are the identity and ``spec`` gives ``P()``.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.distributed as dist

# Key order is rule priority (an earlier name wins a contested mesh axis).
RULES_V0 = {
    # activations
    "batch": ("pod", "data"),     # data parallelism (pods x hosts)
    "seq_shard": "model",         # sequence-parallel attention (prefill)
    "kv_seq": "model",            # decode KV-cache sequence
    "blocks": "model",            # fractal leaves
    "expert_cap": "model",        # MoE capacity rows
    # parameters
    "experts": "data",            # expert parallelism
    "embed_fsdp": "data",         # FSDP shard dim of weight matrices
    "ff": "model",                # MLP hidden / fused head dim
    "vocab": "model",             # embedding / logits vocab dim
    "heads": "model",             # attention heads
    "ssm_heads": "model",         # mamba / SSD heads
    # replicated by default (explicit so rules_with can flip them)
    "embed": None,                # activation d_model dim
    "points": None,               # flat per-point tensors
    "layers": None,               # stacked layer / cache leading dim
}


def rules_with(**overrides):
    """RULES_V0 with per-variant overrides (``ff=None``,
    ``points="model"``, ...)."""
    rules = dict(RULES_V0)
    rules.update(overrides)
    return rules


def _canonical(entry):
    """One spec entry as jax canonicalizes it: an empty tuple is ``None``,
    a one-axis tuple is its axis name."""
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if not entry:
        return None
    return entry[0] if len(entry) == 1 else entry


class P(tuple):
    """A partition spec: one entry per dim (``None``, a mesh axis, or a
    tuple of mesh axes), held canonical and compared as jax's
    ``PartitionSpec`` is (``P(("data",), None) == P("data", None)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return tuple.__eq__(self, tuple(_canonical(e) for e in other))

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__

    def __repr__(self):
        return f"PartitionSpec({', '.join(map(repr, self))})"


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` with one dimension per name in ``axis_names``.

    A mesh over the process world (``elastic.make_mesh``) also has
    ``ranks``, the world rank at each position, ``world`` (this process's
    ``process.World``) and ``groups``: for each combination of axes with
    more than one device (axes in mesh order), this rank's process group
    along them and its index in it.  A stand-in has none of them."""

    def __init__(self, devices, axis_names, ranks=None, world=None,
                 groups=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axis "
                             f"names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.ranks = None if ranks is None else np.asarray(ranks)
        self.world = world
        self.groups = dict(groups or {})

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """This process's device on the mesh."""
        if self.world is not None:
            return self.world.device
        return self.devices.flat[0]

    def group(self, axes):
        """(process group, this rank's index in it) along ``axes`` (any
        order), or None where those axes hold one device."""
        axes = tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        size = 1
        for a in key:
            size *= self.shape[a]
        if size == 1:
            return None
        if key not in self.groups:
            raise ValueError(f"a mesh of {self.devices.size} devices that "
                             f"is not laid over the process world "
                             f"(elastic.make_mesh): it has no group along "
                             f"{key} and can hold no shard")
        return self.groups[key]

    def __repr__(self):
        return f"Mesh({self.shape})"


class NamedSharding:
    """A spec bound to a mesh."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class _Ctx:
    """An active (mesh, rules) binding.  Reads only the mesh's
    ``axis_names`` and ``devices.shape``."""

    __slots__ = ("mesh", "rules", "mesh_sizes")

    def __init__(self, mesh, rules):
        self.mesh = mesh
        self.rules = dict(rules)
        self.mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))


_LOCAL = threading.local()


def _stack():
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def current() -> _Ctx | None:
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def logical_rules(mesh, rules):
    """Activate (mesh, rules) for ``lc`` / ``spec`` / ``axis_size``."""
    stack = _stack()
    stack.append(_Ctx(mesh, rules))
    try:
        yield stack[-1]
    finally:
        stack.pop()


def mesh_rules(mesh):
    """``logical_rules(mesh, RULES_V0)``, or no context where ``mesh`` is
    None (one card without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    return logical_rules(mesh, RULES_V0)


def _axis_to_mesh(ctx: _Ctx, axis, used=None):
    """One logical axis -> a spec entry (str | tuple | None), dropping
    mesh axes absent from the mesh or already in ``used``."""
    if axis is None:
        return None
    rule = ctx.rules.get(axis)
    if rule is None:
        return None
    if isinstance(rule, str):
        if rule in ctx.mesh_sizes and (used is None or rule not in used):
            if used is not None:
                used.add(rule)
            return rule
        return None
    kept = tuple(a for a in rule
                 if a in ctx.mesh_sizes and (used is None or a not in used))
    if not kept:
        return None
    if used is not None:
        used.update(kept)
    return kept


def _spec_entries(ctx: _Ctx, axes):
    """All dims of one tensor -> spec entries, assigned in rule-priority
    order so a contested mesh axis goes to the higher-priority name."""
    prio = {name: i for i, name in enumerate(ctx.rules)}
    order = sorted(range(len(axes)),
                   key=lambda d: prio.get(axes[d], len(prio)))
    used: set = set()
    entries = [None] * len(axes)
    for d in order:
        entries[d] = _axis_to_mesh(ctx, axes[d], used)
    return entries


def spec(axes) -> P:
    """Logical axes -> spec under the active context (``P()`` outside)."""
    ctx = current()
    if ctx is None:
        return P()
    return P(*_spec_entries(ctx, tuple(axes)))


def axis_size(name: str) -> int:
    """Product of the mesh-axis sizes a logical axis maps to (1 outside a
    context, or when the axis replicates)."""
    ctx = current()
    if ctx is None:
        return 1
    return _entry_size(ctx.mesh_sizes, _axis_to_mesh(ctx, name))


def lc(x, *axes):
    """Logical constraint: ``lc(x, "batch", None, "ff")``.

    The identity outside a context.  Inside one it checks that there is one
    name a dim and returns ``x`` as it lies: what a rank holds is made
    explicit by ``shard`` / ``unshard``.  A stand-in mesh of several
    devices, which no process world backs, is refused."""
    ctx = current()
    if ctx is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"lc: {len(axes)} axis names for rank-{x.ndim} "
                         f"value {tuple(getattr(x, 'shape', ()))}: {axes}")
    if ctx.mesh.devices.size > 1 and ctx.mesh.world is None:
        raise ValueError(
            f"lc: a stand-in mesh of {ctx.mesh.devices.size} devices; a "
            f"mesh of several comes from elastic.make_mesh over the "
            f"process world")
    return x


def placement(name: str, size: int):
    """Where a dim of ``size`` named ``name`` lies on the active mesh:
    None where every rank holds it whole (outside a context, one device
    along its mesh axes, or a device count that does not divide ``size``:
    ``fit_specs``' rule), else (process group, ways, this rank's index)."""
    ctx = current()
    if ctx is None:
        return None
    entry = _axis_to_mesh(ctx, name)
    ways = _entry_size(ctx.mesh_sizes, entry)
    if ways == 1 or size % ways:
        return None
    group, index = ctx.mesh.group((entry,) if isinstance(entry, str)
                                  else entry)
    return group, ways, index


def _all_gather(y, dim, group, ways):
    parts = [torch.empty_like(y) for _ in range(ways)]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, dim)


def _slice(x, dim, ways, index):
    n = x.shape[dim] // ways
    return x.narrow(dim, index * n, n)


class _Shard(torch.autograd.Function):
    """Forward: this rank's slice.  Backward: the slices' gradients
    all-gathered, so every rank holds the whole gradient of the whole
    input, as each holds the whole input."""

    @staticmethod
    def forward(ctx, x, dim, group, ways, index):
        ctx.args = (dim, group, ways)
        return _slice(x, dim, ways, index).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        dim, group, ways = ctx.args
        return _all_gather(g, dim, group, ways), None, None, None, None


class _Unshard(torch.autograd.Function):
    """Forward: the ranks' slices all-gathered.  Backward: this rank's
    slice of the gradient: every rank consumes the whole output alike, so
    each holds the whole gradient, and its own slice is its share (an
    all-gather whose backward reduce-scatters would count it ``ways``
    times)."""

    @staticmethod
    def forward(ctx, y, dim, group, ways, index):
        ctx.args = (dim, ways, index)
        return _all_gather(y, dim, group, ways)

    @staticmethod
    def backward(ctx, g):
        dim, ways, index = ctx.args
        return (_slice(g, dim, ways, index).contiguous(), None, None, None,
                None)


def shard(x, dim: int, name: str):
    """This rank's slice of ``x`` along ``dim`` over the mesh axes that
    logical axis ``name`` maps to; ``x`` itself where it stays whole
    (``placement``).  Differentiable: the backward all-gathers."""
    where = placement(name, x.shape[dim])
    if where is None:
        return x
    if not x.requires_grad:
        return _slice(x, dim, where[1], where[2])
    return _Shard.apply(x, dim, *where)


def unshard(y, dim: int, name: str, size: int):
    """The whole of a ``dim`` of ``size`` that ``shard`` cut: ``y``, this
    rank's slice, all-gathered over the same axes; ``y`` itself where the
    dim stayed whole.  Differentiable: the backward takes this rank's
    slice."""
    where = placement(name, size)
    if where is None:
        return y
    return _Unshard.apply(y, dim, *where)


def _entry_size(mesh_sizes, entry) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    size = 1
    for a in axes:
        size *= mesh_sizes[a]
    return size


def entry_size(mesh, entry) -> int:
    """Device count along one spec entry (str | tuple | None)."""
    return _entry_size(dict(zip(mesh.axis_names, mesh.devices.shape)),
                       entry)


def _is_axes_leaf(node) -> bool:
    """Leaves of a logical-axes tree: None, or a tuple of axis names."""
    return node is None or (
        isinstance(node, tuple)
        and all(e is None or isinstance(e, str) for e in node))


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts, lists and tuples; ``rest``
    are trees of the same structure whose leaves ride along."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree keys {sorted(tree)} vs "
                                 f"{sorted(r) if isinstance(r, dict) else r}")
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for r in rest:
            if len(r) != len(tree):
                raise ValueError(f"tree of {len(tree)} entries vs {len(r)}")
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def fit_specs(shard_tree, shape_tree, mesh):
    """Null out spec entries whose device count does not divide the dim.
    A ``shape_tree`` leaf is a tensor (anything with a ``shape``) or a
    shape."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def one(sh, val):
        shape = getattr(val, "shape", val)
        new = []
        for dim, entry in enumerate(sh.spec):
            if entry is not None and shape[dim] % _entry_size(sizes, entry):
                entry = None
            new.append(entry)
        return NamedSharding(mesh, P(*new))

    return tree_map(one, shard_tree, shape_tree)


def param_specs(axes_tree, mesh, rules=None):
    """Logical-axes tree -> NamedSharding tree.  ``None`` leaves replicate
    (``P()``); mesh axes absent from ``mesh`` are dropped."""
    ctx = _Ctx(mesh, RULES_V0 if rules is None else rules)

    def one(axes):
        if axes is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(*_spec_entries(ctx, axes)))

    return tree_map(one, axes_tree, is_leaf=_is_axes_leaf)
