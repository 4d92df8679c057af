"""Roofline terms of one step measured on one card.

compute term    = counted FLOPs / peak FLOP/s (float32; bfloat16 for an LM
                  cell whose activations are bfloat16)
memory term     = counted bytes / HBM bytes/s
collective term = collective wire bytes / NVLink bytes/s (0 on one card)

Counterpart of ``repro.launch.roofline``, whose terms come from a compiled
XLA artifact (``cost_analysis()``, the HLO text, ``memory_analysis()``).
PyTorch runs the step instead, so ``analyze`` takes what a run gives:
the FLOPs that ``torch.utils.flop_counter.FlopCounterMode`` counts (the
matmuls) plus the hand-written kernels' operations, the bytes every
PyTorch operation of the step reads and writes (each input once, each
output once, views and empty allocations left out, like XLA's "bytes
accessed") plus the kernels' bytes (``kernels.checks.work``), the peak
of ``torch.cuda.max_memory_allocated()`` and the step's measured time.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.lm import model as M

# NVIDIA H100 SXM published rates (NVIDIA data sheet), for the card the
# port is measured on: "NVIDIA H100 80GB HBM3, 700.00 W" as
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` reports
# it.  The port's MLPs run in float32 with TF32 off, outside the tensor
# cores; an LM in bfloat16 runs its matmuls on them.  One card moves no
# collective bytes; the NVLink rate (per direction) stands for a mesh
# that does.
PEAK_FLOPS_FP32 = 67e12       # FLOP/s
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense, on the tensor cores
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # counted per step (matmuls + kernels)
    hlo_bytes: float            # counted per step (operations + kernels)
    coll_bytes: float           # collective wire bytes (0 on one card)
    coll_by_kind: dict
    coll_count: dict
    model_flops: float          # useful flops
    mem_per_device: dict
    step_s: float = 0.0         # measured: median step on the device
    peak_flops: float = PEAK_FLOPS_FP32

    @property
    def t_compute(self):
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self):
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def usefulness(self):
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self):
        """useful-FLOPs time / achievable step time (dominant term)."""
        t_star = self.model_flops / (self.chips * self.peak_flops)
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return t_star / t if t else 0.0

    @property
    def bound_fraction(self):
        """dominant term / measured step time: how near the step ran to
        the least time its counted work needs."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return t / self.step_s if self.step_s else 0.0

    def to_dict(self):
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "coll_count": self.coll_count,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "usefulness": self.usefulness,
            "roofline_fraction": self.roofline_fraction,
            "mem_per_device": self.mem_per_device,
            "step_s": self.step_s,
            "bound_fraction": self.bound_fraction,
        }


class ByteCounter(TorchDispatchMode):
    """Sum the bytes of every tensor each PyTorch operation reads and
    writes.  Views (outputs that alias an input) and empty allocations
    move nothing and are left out."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        name = schema.name.split("::")[-1]
        if not (name.startswith(("empty", "new_empty"))
                or any(r.alias_info is not None and not r.alias_info.is_write
                       for r in schema.returns)):
            for t in pytree.tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def analyze(*, arch, shape, flops, nbytes, peak_bytes, argument_bytes,
            output_bytes, step_s, model_flops, mesh_name, chips=1,
            peak_flops=PEAK_FLOPS_FP32):
    """A ``Roofline`` from one step's counts and measurements: ``flops``
    and ``nbytes`` counted over the step, ``peak_bytes`` the device's
    allocation peak during it, ``argument_bytes`` / ``output_bytes`` what
    its inputs (parameters, optimizer state, clouds) and outputs hold, and
    ``step_s`` its measured time."""
    mem = {
        "argument_mb": argument_bytes / 2**20,
        "output_mb": output_bytes / 2**20,
        "temp_mb": max(peak_bytes - argument_bytes - output_bytes, 0) / 2**20,
        "peak_mb": peak_bytes / 2**20,
    }
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=float(flops), hlo_bytes=float(nbytes),
                    coll_bytes=0.0, coll_by_kind={}, coll_count={},
                    model_flops=model_flops, mem_per_device=mem,
                    step_s=step_s, peak_flops=peak_flops)


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful work) estimators, over the port's LM (or the meta
# model of ``lm.steps.eval_shape_init``)
# ---------------------------------------------------------------------------

def count_params(model) -> int:
    """Parameters of ``model``; a shared block counts once."""
    return sum(p.numel() for p in model.parameters())


def active_params(cfg, model) -> float:
    """Params touched per token: MoE experts scaled by top_k/num_experts.

    The reference's rule, over its stacked tree: a leaf under ``ffn``
    named ``wi``/``wg``/``wo`` of rank >= 3 is an expert, and a stacked
    leaf has the reps axis in its rank.  So llama4-scout's shared expert
    (``ffn/shared/w*/w``, rank 3 once stacked) is scaled too; the port
    keeps the reference's number (ROADMAP.md §C)."""
    total, expert, expert_active = 0, 0, 0
    for path, ps in sorted(M.reference_leaves(cfg, model).items()):
        n = sum(p.numel() for p in ps)
        ndim = ps[0].ndim + (path[0] in M.STACKS)
        total += n
        if cfg.moe and "ffn" in path and any(
                k in ("wi", "wg", "wo") for k in path) and ndim >= 3:
            expert += n
            expert_active += n * cfg.moe.top_k / cfg.moe.num_experts
    return total - expert + expert_active


def model_flops_for(cfg, shape_kind: str, seq: int, batch: int,
                    n_active: float) -> float:
    """Useful FLOPs of one step (global). Sliding-window (local) layers
    only attend over min(window, context)."""
    tokens = batch * seq

    def att_ctx(kind, s):
        if kind in ("local", "shared_attn") and cfg.window:
            return min(cfg.window, s)
        return s

    att_kinds = [k for k in cfg.pattern
                 if k in ("attn", "local", "moe", "shared_attn", "xattn")]
    h_hd = cfg.n_heads * cfg.hd
    if shape_kind == "train":
        dense = 6.0 * n_active * tokens
        att = sum(3.0 * 4.0 * h_hd * cfg.reps * batch * seq
                  * (att_ctx(k, seq) / 2) for k in att_kinds)
        return dense + att
    if shape_kind == "prefill":
        dense = 2.0 * n_active * tokens
        att = sum(4.0 * h_hd * cfg.reps * batch * seq
                  * (att_ctx(k, seq) / 2) for k in att_kinds)
        return dense + att
    # decode: one token per sequence in the batch
    dense = 2.0 * n_active * batch
    att = sum(4.0 * h_hd * cfg.reps * batch * att_ctx(k, seq)
              for k in att_kinds)
    return dense + att


def format_table(rows):
    head = (f"{'arch':22s} {'shape':12s} {'mesh':9s} "
            f"{'t_comp':>9s} {'t_mem':>9s} {'t_coll':>9s} "
            f"{'bound':>6s} {'useful':>7s} {'roofline':>8s} {'peakGB':>7s}")
    lines = [head, "-" * len(head)]
    for r in rows:
        d = r.to_dict() if isinstance(r, Roofline) else r
        lines.append(
            f"{d['arch']:22s} {d['shape']:12s} {d['mesh']:9s} "
            f"{d['t_compute_s']*1e3:8.2f}m {d['t_memory_s']*1e3:8.2f}m "
            f"{d['t_collective_s']*1e3:8.2f}m {d['bottleneck'][:6]:>6s} "
            f"{d['usefulness']*100:6.1f}% {d['roofline_fraction']*100:7.1f}% "
            f"{d['mem_per_device']['peak_mb']/1024:6.2f}")
    return "\n".join(lines)
