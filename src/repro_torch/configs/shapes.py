"""Assigned input-shape set for the LM-family architectures (40 cells)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Skip rule: long_500k needs a sub-quadratic family (docs/DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, ("skipped: pure full-attention arch; long_500k "
                       "requires sub-quadratic attention (SSM/hybrid)")
    return True, ""
