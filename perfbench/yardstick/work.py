"""The work one point-op call needs: a frozen copy of
``repro_torch.kernels.checks.work``.

It is applied to the call arguments of the benchmark's own reference plan
(``reference/pnn.py``, the same clouds), so the same work is counted
whatever implements it.  ``least_seconds`` is the roofline's floor for a
call: the larger of its bytes over the HBM bandwidth and its operations
over the float32 peak.
"""
from __future__ import annotations

import torch

from perfbench.yardstick.peaks import HBM_BW, PEAK_FLOPS_FP32


def work(name: str, args: dict) -> tuple[float, float]:
    """(bytes, operations) that one call needs on these inputs: each input
    read once and each output written once, but coordinates only of valid
    lanes (masks in full), queries only of blocks whose window has a valid
    lane, and for gather only the distinct in-range feature rows that the
    indices name; operations only on valid lanes, for the steps or ranks
    a block's valid lanes can fill."""
    if name == "fps_blocks":
        m, k = args["mask"], args["k"]
        nb = m.shape[0]
        nv = m.sum(1)
        steps = (nv.clamp(max=k) - 1).clamp(min=0)
        # a step folds the pick into each valid lane: 3 sub, 3 mul, 2 add,
        # min, compare
        return (int(nv.sum()) * 12 + m.numel() + nb * k * 4,
                float((nv * steps).sum()) * 10.0)
    if name in ("ball_query_blocks", "knn_blocks"):
        q, wm, num = args["q"], args["wmask"], args["num"]
        nb, nq = q.shape[:2]
        nv = wm.sum(1)
        live = int((nv > 0).sum())
        # a pair: distance (8), then one compare per rank the row can fill
        ops_ = float((nv * (8 + nv.clamp(max=num))).sum()) * nq
        nbytes = (live * nq * 12 + int(nv.sum()) * 12 + wm.numel()
                  + nb * nq * num * 8)
        if name == "ball_query_blocks":
            cm = args["cmask"]
            ops_ += float((cm.sum(1) * nv).sum()) * 2.0   # radius test, count
            nbytes += cm.numel() + nb * nq * 4
        return nbytes, ops_
    if name == "fractal_level_blocks":
        # reads the mask, the split values and two coordinates of each
        # valid lane; writes the side bits, counts and four extrema; a
        # valid lane costs a compare, a count and two min/max
        m = args["mask"]
        nb, bs = m.shape
        nv = int(m.sum())
        return (m.numel() + nb * 4 + nv * 8 + nb * bs * 4 + nb * 4
                + nb * 16, float(nv) * 4.0)
    if name == "scatter_add_blocks":
        # reads the indices and each in-range cotangent row, writes the
        # whole window tile; one add per in-range (row, channel)
        g, idx, w = args["g"], args["idx"], args["w"]
        nb, _, c = g.shape
        rows = int(((idx >= 0) & (idx < w)).sum())
        return idx.numel() * 4 + rows * c * 4 + nb * w * c * 4, float(rows * c)
    f, idx = args["feats"], args["idx"]
    nb, w, c = f.shape
    ok = (idx >= 0) & (idx < w)
    key = torch.arange(nb, device=idx.device)[:, None] * w + idx.long()
    rows = int(torch.unique(key[ok]).numel())
    return rows * c * 4 + idx.numel() * 4 + idx.numel() * c * 4, 0.0


def least_seconds(name: str, args: dict) -> float:
    """The least time one call could take on one H100."""
    nbytes, ops = work(name, args)
    return max(nbytes / HBM_BW, ops / PEAK_FLOPS_FP32)
