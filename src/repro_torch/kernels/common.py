"""Shared constants and plain-PyTorch building blocks of the point kernels.

The plain versions spell every float operation out as a separate tensor op,
in a fixed order, so that they round the same way on the CPU and on the
card, and the same way as the CUDA kernels, which use the ``__f*_rn``
intrinsics to keep ``nvcc`` from contracting them into FMAs:

* ``|a|^2 = (ax*ax + ay*ay) + az*az``;
* ``a.b   = (ax*bx + ay*by) + az*bz``;
* ``d2    = (|a|^2 + |b|^2) - 2*a.b`` (the expanded form of the JAX
  package's ``sqdist_rows``, which may cancel slightly below zero).

Top-k selection is repeated masked argmin: each round takes the smallest
value of a row, the lowest lane on ties, and pins it to ``INF``.  Once a
row's finite lanes are used up every lane holds ``INF``, so the remaining
rounds all return lane 0 with ``d2 = INF`` -- the exhaustion contract of
the JAX package's ``argmin_extract``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

NEG = -3.0e38
INF = 3.0e38


def f32_square(x: float) -> float:
    """float32(x) ** 2 rounded to float32, as a Python float (exact in
    double), so it enters tensor ops as a scalar and needs no copy to the
    device."""
    x32 = np.float32(x)
    return float(x32 * x32)


def on_card(*tensors: torch.Tensor) -> bool:
    """Kernel selection follows the device: True when every tensor lies on
    the card (launch the kernel), False when every one lies on the CPU (run
    the plain version).  Anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on the card, "
                     f"got {sorted(kinds)}")


@contextlib.contextmanager
def launching_on(t: torch.Tensor):
    """The device guard of a launch: ``t``'s card is current for the call
    (the launchers read ``cudaGetDevice``) and the handle of that card's
    current stream is yielded, whichever card the process has current."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Check a kernel argument: dtype, shape (None matches any size) and
    contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) squared norms, summed in x, y, z order."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def sqdist_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., R, 3), b (..., N, 3) -> (..., R, N) expanded-form squared
    distances."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    cross = (a_[..., 0] * b_[..., 0] + a_[..., 1] * b_[..., 1]
             + a_[..., 2] * b_[..., 2])
    return (sqnorm(a)[..., :, None] + sqnorm(b)[..., None, :]) - 2.0 * cross


def argmin_extract(d: torch.Tensor, num: int):
    """d (..., N): the ``num`` smallest per row by repeated masked argmin.
    Returns (idx (..., num) int32, val (..., num))."""
    idxs, vals = [], []
    lane = torch.arange(d.shape[-1], device=d.device)
    for _ in range(num):
        v, i = torch.min(d, dim=-1)
        # torch.min's index is not specified on ties; the contract is the
        # lowest lane holding the minimum.
        i = torch.where(d == v[..., None], lane, d.shape[-1]).amin(-1)
        idxs.append(i.to(torch.int32))
        vals.append(v)
        d = torch.where(lane == i[..., None], INF, d)
    return torch.stack(idxs, -1), torch.stack(vals, -1)


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (...) int64 index of the first maximum."""
    lane = torch.arange(x.shape[-1], device=x.device)
    m = x.amax(-1, keepdim=True)
    return torch.where(x == m, lane, x.shape[-1]).amin(-1)

