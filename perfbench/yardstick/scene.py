"""Rooms of posed shapes: a frozen copy of ``repro_torch.data.synthetic.scene``.

Each number comes from an integer hash of ``(seed, object, point index,
stream)`` and the points are built with additions, multiplications,
divisions and square roots only (sine, cosine and logarithm are
polynomials), so a room depends on ``(seed, n, objects, extent)`` and on
nothing else: not on the chunking and not on the device it is made on.
"""
from __future__ import annotations

import torch

NUM_SHAPES = 6  # sphere, cube, torus, cylinder, plane, helix

_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
_SQRT2 = 1.4142135623730951
_LN2 = 0.6931471805599453
# Per-object streams (the pose) and per-point streams (u, v, w, noise).
_S_SHAPE, _S_ANGLE, _S_SCALE, _S_OFFSET = 100, 101, 102, 105
_S_UVW, _S_NOISE = 0, 3


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), in int64 ops that
    never overflow (the constant is split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (two multiply-xorshift rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash(*words) -> torch.Tensor:
    """Hash a sequence of integer words (ints or int64 tensors that
    broadcast) into 32 bits, one ``_mix32`` round a word."""
    h = None
    for w in words:
        w = w & _MASK32
        h = _mix32(w ^ 0x9E3779B9 if h is None else h ^ w)
    return h


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """32 hash bits -> float32 in [0, 1) with 24 bits of resolution."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _sincos_turns(t: torch.Tensor):
    """(sin(2*pi*t), cos(2*pi*t)) of float32 ``t`` (turns): reduced to the
    nearest quarter turn, then Taylor polynomials on |angle| <= pi/4
    (truncation below 3e-9)."""
    q = torch.round(t * 4.0)
    x = (t - q * 0.25) * _TWO_PI
    x2 = x * x
    s = x * (1.0 + x2 * (-1.0 / 6 + x2 * (1.0 / 120 + x2 * (
        -1.0 / 5040 + x2 * (1.0 / 362880)))))
    c = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24 + x2 * (-1.0 / 720 + x2 * (
        1.0 / 40320 + x2 * (-1.0 / 3628800)))))
    k = q.to(torch.int64) % 4
    sin = torch.where(k == 0, s, torch.where(k == 1, c,
                                             torch.where(k == 2, -s, -c)))
    cos = torch.where(k == 0, c, torch.where(k == 1, -s,
                                             torch.where(k == 2, -c, s)))
    return sin, cos


def _log(u: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 ``u``: exponent and mantissa
    from the bits, then the atanh series of the mantissa on
    [sqrt(1/2), sqrt(2)) (truncation below 1e-11)."""
    bits = u.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)   # [1, 2)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    z = (m - 1.0) / (m + 1.0)
    z2 = z * z
    series = z * (1.0 + z2 * (1.0 / 3 + z2 * (1.0 / 5 + z2 * (
        1.0 / 7 + z2 * (1.0 / 9 + z2 * (1.0 / 11))))))
    return 2.0 * series + e * _LN2


def _normals(h1: torch.Tensor, h2: torch.Tensor):
    """Two standard normals from two hashes (Box-Muller)."""
    r = torch.sqrt(-2.0 * _log(1.0 - _uniform(h1)))       # 1 - u in (0, 1]
    sin, cos = _sincos_turns(_uniform(h2))
    return r * cos, r * sin


def _scene_shapes(u, v, w):
    """(m,) parameters -> (NUM_SHAPES, m, 3): sphere, cube, torus,
    cylinder, plane and helix, with the polynomial sine and cosine."""
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    sin_t, cos_t = _sincos_turns(u)
    ct = (2.0 * v - 1.0).clamp(-1.0, 1.0)            # cos(phi)
    st = torch.sqrt((1.0 - ct * ct).clamp(min=0.0))  # sin(arccos(ct))
    sphere = torch.stack([st * cos_t, st * sin_t, ct], -1)
    a, b = 2.0 * u - 1.0, 2.0 * v - 1.0
    faces = torch.stack([
        torch.stack([a, b, one], -1), torch.stack([a, b, -one], -1),
        torch.stack([a, one, b], -1), torch.stack([a, -one, b], -1),
        torch.stack([one, a, b], -1), torch.stack([-one, a, b], -1)], 0)
    face = (w * 6.0).floor().to(torch.int64) % 6
    cube = torch.gather(faces, 0, face[None, :, None].expand(1, -1, 3))[0]
    sin_p, cos_p = _sincos_turns(v)
    ring = 1.0 + 0.3 * cos_p
    torus = torch.stack([ring * cos_t, ring * sin_t, 0.3 * sin_p], -1)
    cylinder = torch.stack([cos_t, sin_t, b], -1)
    plane = torch.stack([a, b, zero], -1)
    sin_h, cos_h = _sincos_turns(2.0 * u)            # t = 4*pi*u
    coil = 1.0 + 0.1 * v
    helix = torch.stack([cos_h * coil, sin_h * coil, 2.0 * u - 1.0], -1)
    return torch.stack([sphere, cube, torus, cylinder, plane, helix], 0)


def _scene_poses(seed: int, objects: int, extent: float):
    """Per-object draws on the CPU: (shape ids (O,) int64, sin and cos of
    the rotation about z (O,), scale (O, 3), offset (O, 3))."""
    o = torch.arange(objects, dtype=torch.int64)
    zero = torch.zeros_like(o)

    def draw(stream):
        return _uniform(_hash(seed, o, zero, stream))

    sids = (draw(_S_SHAPE) * NUM_SHAPES).floor().to(torch.int64).clamp(
        max=NUM_SHAPES - 1)
    sin, cos = _sincos_turns(draw(_S_ANGLE))
    scale = torch.stack([0.5 + 0.7 * draw(_S_SCALE + i) for i in range(3)],
                        -1)
    off = torch.stack([(2.0 * draw(_S_OFFSET + i) - 1.0) * extent
                       for i in range(3)], -1)
    off = off * torch.tensor([1.0, 1.0, 0.35])       # rooms are flat in z
    return sids, sin, cos, scale, off


def scene(seed: int, n: int, *, objects: int | None = None,
          chunk: int = 65536, noise: float = 0.02, extent: float = 6.0,
          device="cpu"):
    """A room of posed shapes: (points (n, 3) float32, labels (n,) int32),
    tensors on ``device``.

    ``objects`` shapes (default ``max(2, n // 2048)``), each rotated about z, scaled by 0.5-1.2 per axis and placed within
    ``extent`` of the origin in x and y and ``0.35 * extent`` in z, with
    Gaussian noise; the points of object ``o`` follow those of ``o - 1``,
    and every point is labelled with its shape's id.  Points are made
    ``chunk`` at a time on ``device``; each number comes from a hash of
    ``(seed, object, point index, stream)``, so the scene depends on
    ``(seed, n, objects)`` and neither on ``chunk`` nor on the device."""
    if n <= 0:
        raise ValueError(f"need n > 0, got {n}")
    if objects is None:
        objects = max(2, n // 2048)
    elif objects <= 0:
        raise ValueError(f"need objects > 0, got {objects}")
    objects = min(objects, n)
    per, extra = divmod(n, objects)
    counts = torch.full((objects,), per, dtype=torch.int64)
    counts[:extra] += 1
    first = torch.cumsum(counts, 0) - counts
    sids, sin, cos, scale, off = (
        x.to(device) for x in _scene_poses(seed, objects, extent))
    first = first.to(device)

    points = torch.empty((n, 3), dtype=torch.float32, device=device)
    labels = torch.empty((n,), dtype=torch.int32, device=device)
    for s in range(0, n, chunk):
        g = torch.arange(s, min(n, s + chunk), dtype=torch.int64,
                         device=device)
        o = torch.searchsorted(first, g, right=True) - 1
        i = g - first[o]
        u, v, w = (_uniform(_hash(seed, o, i, _S_UVW + j)) for j in range(3))
        n0, n1 = _normals(_hash(seed, o, i, _S_NOISE),
                          _hash(seed, o, i, _S_NOISE + 1))
        n2, _ = _normals(_hash(seed, o, i, _S_NOISE + 2),
                         _hash(seed, o, i, _S_NOISE + 3))
        shape = torch.gather(_scene_shapes(u, v, w), 0,
                             sids[o][None, :, None].expand(1, -1, 3))[0]
        p = (shape + noise * torch.stack([n0, n1, n2], -1)) * scale[o]
        x, y = p[:, 0], p[:, 1]
        c, sn = cos[o], sin[o]
        points[s:s + len(g)] = torch.stack(
            [c * x - sn * y, sn * x + c * y, p[:, 2]], -1) + off[o]
        labels[s:s + len(g)] = sids[o].to(torch.int32)
    return points, labels


def clouds(seed: int, count: int, n: int, *, extent: float = 6.0,
           device="cpu"):
    """``count`` clouds of ``n`` points in one pass: the room of
    ``count * n`` points and ``count * max(2, n // 2048)`` objects, cut
    into consecutive clouds, so each holds ``scene``'s number of objects
    a cloud, each placed within ``extent`` of the origin.  Returns
    (points (count, n, 3), labels (count, n))."""
    pts, labels = scene(seed, count * n, objects=count * max(2, n // 2048),
                        extent=extent, device=device)
    return pts.view(count, n, 3), labels.view(count, n)
