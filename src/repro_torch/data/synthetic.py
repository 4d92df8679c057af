"""Synthetic parametric point clouds (the S3DIS/ModelNet stand-in).

Counterpart of ``classification_batch`` and ``segmentation_batch`` in
``repro.data.synthetic``: six parametric shapes (sphere, cube, torus,
cylinder, plane, helix) with Gaussian noise, a random rotation about z and
a random anisotropic scale; a segmentation scene is ``parts`` displaced
shapes, each point labelled with its shape's id.

The stream is the port's own and counter-based: every batch is drawn from
a CPU ``torch.Generator`` seeded from ``(seed, step)`` alone and then moved
to ``device``, so a restart at a checkpointed step reproduces the batch.
It does not repeat ``jax.random``'s numbers: parity tests feed both
packages the same arrays instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NUM_SHAPES = 6  # sphere, cube, torus, cylinder, plane, helix
_CLS, _SEG = 0, 1   # stream ids: the two generators never share a seed


def _generator(seed: int, step: int, stream: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _shapes(u, v, w):
    """(P, n) parameters -> (NUM_SHAPES, P, n, 3) points of every shape."""
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    theta = 2 * math.pi * u
    phi = torch.arccos((2 * v - 1).clamp(-1, 1))
    sphere = torch.stack([phi.sin() * theta.cos(), phi.sin() * theta.sin(),
                          phi.cos()], -1)
    a, b = 2 * u - 1, 2 * v - 1
    faces = torch.stack([
        torch.stack([a, b, one], -1), torch.stack([a, b, -one], -1),
        torch.stack([a, one, b], -1), torch.stack([a, -one, b], -1),
        torch.stack([one, a, b], -1), torch.stack([-one, a, b], -1)], 0)
    face = (w * 6).floor().long() % 6
    cube = torch.gather(faces, 0, face[None, ..., None].expand(
        1, *u.shape, 3))[0]
    tphi = 2 * math.pi * v
    ring = 1.0 + 0.3 * tphi.cos()
    torus = torch.stack([ring * theta.cos(), ring * theta.sin(),
                         0.3 * tphi.sin()], -1)
    cylinder = torch.stack([theta.cos(), theta.sin(), 2 * v - 1], -1)
    plane = torch.stack([a, b, zero], -1)
    t = 4 * math.pi * u
    helix = torch.stack([t.cos() * (1 + 0.1 * v), t.sin() * (1 + 0.1 * v),
                         t / (2 * math.pi) - 1], -1)
    return torch.stack([sphere, cube, torus, cylinder, plane, helix], 0)


def _sample_shapes(gen, labels, n, noise=0.02):
    """One posed shape of ``n`` points per entry of ``labels`` (P,) ->
    (P, n, 3)."""
    p = labels.shape[0]
    u, v, w = (torch.rand((p, n), generator=gen) for _ in range(3))
    pts = torch.gather(_shapes(u, v, w), 0,
                       labels[None, :, None, None].expand(1, p, n, 3))[0]
    pts = pts + noise * torch.randn((p, n, 3), generator=gen)
    # random rotation about z + anisotropic scale: breaks axis alignment so
    # the partitioner cannot cheat.
    ang = 2 * math.pi * torch.rand((p,), generator=gen)
    c, s, z = ang.cos(), ang.sin(), torch.zeros(p)
    rot = torch.stack([torch.stack([c, -s, z], -1),
                       torch.stack([s, c, z], -1),
                       torch.stack([z, z, z + 1], -1)], -2)   # (P, 3, 3)
    scale = 0.7 + 0.6 * torch.rand((p, 1, 3), generator=gen)
    return (pts * scale) @ rot.transpose(-1, -2)


def classification_batch(seed: int, step: int, batch: int, n: int,
                         device="cpu"):
    """(points (B, n, 3) f32, labels (B,) int64): one shape per cloud."""
    gen = _generator(seed, step, _CLS)
    labels = torch.randint(0, NUM_SHAPES, (batch,), generator=gen)
    pts = _sample_shapes(gen, labels, n)
    return pts.to(device), labels.to(device)


def segmentation_batch(seed: int, step: int, batch: int, n: int,
                       parts: int = 3, device="cpu"):
    """(points (B, n, 3) f32, labels (B, n) int64): a scene of ``parts``
    displaced shapes, each point labelled with its shape's id; when ``n``
    is not a multiple of ``parts``, the first points repeat to fill it."""
    gen = _generator(seed, step, _SEG)
    per = n // parts
    kinds = torch.randint(0, NUM_SHAPES, (batch * parts,), generator=gen)
    pts = _sample_shapes(gen, kinds, per)
    pts = pts + (5.0 * torch.rand((batch * parts, 1, 3), generator=gen)
                 - 2.5)
    pts = pts.reshape(batch, parts * per, 3)
    lab = kinds[:, None].expand(batch * parts, per).reshape(batch, -1)
    pad = n - parts * per
    if pad:
        pts = torch.cat([pts, pts[:, :pad]], 1)
        lab = torch.cat([lab, lab[:, :pad]], 1)
    return pts.to(device), lab.to(device)
