"""The FP stage's 3-NN blend (``kernels.interp_blend``, ``ops.interp_blend``)
against the multiply, sum and ``scatter_`` the FP stage ran before it, on
the CPU; the CUDA kernel against its plain version on the card.

Before the kernel, ``core.bppo.blockwise_interpolate`` blended every lane of
every leaf block, padded ones included, and scattered each into a (B, n + 1,
C) buffer whose last row took the padded lanes.  The op blends the occupied
lanes alone, rounding each product and sum as ``.sum(-2)`` did on the CPU
(k = 0, 1, 2), so its rows, the interpolation's output and the gradient
that reaches the features are bit for bit those of the former sequence.

Marked ``cuda``: the kernel equals its plain version bit for bit at the
level-0 shapes of the PointNeXt-XL and rooms microbatches (4 and 8 rooms of
9,916 leaf blocks, 128 and 64 channels), a forward launches it once an FP
stage, and its gradient on the card equals the CPU's.  This file imports
neither JAX nor the JAX package.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bppo, fractal  # noqa: E402
from repro_torch.core.fractal import take  # noqa: E402
from repro_torch.kernels import checks, ops, vjp  # noqa: E402
from repro_torch.kernels import interp_blend as ib  # noqa: E402
from repro_torch.models import pnn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def bits(x):
    return x.detach().contiguous().view(torch.int32)


def former_blend(out, vals, wgt, leaf_start, count):
    """The multiply, ``sum(-2)`` and ``scatter_`` the FP stage ran before
    ``interp_blend``, over every lane of every block into a copy of ``out``
    with a sink row past its end for the lanes that write no row."""
    b, r, c = out.shape
    nb, bs = wgt.shape[:2]
    row, keep = ib.occupied_rows(r, leaf_start, count, bs)
    pos = torch.where(keep, row, r).reshape(b, -1)
    full = torch.cat([out, out.new_zeros((b, 1, c))], 1)
    blended = (vals.reshape(b, nb // b, bs, 3, c)
               * wgt.reshape(b, nb // b, bs, 3)[..., None]).sum(-2)
    full = full.scatter(1, pos[..., None].expand(b, pos.shape[1], c),
                        blended.reshape(b, -1, c))
    return full[:, :r]


def former_interpolate(part, samp, feats, *, wc, bs, chunk, eps=1e-8):
    """``bppo.blockwise_interpolate`` as it ran before ``interp_blend``."""
    b, n, cf = part.batch, part.n, feats.shape[-1]
    out = torch.zeros((b, n + 1, cf), dtype=feats.dtype)
    for s in ops.leaf_chunks(bppo._interp_slices(part, samp, wc), chunk,
                             dim=1):
        cidx, nidx, wgt = bppo._interp_slice(part, samp, s, wc=wc, bs=bs,
                                             eps=eps)
        _, _, il, ls, lv = s
        _, fmask, fidx = fractal.leaf_from(ls, lv, il, part.coords, bs)
        pos = torch.where(fmask, fidx, n).reshape(b, -1)
        c = cidx.shape[1]
        vals = ops.gather_blocks(bppo._flat(take(feats, cidx)),
                                 nidx.reshape(b * c, bs * 3))
        blended = (vals.reshape(b, c, bs, 3, cf) * wgt[..., None]).sum(-2)
        out.scatter_(1, pos[..., None].expand(b, pos.shape[1], cf),
                     blended.reshape(b, -1, cf))
    return out[:, :n]


def finite_args(seed, b, leaves, bs, c, dtype=torch.float32, **kw):
    """``checks.blend_args`` over a ``blend_layout``, with every lane's
    vals and weights finite (the FP stage's padded lanes are) and a zero
    ``out``, as the FP stage starts it."""
    start, count, rows = checks.blend_layout(seed, b, leaves, bs, **kw)
    a = checks.blend_args(seed + 1, start, count, rows, bs, c, "cpu")
    gen = torch.Generator().manual_seed(seed + 2)
    return dict(a, out=torch.zeros_like(a["out"], dtype=dtype),
                vals=torch.randn(a["vals"].shape, generator=gen, dtype=dtype),
                wgt=torch.rand(a["wgt"].shape, generator=gen, dtype=dtype))


@pytest.mark.parametrize("layout", [dict(), dict(overflow=2),
                                    dict(non_leaf=0.5, fill=0.9)],
                         ids=["mixed", "overflowing", "sparse"])
@pytest.mark.parametrize("c", [3, 32, 128])
def test_op_equals_the_former_sequence(c, layout):
    """Every row of ``out``: the op's, the former sequence's, bit for bit;
    rows that no lane writes stay 0."""
    a = finite_args(c, 3, 6, 65, c, **layout)
    want = former_blend(**a)
    got = ops.interp_blend(**dict(a, out=a["out"].clone()))
    assert torch.equal(bits(got), bits(want))
    _, keep = ib.occupied_rows(a["out"].shape[1], a["leaf_start"],
                               a["count"], 65)
    assert int((got.abs().sum(-1) > 0).sum()) <= int(keep.sum())


def cloud_partition(case, seed=3):
    """Two clouds of 700 points (the second with its last 50 invalid, or
    all invalid) partitioned at th=64: whole, overflowing at a depth cap of
    2, or with room for 3 leaves (``leaf_capacity_exceeded``)."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.random((2, 700, 3)).astype(np.float32))
    valid = torch.ones((2, 700), dtype=torch.bool)
    valid[1, 650:] = False
    kw = {}
    if case == "depth_cap":
        kw = dict(depth=2)
    elif case == "leaf_capacity_exceeded":
        kw = dict(max_leaves_=3)
    elif case == "empty_cloud":
        valid[1] = False
    part = fractal.partition(pts, valid, th=64, on_overflow="silent", **kw)
    if case == "leaf_capacity_exceeded":
        assert bool(part.leaf_capacity_exceeded.any())
    return part


@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("case", ["whole", "depth_cap",
                                  "leaf_capacity_exceeded", "empty_cloud"])
@pytest.mark.parametrize("c", [3, 32, 128])
def test_interpolation_equals_the_former_one(c, case, chunk):
    """``blockwise_interpolate`` and the gradient it passes to the features
    are bit for bit those of the former multiply, sum and ``scatter_``."""
    part = cloud_partition(case)
    samp = bppo.blockwise_fps(part, rate=0.25, k_out=175, bs=64)
    feats = torch.from_numpy(np.random.default_rng(c).normal(
        size=(2, 175, c)).astype(np.float32)).requires_grad_()
    got = bppo.blockwise_interpolate(part, samp, feats, wc=32, bs=64,
                                     chunk=chunk)
    want = former_interpolate(part, samp, feats, wc=32, bs=64, chunk=chunk)
    assert got.shape == want.shape == (2, 700, c)
    assert torch.equal(bits(got), bits(want))
    if case == "depth_cap":
        assert bool((part.leaf_vsize > 64).any())
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    (g_got,) = torch.autograd.grad(got, feats, cot)
    (g_want,) = torch.autograd.grad(want, feats, cot)
    assert torch.equal(bits(g_got), bits(g_want))
    assert bool(g_got.abs().sum() > 0)


def test_gradcheck_in_vals():
    """The rule's gradient in ``vals`` (float64), through two calls into one
    ``out`` as two leaf chunks make them: the second passes the first's
    rows' gradient on."""
    a = finite_args(7, 2, 4, 9, 5, dtype=torch.float64, overflow=1)
    start, count = a["leaf_start"].view(2, 4), a["count"].view(2, 4)
    vals = a["vals"].view(2, 4, 27, 5)
    wgt = a["wgt"].view(2, 4, 9, 3)

    def blend(v):
        out = torch.zeros_like(a["out"])
        for lo, hi in ((0, 3), (3, 4)):
            out = vjp.Blending.apply(
                ib.interp_blend_plain, out,
                v.view(2, 4, 27, 5)[:, lo:hi].reshape(-1, 27, 5),
                wgt[:, lo:hi].reshape(-1, 9, 3),
                start[:, lo:hi].reshape(-1), count[:, lo:hi].reshape(-1))
        return out

    v = vals.reshape(8, 27, 5).clone().requires_grad_()
    assert torch.autograd.gradcheck(blend, (v,))
    (g,) = torch.autograd.grad(blend(v).sum(), v)
    _, keep = ib.occupied_rows(a["out"].shape[1], a["leaf_start"],
                               a["count"], 9)
    assert bool((g.view(8, 9, 3, 5)[~keep] == 0).all())


def test_gradient_equals_the_former_autograd():
    """Through the op the gradient of ``vals`` is the former sequence's
    autograd gradient, bit for bit, padded lanes 0."""
    a = finite_args(11, 3, 5, 33, 17, overflow=1)
    v1 = a["vals"].clone().requires_grad_()
    v2 = a["vals"].clone().requires_grad_()
    cot = torch.randn(a["out"].shape,
                      generator=torch.Generator().manual_seed(2))
    got = ops.interp_blend(**dict(a, out=a["out"].clone(), vals=v1))
    (g1,) = torch.autograd.grad(got, v1, cot)
    (g2,) = torch.autograd.grad(former_blend(**dict(a, vals=v2)), v2, cot)
    assert torch.equal(bits(g1), bits(g2))


def seg_config(**kw):
    return dataclasses.replace(
        pnn.PNNConfig(
            variant="pointnet2", task="seg", num_classes=5, n_points=600,
            stages=(pnn.SAStage(0.25, 0.2, 8, (16,)),
                    pnn.SAStage(0.25, 0.4, 8, (32,)),
                    pnn.SAStage(0.25, 0.8, 8, (32,)),
                    pnn.SAStage(0.5, 1.6, 8, (64,))),
            fp_widths=((32,), (32,), (16,), (16,)), head_widths=(16,),
            point_ops="bppo", th=32), **kw)


@pytest.mark.parametrize("leaf_chunk", [None, 4])
def test_one_blend_an_fp_stage_and_leaf_chunk(leaf_chunk):
    """A four-stage segmentation forward blends once an FP stage (once a
    leaf chunk with ``leaf_chunk``), each call over the clouds' leaf
    blocks."""
    cfg = seg_config(leaf_chunk=leaf_chunk)
    model = pnn.init(cfg, torch.Generator().manual_seed(0))
    pts = torch.from_numpy(np.random.default_rng(4).random(
        (2, 600, 3)).astype(np.float32))
    with torch.no_grad(), checks.Recorder() as rec:
        pnn.apply(model, cfg, pts)
    blends = [a for n, a in rec.calls if n == "interp_blend"]
    gathers = [a for n, a in rec.calls if n == "gather_blocks"]
    assert len(blends) == len(gathers)
    if leaf_chunk is None:
        assert len(blends) == len(cfg.fp_widths)
    else:
        assert len(blends) > len(cfg.fp_widths)
    for a, g in zip(blends, gathers):
        assert a["vals"].shape[0] == g["idx"].shape[0]
        assert checks.hold("interp_blend", a)["max_abs_err"] == 0.0


def test_work_counts_occupied_lanes_only():
    a = finite_args(5, 2, 4, 65, 8)
    _, keep = ib.occupied_rows(a["out"].shape[1], a["leaf_start"],
                               a["count"], 65)
    lanes = int(keep.sum())
    assert checks.work("interp_blend", a) == (8 * 8 + lanes * (16 * 8 + 12),
                                              lanes * 8 * 5.0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(4, 128), (8, 64)], ids=["xl", "rooms"])
def test_kernel_equals_plain_at_level0_shapes(cuda_device, b, c):
    """Level 0 of a PointNeXt-XL (4 rooms, 128 channels) and a rooms
    (8 rooms, 64 channels) microbatch: 9,916 leaf blocks of 256 lanes a
    room, about an eighth of the lanes occupied.  The kernel's rows equal
    the plain version's, and it launches once."""
    start, count, rows = checks.blend_layout(b, b, 9916, 256, fill=0.125)
    a = checks.blend_args(c, start, count, rows, 256, c, cuda_device)
    before = ib.interp_blend.launches
    assert checks.hold("interp_blend", a)["max_abs_err"] == 0.0
    assert ib.interp_blend.launches == before + 1


@pytest.mark.cuda
def test_card_gradient_equals_the_cpus(cuda_device):
    a = finite_args(13, 3, 6, 65, 36, overflow=1)
    cot = torch.randn(a["out"].shape,
                      generator=torch.Generator().manual_seed(3))
    grads = {}
    for dev in ("cpu", cuda_device):
        v = a["vals"].to(dev).requires_grad_()
        out = ops.interp_blend(a["out"].to(dev), v, a["wgt"].to(dev),
                               a["leaf_start"].to(dev), a["count"].to(dev))
        (grads[str(dev)],) = torch.autograd.grad(out, v, cot.to(dev))
    checks.hold_grads({"vals": grads["cuda"]}, {"vals": grads["cpu"]})


@pytest.mark.cuda
def test_forward_launches_one_blend_an_fp_stage(cuda_device):
    cfg = seg_config()
    model = pnn.init(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    pts = torch.from_numpy(np.random.default_rng(4).random(
        (2, 600, 3)).astype(np.float32)).to(cuda_device)
    ops.reset_launch_counts()
    with torch.no_grad():
        pnn.apply(model, cfg, pts)
    assert ops.launch_counts()["interp_blend"] == len(cfg.fp_widths)
