"""The port's partition-level op, ``ops.fractal_level_blocks``, against the
JAX package's, on the CPU.

On the ladder of tests/test_point_impls.py (block sizes 65/200/33, empty
blocks, all-invalid masks) under all three ``(da, db)`` pairs, the port's
plain version (what a CPU tensor runs) must equal the JAX op with
``impl="xla"`` and with ``impl="pallas"`` (interpret mode) exactly: side
bits, left counts and child extrema, compared with ``==``.  Min, max and a
count do not depend on the order of the lanes, so no tolerance is needed.
The CUDA kernel is held against this plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import checks, fractal_level, ops  # noqa: E402
from repro_torch.kernels.common import INF, NEG  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ODD_SHAPES = [(3, 65), (2, 200), (5, 33)]
# Also at the edges of the one-warp kernel: a warp's width, the main
# path's leaf, one lane past two strides of 256, and eight strides.
LEVEL_SHAPES = ODD_SHAPES + [(2, 32), (2, 256), (2, 513), (1, 2048)]
LADDER = [(0, False), (1, False), (0, True)]


def blocks(seed, nb, bs, empty_blocks=0, all_invalid=False):
    rng = np.random.default_rng(seed)
    coords = rng.normal(0, 1, (nb, bs, 3)).astype(np.float32)
    nvalid = rng.integers(1, bs + 1, nb)
    nvalid[:empty_blocks] = 0
    if all_invalid:
        nvalid[:] = 0
    mask = np.arange(bs)[None, :] < nvalid[:, None]
    return coords, mask


def mids(seed, nb):
    return np.random.default_rng(seed).normal(0, 0.5, nb).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def hold_equal(got, want):
    for name, a, b in zip(("side", "left_count", "child_stats"), got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        assert (a.numpy() == b).all(), name


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("nb,bs", LEVEL_SHAPES)
@pytest.mark.parametrize("empty,invalid", LADDER)
def test_level_matches_jax(impl, nb, bs, empty, invalid):
    coords, mask = blocks(6, nb, bs, empty, invalid)
    mid = mids(7, nb)
    coords[:, ::5, 0] = mid[:, None]              # lanes exactly at mid
    for da, db in checks.LEVEL_DIMS:
        want = jops.fractal_level_blocks(
            jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(mid),
            da=da, db=db, impl=impl)
        got = ops.fractal_level_blocks(t(coords), t(mask), t(mid), da=da,
                                       db=db)
        assert got[0].dtype == got[1].dtype == torch.int32
        assert got[2].dtype == torch.float32
        hold_equal(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("bs", [32, 256, 513, 2048])
def test_level_matches_jax_on_last_slots(impl, bs):
    """Valid lanes only in the last lane each of a warp's threads takes
    (``checks.last_slots``), beside an empty block and a prefix mask, as on
    the card ladder."""
    coords, mask = blocks(13, 3, bs, empty_blocks=1)
    mask[1] = checks.last_slots(bs, "cpu").numpy()
    mid = mids(14, 3)
    for da, db in checks.LEVEL_DIMS:
        want = jops.fractal_level_blocks(
            jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(mid),
            da=da, db=db, impl=impl)
        hold_equal(ops.fractal_level_blocks(t(coords), t(mask), t(mid),
                                            da=da, db=db), want)


def test_level_rules():
    """Ties go left, the left count counts valid lanes off the side, and
    an empty side gives the INF / NEG sentinels."""
    coords = torch.tensor([[[0.0, 1, 0], [1.0, 2, 0], [2.0, 3, 0],
                            [5.0, 9, 0]]])
    mask = torch.tensor([[True, True, True, False]])
    side, lcnt, stats = ops.fractal_level_blocks(
        coords, mask, torch.tensor([1.0]), da=0, db=1)
    assert side.tolist() == [[0, 0, 1, 0]] and lcnt.tolist() == [2]
    assert stats.tolist() == [[1.0, 2.0, 3.0, 3.0]]
    for far, empty in ((100.0, slice(2, 4)), (-100.0, slice(0, 2))):
        _, _, st = ops.fractal_level_blocks(coords, mask,
                                            torch.tensor([far]), da=0, db=1)
        assert (st[0, empty] == torch.tensor([INF, NEG])).all()
    with pytest.raises(ValueError, match="da and db"):
        ops.fractal_level_blocks(coords, mask, torch.tensor([1.0]), da=3,
                                 db=1)


def test_chunked_matches_unchunked():
    coords, mask = blocks(9, 7, 65, empty_blocks=1)
    args = (t(coords), t(mask), t(mids(10, 7)))
    a = ops.fractal_level_blocks(*args, da=2, db=0, chunk=3)
    b = ops.fractal_level_blocks(*args, da=2, db=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    want = jops.fractal_level_blocks(*(jnp.asarray(np.array(x)) for x in
                                       args), da=2, db=0, impl="xla",
                                     chunk=3)
    hold_equal(a, want)


def test_stats_get_zero_gradients():
    """The JAX op is an index producer (tests/test_grads.py): nothing of
    its output carries a gradient back to the coordinates."""
    coords, mask = blocks(2, 3, 33)
    c = t(coords).requires_grad_()
    side, lcnt, stats = ops.fractal_level_blocks(c, t(mask),
                                                 torch.zeros(3), da=0, db=1)
    assert not (side.requires_grad or lcnt.requires_grad
                or stats.requires_grad)
    loss = torch.where(stats.abs() < 1e30, stats, 0.0).sum() + (c * 0).sum()
    (g,) = torch.autograd.grad(loss, c)
    assert float(g.abs().sum()) == 0.0


def test_pipelined_stats_give_the_child_mids():
    """Paper Fig. 9: the child midpoints derived from the fused child
    extrema equal those of a fresh min/max pass over each side."""
    coords, mask = blocks(12, 4, 128)
    mid0 = np.array([(coords[b][mask[b], 0].max()
                      + coords[b][mask[b], 0].min()) / 2 for b in range(4)],
                    np.float32)
    side, _, stats = ops.fractal_level_blocks(t(coords), t(mask), t(mid0),
                                              da=0, db=1)
    side, stats = side.numpy(), stats.numpy()
    for b in range(4):
        for k, part in ((0, mask[b] & (side[b] == 0)),
                        (2, mask[b] & (side[b] == 1))):
            if part.any():
                want = (coords[b][part, 1].min()
                        + coords[b][part, 1].max()) / 2
                np.testing.assert_allclose((stats[b, k] + stats[b, k + 1])
                                           / 2, want, rtol=1e-6)


def test_plain_version_is_what_the_cpu_runs():
    coords, mask = blocks(3, 2, 40)
    args = (t(coords), t(mask), t(mids(4, 2)))
    ops.reset_launch_counts()
    a = ops.fractal_level_blocks(*args, da=1, db=2)
    b = fractal_level.fractal_level_plain(*args, da=1, db=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ops.launch_counts()["fractal_level_blocks"] == 0
