"""The port's point kernels against the JAX package, on the CPU.

Each plain version (what a CPU tensor runs) is held against
``repro.kernels.ops`` with ``impl="xla"`` on the ladder of
tests/test_point_impls.py -- block sizes off the 128-lane boundary, empty
blocks, all-invalid masks -- plus one ``impl="pallas"`` (interpret) case per
kernel.  Tolerances: d2 within 1e-5; indices exact except at near-ties,
where the two distances differ by less than 1e-5 (XLA's dot and the
port's explicit products round the last ulp differently).  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import checks, fps, ops  # noqa: E402
from repro_torch.kernels.checks import check_topk  # noqa: E402
from repro_torch.kernels.common import INF  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ODD_SHAPES = [(3, 65), (2, 200), (5, 33)]
# FPS also at the edges of its one-warp variant's width (fps.variant).
FPS_SHAPES = ODD_SHAPES + [(2, 1), (3, 32), (2, 256), (2, 512), (2, 513)]
LADDER = [(0, False), (1, False), (0, True)]
TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def blocks(seed, nb, bs, empty_blocks=0, all_invalid=False):
    rng = np.random.default_rng(seed)
    coords = rng.normal(0, 1, (nb, bs, 3)).astype(np.float32)
    nvalid = rng.integers(1, bs + 1, nb)
    nvalid[:empty_blocks] = 0
    if all_invalid:
        nvalid[:] = 0
    mask = np.arange(bs)[None, :] < nvalid[:, None]
    return coords, mask


def t(x):
    return torch.from_numpy(np.array(x))


def hold_topk(port, ref, queries, window, wmask):
    (pi, pd), (ri, rd) = port, (t(ref[0]), t(ref[1]))
    assert pi.shape == ri.shape and pi.dtype == torch.int32
    # Both sides pick by their own d2; a flip must be a near-tie.
    check_topk(pi, pd, ri, rd, t(queries), t(window), t(wmask), tol=TOL)


@pytest.mark.parametrize("nb,bs", FPS_SHAPES)
@pytest.mark.parametrize("empty,invalid", LADDER)
def test_fps_plain_matches_xla(nb, bs, empty, invalid):
    coords, mask = blocks(0, nb, bs, empty, invalid)
    want = np.asarray(jops.fps_blocks(jnp.asarray(coords), jnp.asarray(mask),
                                      k=7, impl="xla"))
    got = ops.fps_blocks(t(coords), t(mask), k=7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nb,w", ODD_SHAPES)
@pytest.mark.parametrize("empty,invalid", LADDER)
def test_ball_query_plain_matches_xla(nb, w, empty, invalid):
    win, wmask = blocks(1, nb, w, empty, invalid)
    centers, cmask = blocks(2, nb, 13, empty, invalid)
    ref = jops.ball_query_blocks(jnp.asarray(centers), jnp.asarray(cmask),
                                 jnp.asarray(win), jnp.asarray(wmask),
                                 radius=0.8, num=5, impl="xla")
    idx, d2, cnt = ops.ball_query_blocks(t(centers), t(cmask), t(win),
                                         t(wmask), radius=0.8, num=5)
    assert idx.shape == (nb, 13, 5)
    hold_topk((idx, d2), ref[:2], centers, win, wmask)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("nb,w", ODD_SHAPES)
@pytest.mark.parametrize("empty,invalid", LADDER)
def test_knn_plain_matches_xla(nb, w, empty, invalid):
    win, wmask = blocks(3, nb, w, empty, invalid)
    queries, _ = blocks(4, nb, 11)
    ref = jops.knn_blocks(jnp.asarray(queries), jnp.asarray(win),
                          jnp.asarray(wmask), k=3, impl="xla")
    got = ops.knn_blocks(t(queries), t(win), t(wmask), k=3)
    assert got[0].shape == (nb, 11, 3)
    hold_topk(got, ref, queries, win, wmask)


@pytest.mark.parametrize("nb,w", ODD_SHAPES)
def test_gather_plain_matches_xla(nb, w):
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (nb, w, 9)).astype(np.float32)
    idx = rng.integers(-3, w + 3, (nb, 17)).astype(np.int32)
    want = np.asarray(jops.gather_blocks(jnp.asarray(feats), jnp.asarray(idx),
                                         impl="xla"))
    got = ops.gather_blocks(t(feats), t(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def topk_case(case):
    """(centres, cmask, window, wmask) as numpy, from the card's ladder: a
    scattered window mask, or duplicated lattice points (bit-equal
    distances, so only the lowest-lane rule decides)."""
    kind, arg = case.split("-")
    if kind == "scattered":
        seed = 40 if arg == "0.5" else 41
        win, wmask = checks.scattered(seed, 4, 200, "cpu", float(arg))
        wmask[0] = False
        centers, cmask = checks.blocks(seed + 10, 4, 13, "cpu")
        arrays = centers, cmask, win, wmask
    else:
        arrays = checks.lattice(50 + int(arg), 3, int(arg), "cpu")
    return [a.numpy() for a in arrays]


@pytest.mark.parametrize("case", ["scattered-0.5", "scattered-0.1",
                                  "lattice-2", "lattice-5"])
def test_topk_plain_matches_xla_exactly_on_scattered_and_tied(case):
    """Ball query and kNN (num=16) on scattered masks and duplicated lattice
    points: the same indices as the JAX package, exactly."""
    centers, cmask, win, wmask = topk_case(case)
    ref = jops.ball_query_blocks(jnp.asarray(centers), jnp.asarray(cmask),
                                 jnp.asarray(win), jnp.asarray(wmask),
                                 radius=1.0, num=16, impl="xla")
    idx, d2, cnt = ops.ball_query_blocks(t(centers), t(cmask), t(win),
                                         t(wmask), radius=1.0, num=16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[2]))
    ref = jops.knn_blocks(jnp.asarray(centers), jnp.asarray(win),
                          jnp.asarray(wmask), k=16, impl="xla")
    idx, d2 = ops.knn_blocks(t(centers), t(win), t(wmask), k=16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=TOL)
    if case.startswith("lattice"):          # the case has ties to decide
        fin = d2 < INF
        assert bool(((d2[..., 1:] == d2[..., :-1]) & fin[..., 1:]).any())


def test_fps_plain_matches_xla_on_a_12000_lane_block():
    """A block wider than the kernel's register variants (12,000 lanes,
    scattered mask, one empty block) against the JAX package, exactly."""
    coords, mask = checks.scattered(12_000, 2, 12_000, "cpu", 0.6)
    mask[0] = False
    want = np.asarray(jops.fps_blocks(jnp.asarray(coords.numpy()),
                                      jnp.asarray(mask.numpy()), k=9,
                                      impl="xla"))
    got = ops.fps_blocks(coords, mask, k=9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs", [1, 32, 33, 256, 512, 513])
def test_fps_plain_matches_xla_at_the_variant_edges(bs):
    """The card ladder's FPS cases at the edges of the one-warp variant
    (``checks.fps_ladder``: only the last lane valid, two valid lanes,
    every thread's last slot, k = 1, duplicated lattice points) against
    the JAX package, exactly."""
    calls = [a for _, a in checks.fps_ladder("cpu")
             if a["mask"].shape[1] == bs]
    assert len(calls) == 3
    for a in calls:
        want = np.asarray(jops.fps_blocks(
            jnp.asarray(a["coords"].numpy()), jnp.asarray(a["mask"].numpy()),
            k=a["k"], impl="xla"))
        got = ops.fps_blocks(a["coords"], a["mask"], k=a["k"])
        np.testing.assert_array_equal(got.numpy(), want)


def test_fps_ladder_reaches_every_variant_at_both_edges():
    """The card ladder runs every FPS variant at the narrowest and the
    widest block it takes (the scratch-row variant has no widest)."""
    widths = {}
    for name, a in checks.ladder("cpu"):
        if name == "fps_blocks":
            bs = a["mask"].shape[1]
            widths.setdefault(fps.variant(bs), set()).add(bs)
    edges = {"warp": (1, fps.WARP_LANES),
             "cta": (fps.WARP_LANES + 1, fps.REGISTER_LANES),
             "wide": (fps.REGISTER_LANES + 1,)}
    assert sorted(widths) == sorted(edges)
    for v, want in edges.items():
        assert set(want) <= widths[v], (v, sorted(widths[v]))
        assert all(fps.variant(bs) == v for bs in want)
    assert fps.variant(256) == "warp"                # every path's leaves


def test_pallas_interpret_one_case_per_kernel():
    """One small case per kernel through the Pallas kernels (interpret)."""
    coords, mask = blocks(11, 3, 40, empty_blocks=1)
    mask[1] = np.arange(40) < 3                      # FPS exhaustion
    want = np.asarray(jops.fps_blocks(jnp.asarray(coords), jnp.asarray(mask),
                                      k=7, impl="pallas"))
    np.testing.assert_array_equal(
        ops.fps_blocks(t(coords), t(mask), k=7).numpy(), want)

    win, wmask = blocks(1, 2, 33, empty_blocks=1)
    centers, cmask = blocks(2, 2, 9)
    ref = jops.ball_query_blocks(jnp.asarray(centers), jnp.asarray(cmask),
                                 jnp.asarray(win), jnp.asarray(wmask),
                                 radius=0.8, num=5, impl="pallas")
    got = ops.ball_query_blocks(t(centers), t(cmask), t(win), t(wmask),
                                radius=0.8, num=5)
    hold_topk(got[:2], ref[:2], centers, win, wmask)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))

    ref = jops.knn_blocks(jnp.asarray(centers), jnp.asarray(win),
                          jnp.asarray(wmask), k=3, impl="pallas")
    hold_topk(ops.knn_blocks(t(centers), t(win), t(wmask), k=3), ref,
              centers, win, wmask)

    feats = np.random.default_rng(12).normal(1, 1, (2, 33, 5)).astype(
        np.float32)
    idx = np.asarray([[-1, 0, 32, 33, 123], [3, -7, 1, 2, 33]], np.int32)
    want = np.asarray(jops.gather_blocks(jnp.asarray(feats), jnp.asarray(idx),
                                         impl="pallas"))
    np.testing.assert_allclose(ops.gather_blocks(t(feats), t(idx)).numpy(),
                               want, rtol=1e-6, atol=0)


def test_fps_exhaustion_repeats_last_valid():
    coords, mask = blocks(11, 3, 40, empty_blocks=1)
    mask[1] = np.arange(40) < 3
    idx = ops.fps_blocks(t(coords), t(mask), k=7).numpy()
    assert (idx[0] == 0).all()
    assert set(idx[1][:3]) == {0, 1, 2}
    assert (idx[1][3:] == idx[1][2]).all()


def test_topk_exhaustion_gives_lane_zero_with_inf():
    """Once a row's valid lanes are used up, repeated argmin returns the
    lowest lane holding INF -- lane 0 -- in every remaining slot."""
    win, _ = blocks(13, 1, 10)
    wmask = np.zeros((1, 10), bool)
    wmask[0, [3, 4]] = True
    idx, d2 = ops.knn_blocks(t(win[:, :2]), t(win), t(wmask), k=4)
    assert idx[0, :, 2:].eq(0).all() and d2[0, :, 2:].eq(INF).all()
    assert set(idx[0, 0, :2].tolist()) == {3, 4}


def test_gather_out_of_range_fetches_zeros():
    rng = np.random.default_rng(12)
    feats = rng.normal(1, 1, (2, 33, 5)).astype(np.float32)
    idx = np.asarray([[-1, 0, 32, 33, 123], [3, -7, 1, 2, 33]], np.int32)
    out = ops.gather_blocks(t(feats), t(idx)).numpy()
    ok = (idx >= 0) & (idx < 33)
    assert (out[~ok] == 0).all()
    np.testing.assert_array_equal(out[0, 1], feats[0, 0])


@pytest.mark.parametrize("op", ["fps", "ball_query", "knn", "gather"])
def test_chunked_equals_unchunked(op):
    win, wmask = blocks(8, 7, 65, empty_blocks=1)
    centers, cmask = blocks(9, 7, 9)
    args = {
        "fps": lambda c: ops.fps_blocks(t(win), t(wmask), k=5, chunk=c),
        "ball_query": lambda c: ops.ball_query_blocks(
            t(centers), t(cmask), t(win), t(wmask), radius=0.8, num=4,
            chunk=c),
        "knn": lambda c: ops.knn_blocks(t(centers), t(win), t(wmask), k=3,
                                        chunk=c),
        "gather": lambda c: ops.gather_blocks(
            t(win), t(np.arange(7 * 9, dtype=np.int32).reshape(7, 9) % 70),
            chunk=c),
    }[op]
    a, b = args(3), args(None)
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)


def test_wrappers_select_by_device_only():
    """A CPU tensor runs the plain version and launches nothing; tensors
    split across devices are refused."""
    coords, mask = blocks(0, 2, 33)
    ops.reset_launch_counts()
    ops.fps_blocks(t(coords), t(mask), k=3)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    with pytest.raises(ValueError, match="all lie"):
        ops.fps_blocks(t(coords), t(mask).to("meta"), k=3)


@pytest.mark.parametrize("name", checks.KERNELS)
def test_card_ladder_runs_on_cpu_tensors(name):
    """The card's ladder (chip_smoke.py, tests/test_torch_cuda.py) builds
    and passes its own rules here, where both sides are the plain version;
    the FPS cases wider than 1024 lanes also hold the first-lane and
    exhaustion contract."""
    calls = [a for n, a in checks.ladder("cpu") if n == name]
    assert calls
    for args in calls:
        assert checks.hold(name, args)["max_abs_err"] == 0.0
        if name == "fps_blocks" and args["mask"].shape[1] > 1024:
            idx = ops.fps_blocks(args["coords"], args["mask"], k=args["k"])
            assert idx[0].eq(0).all()
            assert idx[1, 0] == 1030 and set(idx[1, :3].tolist()) == {
                1030, 1100, args["mask"].shape[1] - 1}
            assert idx[1, 3:].eq(idx[1, 2]).all()


def test_count_rule_bounds_each_row_by_its_boundary_lanes():
    """A ball-query count may differ from another only by the lanes of its
    row that lie within the tolerance of r^2."""
    window = torch.tensor([[[0.5, 0, 0], [0.5, 0, 0], [2.0, 0, 0],
                            [0.1, 0, 0]]])
    wmask = torch.tensor([[True, True, True, True]])
    centers = torch.zeros(1, 2, 3)
    centers[0, 1, 0] = 10.0                 # no lane near r from this row
    want = torch.tensor([[3, 0]], dtype=torch.int32)
    kw = dict(radius=0.5, tol=1e-5)
    for got, ok in [([[3, 0]], True), ([[1, 0]], True), ([[6, 0]], False),
                    ([[0, 0]], False), ([[3, 1]], False)]:
        got = torch.tensor(got, dtype=torch.int32)
        if ok:
            checks.check_counts(got, want, centers, window, wmask, **kw)
        else:
            with pytest.raises(AssertionError, match="boundary"):
                checks.check_counts(got, want, centers, window, wmask, **kw)


def test_pad_points_contract():
    coords = torch.arange(15.0).reshape(5, 3)
    padded, valid = ops.pad_points(coords, 8)
    assert padded.shape == (8, 3) and valid.dtype == torch.bool
    assert torch.equal(padded[:5], coords) and padded[5:].eq(0).all()
    assert valid.tolist() == [True] * 5 + [False] * 3
    c2, v2 = ops.pad_points(coords, 5, valid=torch.tensor([1, 1, 0, 1, 1],
                                                          dtype=torch.bool))
    assert c2.shape == (5, 3) and not bool(v2[2])
    with pytest.raises(ValueError, match="pad"):
        ops.pad_points(coords, 4)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_bench.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad
