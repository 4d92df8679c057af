"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card every test skips (a CUDA kernel has
no CPU mode).  Imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The ladder and the comparison rules are those of
``repro_torch.kernels.checks``, which chip_smoke.py uses too.  The
gradient test guards the differentiable gather: every parameter of a small
``pointnet2_seg`` must learn on the card, as on the CPU.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fractal  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, checks, fps, ops  # noqa: E402
from repro_torch.models import pnn  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", checks.KERNELS)
def test_kernel_matches_plain_on_the_ladder(cuda_device, name):
    calls = [args for n, args in checks.ladder(cuda_device) if n == name]
    assert calls
    for args in calls:
        checks.hold(name, args)


@pytest.mark.cuda
def test_ball_query_at_the_stride1_shape(cuda_device):
    """The InvResMLP blocks' stride-1 search: 256 centres a leaf block over
    512 window lanes at num 32 (``checks.stride1_ladder``: the leaf's own
    points as centres, empty, all-invalid and scattered blocks, 255 over
    509 lanes, chunked against unchunked), the same indices and bitwise
    the same d2 as the plain version."""
    calls = checks.stride1_ladder(cuda_device)
    assert {tuple(a["q"].shape[1:2]) + (a["num"],) for _, a in calls} >= {
        (256, 32), (255, 32)}
    for name, args in calls:
        checks.hold(name, args)


@pytest.mark.cuda
def test_knn_at_the_stride1_shape(cuda_device):
    """Point Transformer's stride-1 search: 256 queries a leaf block over
    512 window lanes at k 8 and 16 (``checks.knn_stride1_ladder``: the
    window's own lanes as queries, empty, all-invalid and scattered
    windows, fewer valid lanes than k, bit-equal ties, chunked against
    unchunked), the same indices and bitwise the same d2 as the plain
    version."""
    calls = checks.knn_stride1_ladder(cuda_device)
    assert {tuple(a["q"].shape[1:2]) + (a["window"].shape[1], a["num"])
            for _, a in calls} == {(256, 512, 8), (256, 512, 16)}
    for name, args in calls:
        checks.hold(name, args)


@pytest.mark.cuda
def test_kernels_launch_on_the_card_of_their_tensors(cuda_device):
    """Each kernel on ``cuda:1`` while the process's current card is
    ``cuda:0`` (a rank of a mesh holds another card than the one a
    process starts with): the launch goes to the tensors' card and its
    stream, and equals the plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: launches on a card that is not the "
                    "current one")
    second = torch.device("cuda", 1)
    launched = dict.fromkeys(checks.KERNELS, 0)
    with torch.cuda.device(0):
        for name, args in checks.ladder(second):
            if args.get("chunk"):
                continue
            before = ops.KERNELS[name].launches
            checks.hold(name, args)
            launched[name] += ops.KERNELS[name].launches - before
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(second)
    assert all(n > 0 for n in launched.values()), launched


@pytest.mark.cuda
def test_fps_exhaustion_on_the_card(cuda_device):
    c, m = checks.blocks(11, 3, 40, cuda_device, empty=1)
    m[1] = torch.arange(40, device=cuda_device) < 3
    idx = fps.fps_blocks(c, m, k=7).cpu().numpy()
    assert (idx[0] == 0).all()
    assert set(idx[1][:3]) == {0, 1, 2} and (idx[1][3:] == idx[1][2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1, 33, 256, 512])
def test_fps_variants_agree_where_their_widths_meet(cuda_device, bs):
    """At widths the one-warp kernel takes, the CTA and scratch-row kernels
    (which the wrapper keeps for wider blocks) give the same picks as the
    plain version too, exhaustion and an empty block included."""
    c, m = checks.scattered(80 + bs, 6, bs, cuda_device, 0.6)
    m[0] = False
    m[1] = False
    m[1, bs - 1] = True
    want = fps.fps_plain(c, m, 33)
    for kind in fps.ENTRIES:
        got = torch.empty_like(want)
        _build.check(fps.launch(_build.library(), c, m, got, kind), kind)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kind


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_arguments(cuda_device):
    c, m = checks.blocks(0, 2, 33, cuda_device)
    before = fps.fps_blocks.launches
    fps.fps_blocks(c, m, k=3)
    assert fps.fps_blocks.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        fps.fps_blocks(c.double(), m, k=3)
    with pytest.raises(ValueError, match="contiguous"):
        fps.fps_blocks(c.transpose(0, 1).contiguous().transpose(0, 1), m,
                       k=3)


@pytest.mark.cuda
def test_level_kernel_on_partition_leaves(cuda_device):
    """The partition level on a partition's own leaf blocks, each split at
    its valid midpoint, for every (da, db): equal to the plain version, one
    launch a call."""
    pts, _ = synthetic.scene(0, 8192, device=cuda_device)
    part = fractal.partition(pts[None], th=256)
    view, mask, _ = fractal.leaf_view(part, part.coords, 256)
    for da, db in checks.LEVEL_DIMS:
        args = checks.level_at_midpoints(view, mask, da, db)
        before = ops.launch_counts()["fractal_level_blocks"]
        checks.hold("fractal_level_blocks", args)
        assert ops.launch_counts()["fractal_level_blocks"] == before + 1
        assert bool(args["mask"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 4, 13, 18])
def test_partition_launches_two_a_level_and_three(cuda_device, depth):
    """One ``fractal.partition`` call on the card: the level pass, equal to
    the tensor pass, in exactly 2 * depth + 3 launches (a count and a
    scatter pass a level; init, slot scan and compaction), well inside a
    budget of 4 * depth + 3."""
    c, v = checks.scattered(70 + depth, 3, 5000, cuda_device, 0.9)
    args = checks.partition_args(c, v, th=32, depth=depth,
                                 dim0=torch.tensor([2, 0, 1]))
    before = ops.launch_counts()["partition"]
    checks.hold("partition", args)
    launched = ops.launch_counts()["partition"] - before
    assert launched == 2 * depth + 3


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", [fractal.UNIFORM, fractal.OCTREE,
                                      fractal.KDTREE])
def test_baseline_strategies_keep_the_tensor_pass(cuda_device, strategy):
    c, v = checks.scattered(75, 2, 700, cuda_device, 0.9)
    before = ops.launch_counts()["partition"]
    fractal.partition(c, v, th=32, strategy=strategy, on_overflow="silent")
    assert ops.launch_counts()["partition"] == before


@pytest.mark.cuda
def test_partition_on_the_card_carries_the_coordinates_gradient(
        cuda_device):
    c, v = checks.scattered(76, 2, 3000, cuda_device, 0.9)
    w = torch.randn(2, 3000, 3, device=cuda_device)
    card = c.clone().requires_grad_()
    part = fractal.partition(card, v, th=64, dim0=1)
    (g,) = torch.autograd.grad((part.coords * w).sum(), card)
    cpu = c.cpu().requires_grad_()
    want = fractal.partition(cpu, v.cpu(), th=64, dim0=1)
    (gw,) = torch.autograd.grad((want.coords * w.cpu()).sum(), cpu)
    assert torch.equal(part.perm.cpu(), want.perm)
    assert torch.equal(g.cpu(), gw)
    assert part.perm.grad_fn is None


@pytest.mark.cuda
def test_every_seg_parameter_learns_on_the_card(cuda_device):
    cfg = train.model_config(train.TrainConfig(preset="pointnet2_seg",
                                               n_points=1024, th=64))
    model = pnn.init(cfg, torch.Generator().manual_seed(0))
    pts, labels = synthetic.segmentation_batch(0, 0, 2, 1024)
    want, _ = train.grads_fn(model, cfg)(train.param_dict(model),
                                         {"points": pts, "labels": labels})
    card = copy.deepcopy(model).to(cuda_device)
    before = ops.launch_counts()["scatter_add_blocks"]
    got, _ = train.grads_fn(card, cfg)(train.param_dict(card), {
        "points": pts.to(cuda_device), "labels": labels.to(cuda_device)})
    assert ops.launch_counts()["scatter_add_blocks"] == before + 2  # 2 FP
    assert len(got) == 46
    checks.hold_grads(got, want)
