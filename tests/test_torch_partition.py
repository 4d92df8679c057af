"""The partition's dispatch on the CPU: strategy "fractal" runs the tensor
pass and launches nothing, and the kernel layer refuses CPU tensors; the
baselines never reach the kernel layer; the coordinates carry their
gradient.  The kernel itself is held on the card
(tests/test_torch_cuda.py, the ``partition`` ladder of
``repro_torch.kernels.checks``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fractal  # noqa: E402
from repro_torch.kernels import checks, ops, partition  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cloud(seed, b, n):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(0, 1, (b, n, 3)).astype(np.float32)),
            torch.from_numpy(rng.random((b, n)) < 0.9))


@pytest.mark.parametrize("dim0", [2, "tensor"])
def test_cpu_partition_is_the_tensor_pass_and_launches_nothing(dim0):
    c, v = cloud(0, 3, 700)
    d = torch.tensor([1, -2, 0]) if dim0 == "tensor" else dim0
    args = checks.partition_args(c, v, th=32, dim0=d)
    ops.reset_launch_counts()
    got = fractal.partition(c, v, th=32, dim0=d, on_overflow="silent")
    want = fractal.tensor_pass(c, v, th=32, depth=args["depth"],
                               strategy=fractal.FRACTAL, ml=args["ml"],
                               dim0=args["dim0"])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    checks.hold_result("partition", args, got, want)


def test_kernel_layer_refuses_cpu_tensors():
    c, v = cloud(5, 2, 100)
    with pytest.raises(ValueError, match="on the card only"):
        partition.partition(c, v, th=32, depth=3, ml=8, dim0=0)
    before = partition.partition.launches
    with pytest.raises(ValueError, match="on the card only"):
        partition.partition(c, v, th=32, depth=3, ml=8,
                            dim0=torch.tensor([0, 1]))
    assert partition.partition.launches == before


@pytest.mark.parametrize("strategy", [fractal.UNIFORM, fractal.OCTREE,
                                      fractal.KDTREE])
def test_baselines_do_not_come_through_the_kernel_layer(monkeypatch,
                                                        strategy):
    def refuse(*a, **kw):
        raise AssertionError("a baseline strategy reached the kernel layer")

    monkeypatch.setattr(partition, "partition", refuse)
    c, v = cloud(1, 2, 300)
    part = fractal.partition(c, v, th=32, strategy=strategy,
                             on_overflow="silent")
    assert int(part.num_leaves.min()) >= 1


def test_hold_rule_catches_a_differing_field():
    c, v = cloud(2, 2, 400)
    args = checks.partition_args(c, v, th=32)
    run_kernel, run_plain = checks.runners("partition", args)
    got, want = run_kernel(), run_plain()
    checks.hold_result("partition", args, got, want)
    bad = torch.where(want.leaf_depth == 0, 1, want.leaf_depth)
    with pytest.raises(AssertionError, match="leaf_depth"):
        checks.hold_result("partition", args, got,
                           dataclasses.replace(want, leaf_depth=bad))
    flipped = want.coords.clone()
    flipped[0, 0, 0] = torch.nextafter(flipped[0, 0, 0],
                                       torch.tensor(np.inf))
    with pytest.raises(AssertionError, match="coords"):
        checks.hold_result("partition", args, got,
                           dataclasses.replace(want, coords=flipped))


def test_cpu_partition_carries_the_coordinates_gradient():
    c, v = cloud(3, 2, 500)
    x = c.clone().requires_grad_()
    part = fractal.partition(x, v, th=32, on_overflow="silent")
    w = torch.randn_like(c)
    (g,) = torch.autograd.grad((part.coords * w).sum(), x)
    want = torch.zeros_like(c)
    rows = torch.arange(2)[:, None]
    want[rows, part.perm.long()] = w
    assert torch.equal(g, want)


def test_work_counts_every_output_once():
    c, v = cloud(4, 2, 300)
    args = checks.partition_args(c, v, th=32, depth=3, max_leaves_=5)
    nbytes, ops_ = checks.work("partition", args)
    part = fractal.partition(c, v, th=32, depth=3, max_leaves_=5,
                             on_overflow="silent")
    out = sum(getattr(part, f).numel() * getattr(part, f).element_size()
              for f in part.__dataclass_fields__)
    assert nbytes == c.numel() * 4 + v.numel() + out and ops_ == 0.0
