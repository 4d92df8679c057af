"""The InvResMLP blocks' pooled local aggregation (``kernels.local_aggregate``)
against the formula the blocks ran before it, on the CPU; the CUDA kernel
against its plain version on the card.

The blocks computed ``_pool(ReLU(addmm(b, cat([rel, take(f, nidx)]), W)))``
over a grouped (B, m, ns, C + 3) tensor.  The plain version computes the
same function as ``g = f @ W[3:]`` once a point, then ``rel . W[:3] + g_j +
b`` a slot at a time: only the order of the float32 sums differs, so the
two agree within 1e-6 of the largest output (measured: <= 3.7e-7), and a
centre with no valid slot gives exactly 0.  A masked slot's index may lie
outside the cloud: the plain version never reads it (an out-of-range
``take`` would raise here).

Marked ``cuda``: the kernel equals its plain version bit for bit at
PointNeXt-XL's widths, and refuses to run under autograd.  This file
imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fractal import take  # noqa: E402
from repro_torch.kernels import checks, ops  # noqa: E402
from repro_torch.kernels import local_aggregate as la  # noqa: E402
from repro_torch.models import pnn  # noqa: E402

TOL = 1e-6


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


def block_inputs(seed, b, m, c, ns, case="mixed", device="cpu"):
    """(f, nidx, gmask, rel, W, bias) of one block: ``checks.aggregate_args``'
    neighbours and masks, features f and a folded layer W (C + 3, C)."""
    kw = {"mixed": {}, "no_valid_centre": dict(none=0.3),
          "all_masked_cloud": dict(masked_cloud=True),
          "out_of_range": {}}[case]
    a = checks.aggregate_args(seed, b, m, c, ns, device, **kw)
    if case != "out_of_range":             # masked slots name in-range rows
        a["nidx"] = torch.where(a["gmask"], a["nidx"], 0)
    rng = np.random.default_rng(seed + 1)
    f = torch.from_numpy(rng.normal(0, 1, (b, m, c)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1 / np.sqrt(c + 3), (c + 3, c))
                         .astype(np.float32))
    return (f.to(device), a["nidx"], a["gmask"], a["rel"], w.to(device),
            a["bias"])


def today(f, nidx, gmask, rel, w, bias):
    """The blocks' former local aggregation over the grouped tensor (a
    masked slot's index clamped into the cloud: it is masked anyway)."""
    safe = torch.where(gmask, nidx, 0).clamp(0, f.shape[1] - 1)
    grouped = torch.cat([rel, take(f, safe)], -1)
    h = torch.relu(torch.addmm(bias, grouped.reshape(-1, grouped.shape[-1]),
                               w)).view(*grouped.shape[:-1], w.shape[1])
    return pnn._pool(h, gmask)


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("case", ["mixed", "no_valid_centre",
                                  "all_masked_cloud", "out_of_range"])
@pytest.mark.parametrize("ns", [16, 32])
@pytest.mark.parametrize("c", [33, 128])
def test_plain_matches_the_grouped_formula(c, ns, case):
    f, nidx, gmask, rel, w, bias = block_inputs(c + ns, 3, 90, c, ns, case)
    want = today(f, nidx, gmask, rel, w, bias)
    got = ops.local_aggregate(f @ w[3:], nidx, gmask, rel, w[:3], bias)
    assert got.shape == want.shape == (3, 90, c)
    assert rel_err(got, want) <= TOL
    none = ~(gmask & (nidx >= 0) & (nidx < 90)).any(-1)
    assert bool((got[none] == 0).all()) and bool((want[none] == 0).all())
    if case == "no_valid_centre":
        assert bool(none.any())
    if case == "all_masked_cloud":
        assert bool((got[-1] == 0).all())
    if case == "out_of_range":
        assert bool(((nidx < 0) | (nidx >= 90)).any())
    assert bool((got >= 0).all())


def test_gradient_reaches_la_on_the_cpu():
    """On the CPU the plain version differentiates: the block's gradients
    through it equal those through the grouped formula, every ``la``
    parameter's among them."""
    c, ns = 24, 16
    f, nidx, gmask, rel, _, _ = block_inputs(5, 2, 60, c, ns)
    blk = pnn.InvResMLP(c, 2, "batchnorm", torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk.la.bn.mean.normal_(0, 0.1)
        blk.la.bn.var.uniform_(0.5, 2.0)
    f.requires_grad_()

    def grouped_forward():
        scale, shift = blk.la.bn.affine()
        g = today(f, nidx, gmask, rel, blk.la.dense.w * scale,
                  blk.la.dense.b * scale + shift)
        return torch.relu(f + blk.pw2(blk.pw1(g), act=False))

    params = [f, blk.la.dense.w, blk.la.dense.b, blk.la.bn.g, blk.la.bn.b]
    got = torch.autograd.grad(blk(f, nidx, gmask, rel).square().sum(),
                              params)
    want = torch.autograd.grad(grouped_forward().square().sum(), params)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bool(a.abs().sum() > 0)
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_no_grouped_tensor_inside_the_blocks():
    """No tensor made inside an InvResMLP block of a forward is as large as
    its grouped (B, m, ns, C) features would be."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = pnn.PNNConfig(
        variant="pointnext_invres", task="seg", num_classes=5, n_points=512,
        stages=(pnn.SAStage(0.25, 0.2, 16, (32,)),
                pnn.SAStage(0.25, 0.4, 16, (64,))),
        blocks=(2, 1), expansion=2, stem_width=16, normalize_dp=True,
        norm="batchnorm", fp_widths=((32,), (16,)), head_widths=(16,),
        point_ops="bppo", th=64)
    model = pnn.init(cfg, torch.Generator().manual_seed(0))
    largest = {}

    class Sizes(TorchDispatchMode):
        block = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.block is not None:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        largest[self.block] = max(largest.get(self.block, 0),
                                                  t.numel())
            return out

    mode = Sizes()
    grouped = {}
    for i, st in enumerate(model.stages):
        for j, blk in enumerate(st.blocks):
            m = cfg.stage_sizes()[i + 1]
            grouped[(i, j)] = 2 * m * cfg.stages[i].nsample * \
                cfg.stages[i].widths[-1]
            blk.register_forward_pre_hook(
                lambda *_, k=(i, j): setattr(mode, "block", k))
            blk.register_forward_hook(
                lambda *_: setattr(mode, "block", None))
    pts = torch.from_numpy(np.random.default_rng(2).random(
        (2, 512, 3)).astype(np.float32))
    with torch.no_grad(), mode:
        pnn.apply(model, cfg, pts)
    assert set(largest) == set(grouped)
    assert all(largest[k] < grouped[k] for k in grouped), (largest, grouped)


def test_blocks_need_batchnorm():
    with pytest.raises(ValueError, match="batchnorm"):
        pnn.InvResMLP(8, 4, "layernorm", torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 256, 512, 1024])
def test_kernel_equals_plain_at_xl_widths(cuda_device, c):
    """At PointNeXt-XL's block widths, 32 slots, 4 clouds: the kernel's
    output equals its plain version's, and it launches once."""
    a = checks.aggregate_args(c, 4, 4096 * 128 // c, c, 32, cuda_device)
    before = la.local_aggregate.launches
    assert checks.hold("local_aggregate", a)["max_abs_err"] == 0.0
    assert la.local_aggregate.launches == before + 1


@pytest.mark.cuda
def test_card_op_refuses_autograd(cuda_device):
    a = checks.aggregate_args(7, 2, 40, 32, 16, cuda_device)
    w_r = a["w_r"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        la.local_aggregate(**dict(a, w_r=w_r))
    with torch.no_grad():
        out = la.local_aggregate(**dict(a, w_r=w_r))
    assert torch.equal(out, la.local_aggregate_plain(**a))
