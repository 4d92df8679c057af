"""Point Transformer's vector attention (``kernels.vector_attention``)
against the PyTorch sequence the attention layer ran before it, on the CPU;
the CUDA kernel against its plain version on the card.

The layer computed q and k|v by two matrix products, gathered each slot's
k|v row with ``take`` into a (B, m, k, 2C) tensor, and ran delta, a, the w
layers, the masked softmax and the weighted sum over (B, m, k, .) tensors;
the block then applied its BatchNorm and ReLU.  ``former_block_attention``
below keeps that sequence as the oracle.  Given the same q|k|v, the plain
version runs the same operations in the same order, so the two are equal;
the model's forward computes q|k|v as one product onto 3C, whose sums may
round differently, so there the bar is 1e-6 of the largest output.  A
masked slot's index may lie outside the cloud: the plain version never
reads it (the oracle, whose ``take`` would raise, gets it clamped), and a
point with no valid slot gives ReLU(shift).

Marked ``cuda``: the kernel against its plain version at Point
Transformer's level-0 and level-4 shapes, within ``checks.ATTN_TOL`` of the
largest output (the kernel's float32 FMAs sum w1's C-long products a
channel at a time, the plain version's matrix product in blocks); it
refuses to run under autograd; and a Point Transformer forward launches it
once a block, with no (B, m, k, .) tensor in its attention layers.  This
file imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fractal import take  # noqa: E402
from repro_torch.kernels import checks, ops  # noqa: E402
from repro_torch.kernels import vector_attention as va  # noqa: E402
from repro_torch.models import pnn, point_transformer  # noqa: E402

TOL = 1e-6
NEG = -3.0e38
LEVELS = [(32, 8), (64, 16), (128, 16), (256, 16), (512, 16)]


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


def block(c, seed=0):
    """A Point Transformer block on c channels (share_planes 8) with
    BatchNorm statistics away from the identity."""
    blk = point_transformer.Block(c, 8, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in blk.modules():
            if isinstance(mod, pnn.BatchNorm):
                mod.mean.normal_(0, 0.1, generator=g)
                mod.var.uniform_(0.5, 2.0, generator=g)
                mod.g.uniform_(0.5, 1.5, generator=g)
                mod.b.normal_(0, 0.1, generator=g)
    return blk


def inputs(seed, b, m, c, k, none=0.05):
    """(f, nidx, mask, rel): features and ``checks.attention_args``'
    neighbours, masked slots naming rows outside the cloud half of the
    time."""
    a = checks.attention_args(seed, b, m, c, k, "cpu", none=none)
    f = torch.from_numpy(np.random.default_rng(seed + 7).normal(
        0, 1, (b, m, c)).astype(np.float32))
    return f, a["nidx"], a["mask"], a["rel"]


def former_qkv(attn, f):
    """q and k|v as the layer computed them: two matrix products."""
    b, m, c = f.shape
    s, t = attn.bn_a.affine()
    x = f.reshape(-1, c)
    q = torch.addmm(attn.q.b * s, x, attn.q.w * s).view(b, m, c)
    kv = torch.addmm(torch.cat([attn.k.b * s + t, attn.v.b]), x,
                     torch.cat([attn.k.w * s, attn.v.w], 1))
    return q, kv.view(b, m, 2 * c)


def former_block_attention(blk, f, nidx, mask, rel):
    """The attention layer's former PyTorch sequence, then the block's
    BatchNorm and ReLU (a masked slot's index clamped into the cloud: it
    is masked anyway)."""
    attn = blk.attn
    b, m, c = f.shape
    k = nidx.shape[-1]
    nidx = torch.where(mask, nidx, 0).clamp(0, m - 1)
    s, _ = attn.bn_a.affine()
    q, kv = former_qkv(attn, f)
    q = q.view(b, m, 1, c)
    kv = take(kv, nidx)                                   # (B, m, k, 2C)
    delta = torch.addmm(attn.p2.b, attn.p1(rel).reshape(-1, 3),
                        attn.p2.w).view(b, m, k, c)
    a = torch.addcmul(kv[..., :c] - q, delta, s).relu_()
    w = torch.addmm(attn.w2.b, attn.w1(a).reshape(-1, c // attn.share),
                    attn.w2.w).view(b, m, k, c // attn.share)
    w = torch.softmax(w.masked_fill(~mask[..., None], NEG), dim=2)
    w = w * mask[..., None]
    g = attn.share
    y = (kv[..., c:] + delta).view(b, m, k, g, c // g) * w[..., None, :]
    bs, bt = blk.bn2.affine()
    return torch.addcmul(bt, y.sum(2).view(b, m, c), bs).relu_()


def weights(blk):
    """The kernel's weights of a block, as ``VectorAttention`` folds
    them."""
    attn = blk.attn
    (p1w, p1b), (w1w, w1b) = attn.p1.folded(), attn.w1.folded()
    return (p1w, p1b, attn.p2.w, attn.p2.b, attn.bn_a.affine()[0], w1w, w1b,
            attn.w2.w, attn.w2.b, *blk.bn2.affine())


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("c,k", LEVELS)
def test_plain_equals_the_former_sequence(c, k):
    """Each level's (C, k) of the published net, with masked slots, masked
    slots naming rows outside the cloud, and points with no valid slot:
    the plain version on the former q|k|v equals the former sequence, and
    the layer's forward (q|k|v as one product) agrees within 1e-6."""
    b, m = 2, 70
    blk = block(c, seed=c + k)
    f, nidx, mask, rel = inputs(c + k, b, m, c, k, none=0.1)
    outside = mask.logical_not() & ((nidx < 0) | (nidx >= m))
    none = ~mask.any(-1)
    assert bool(outside.any()) and bool(none.any())
    with torch.no_grad():
        want = former_block_attention(blk, f, nidx, mask, rel)
        q, kv = former_qkv(blk.attn, f)
        plain = va.vector_attention_plain(torch.cat([q, kv], -1), nidx, mask,
                                          rel, *weights(blk))
        got = blk.attn(f, nidx, mask, rel, *blk.bn2.affine())
    assert want.shape == plain.shape == got.shape == (b, m, c)
    assert torch.equal(plain, want)
    assert rel_err(got, want) <= TOL
    shift = blk.bn2.affine()[1]
    assert torch.equal(got[none], torch.relu(shift).expand_as(got[none]))
    assert bool((got >= 0).all())


def test_gradient_reaches_every_parameter_on_the_cpu():
    """On the CPU the plain version differentiates: a block's gradients
    through the layer equal those through the former sequence, for the
    input and every parameter of the layer and its BatchNorm."""
    c, k = 32, 8
    blk = block(c, seed=3)
    f, nidx, mask, rel = inputs(5, 2, 40, c, k)
    f.requires_grad_()
    params = [f] + [p for p in blk.attn.parameters()] + \
        [blk.bn2.g, blk.bn2.b]
    got = torch.autograd.grad(
        blk.attn(f, nidx, mask, rel, *blk.bn2.affine()).square().sum(),
        params)
    want = torch.autograd.grad(
        former_block_attention(blk, f, nidx, mask, rel).square().sum(),
        params)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bool(a.abs().sum() > 0)
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_op_counts_the_work_of_valid_slots():
    """``checks.work``: 16 C + 17 k bytes a point plus the weights, and
    the delta and w layers' operations on valid slots only."""
    a = checks.attention_args(1, 2, 30, 64, 16, "cpu")
    nbytes, flops = checks.work("vector_attention", a)
    valid = int((a["mask"] & (a["nidx"] >= 0) & (a["nidx"] < 30)).sum())
    weights = 9 + 3 + 3 * 64 + 64 + 64 + 64 * 8 + 8 + 8 * 8 + 8 + 64 + 64
    assert nbytes == 2 * 30 * (16 * 64 + 17 * 16) + 4 * weights
    assert flops == valid * 2.0 * (9 + 3 * 64 + 64 * 8 + 8 * 8)


def test_the_op_checks_shapes_on_the_cpu_and_devices():
    a = checks.attention_args(2, 1, 10, 32, 4, "cpu")
    out = ops.vector_attention(**a)
    assert out.shape == (1, 10, 32) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="all lie"):
        ops.vector_attention(**dict(a, qkv=a["qkv"].to("meta")))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("level,b,m,c,k", [
    (0, 2, 40_000, 32, 8), (4, 4, 1129, 512, 16)])
def test_kernel_matches_plain_at_pt_shapes(cuda_device, level, b, m, c, k):
    """Level 0 (C 32, k 8) and level 4 (C 512, k 16) of Point Transformer:
    within ``checks.ATTN_TOL`` of the largest output (the order of w1's
    C-long float32 sums), one launch."""
    a = checks.attention_args(level, b, m, c, k, cuda_device)
    before = va.vector_attention.launches
    res = checks.hold("vector_attention", a)
    assert va.vector_attention.launches == before + 1
    assert res["max_abs_err"] <= checks.ATTN_TOL


@pytest.mark.cuda
def test_card_op_refuses_autograd(cuda_device):
    a = checks.attention_args(7, 2, 40, 32, 8, cuda_device)
    w1w = a["w1w"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        va.vector_attention(**dict(a, w1w=w1w))
    with torch.no_grad():
        out = va.vector_attention(**dict(a, w1w=w1w))
    assert checks.hold_result("vector_attention", a, out,
                              va.vector_attention_plain(**a))


@pytest.mark.cuda
def test_pt_forward_launches_it_once_a_block(cuda_device):
    """A small Point Transformer forward on the card: ``vector_attention``
    launches once a block (11 at blocks [2, 3, 2, 2, 2]), no tensor made
    inside an attention layer is as large as its (B, m, k, C)
    per-neighbour tensor would be, and the logits agree with the CPU's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = point_transformer.config(
        planes=[16, 16, 32, 32, 64], blocks=[2, 3, 2, 2, 2],
        nsample=[8, 16, 16, 16, 16], strides=[1, 4, 4, 4, 4],
        n_points=2048, th=64)
    model = pnn.init(cfg, torch.Generator().manual_seed(0))
    pts = torch.from_numpy(np.random.default_rng(4).random(
        (2, 2048, 3)).astype(np.float32))
    with torch.inference_mode():
        want = pnn.apply(model, cfg, pts)
    model = model.to(cuda_device)
    largest, per_neighbour = {}, {}

    class Sizes(TorchDispatchMode):
        layer = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.layer is not None:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        largest[self.layer] = max(
                            largest.get(self.layer, 0), t.numel())
            return out

    mode = Sizes()

    def enter(mod, args):
        f, nidx = args[0], args[1]
        mode.layer = id(mod)
        per_neighbour[id(mod)] = nidx.numel() * f.shape[-1]

    for mod in model.modules():
        if isinstance(mod, point_transformer.VectorAttention):
            mod.register_forward_pre_hook(enter)
            mod.register_forward_hook(lambda *_: setattr(mode, "layer", None))
    ops.reset_launch_counts()
    with torch.inference_mode(), mode:
        got = pnn.apply(model, cfg, pts.to(cuda_device))
    torch.cuda.synchronize()
    blocks = sum(cfg.enc_blocks) + len(cfg.enc_blocks)
    assert blocks == 11
    assert ops.launch_counts()["vector_attention"] == blocks
    assert set(largest) == set(per_neighbour) and len(largest) == blocks
    assert all(largest[k] < per_neighbour[k] for k in largest)
    assert rel_err(got.cpu(), want) <= 1e-4
