"""The port's ``pointnext_invres`` variant (PointNeXt with InvResMLP blocks)
against plain versions, on the CPU at a small size.

* BPPO: logits against the benchmark's plain reference,
  ``perfbench/reference/pointnext.py`` (which searches once a block, as
  published), on seeded random weights with BatchNorm statistics.
* Global point ops: the same net against a plain global forward written
  here (O(n^2) FPS, ball query and 3-NN over each cloud's valid points).
* The stride-1 search (``bppo.blockwise_ball_query_points``) against
  ``ball_query_plain`` leaf by leaf.
* One search a stage: ``res_queries`` counts the stages that have blocks.
* The other variants' logits as they were before the variant existed
  (``fixtures/pnn_variants_logits.npz``).

Logits must agree within 1e-4 relative to the largest logit, the bar
tests/test_point_impls.py sets between two implementations of the same
float32 arithmetic.  Measured: 1.05e-06 (BPPO) and 1.24e-06 (global);
what differs is rounding only (BatchNorm folded into the dense weights in
the port, and the local aggregation's feature half computed once a point,
computed as written in the plain versions), while computing the reference
in TF32 moves it by ~1.6e-3.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import harness  # noqa: E402
from perfbench.reference import pointnext as refx  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import bppo  # noqa: E402
from repro_torch.core.fractal import partition  # noqa: E402
from repro_torch.kernels.ball_query import ball_query_plain  # noqa: E402
from repro_torch.models import pnn  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

TOL = 1e-4
N, TH = 2048, 64
CFG = {"variant": "pointnext_invres", "in_channels": 3, "stem_width": 32,
       "th": TH, "num_classes": 13, "expansion": 4, "radius_scaling": 2.0,
       "normalize_dp": True, "norm": "batchnorm",
       "stages": [{"rate": 0.25, "radius": 0.1, "nsample": 16,
                   "widths": [64]},
                  {"rate": 0.25, "radius": 0.2, "nsample": 16,
                   "widths": [128]}],
       "blocks": [2, 2], "fp_widths": [[64, 64], [32, 32]],
       "head_widths": [32]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_config(cfg=CFG, point_ops="bppo", n=N):
    return pnn.PNNConfig(
        variant=cfg["variant"], task="seg", num_classes=cfg["num_classes"],
        n_points=n, in_channels=cfg["in_channels"],
        stages=tuple(pnn.SAStage(s["rate"], s["radius"], s["nsample"],
                                 tuple(s["widths"])) for s in cfg["stages"]),
        blocks=tuple(cfg["blocks"]), expansion=cfg["expansion"],
        stem_width=cfg["stem_width"],
        normalize_dp=cfg["normalize_dp"], norm=cfg["norm"],
        radius_scaling=cfg["radius_scaling"],
        fp_widths=tuple(tuple(w) for w in cfg["fp_widths"]),
        head_widths=tuple(cfg["head_widths"]), point_ops=point_ops,
        th=cfg["th"])


def weights(cfg=CFG, seed=3):
    """The benchmark's weights: ``harness.make_weights``, BatchNorm's
    running variance exp(0.2 * normal)."""
    w = harness.make_weights(refx.param_shapes(cfg), seed,
                             torch.device("cpu"))
    return {k: torch.exp(2.0 * v) if k.endswith(".var") else v
            for k, v in w.items()}


def model(cfg=CFG, point_ops="bppo"):
    mcfg = model_config(cfg, point_ops)
    m = pnn.PNN(mcfg, torch.Generator().manual_seed(0))
    m.load_state_dict(weights(cfg), strict=True)
    return m, mcfg


def clouds(b=2, n=N, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.random((b, n, 3)).astype(np.float32))
    valid = torch.ones((b, n), dtype=torch.bool)
    valid[1, -300:] = False                     # a padded tail on cloud 1
    return pts, valid


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_bppo_logits_match_the_reference():
    m, mcfg = model()
    pts, valid = clouds()
    with torch.no_grad():
        got = pnn.apply(m, mcfg, pts, valid=valid)
    want = refx.segment(CFG, weights(), pts, valid, chunk=16)
    assert got.shape == want.shape == (2, N, 13)
    assert rel(got[valid], want[valid]) <= TOL


# -- a plain global forward ------------------------------------------------

def plain_fps(p, k):
    """Farthest point sampling from the first point, the first maximum on
    ties; difference-form distances, as the global ops."""
    mind = torch.full((p.shape[0],), float("inf"))
    picks, last = [0], 0
    mind[0] = -1.0
    for _ in range(k - 1):
        d = ((p - p[last]) ** 2).sum(-1)
        mind = torch.where(mind < 0, mind, torch.minimum(mind, d))
        last = int(torch.argmax(mind))
        mind[last] = -1.0
        picks.append(last)
    return torch.tensor(picks)


def nearest(q, p, k):
    """The ``k`` nearest of ``p`` to each row of ``q`` (lowest index on
    ties) and their squared distances."""
    d = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    d2, idx = torch.sort(d, dim=-1, stable=True)
    return idx[:, :k], d2[:, :k]


def group(p, q, radius, num):
    """(idx, mask): ``num`` nearest of ``p`` to ``q`` within ``radius``,
    an empty slot repeating the nearest."""
    idx, d2 = nearest(q, p, num)
    ok = d2 <= np.float32(radius) * np.float32(radius)
    return torch.where(ok, idx, idx[:, :1]), ok


def layer(w, prefix, x, act=True):
    x = x @ w[f"{prefix}.dense.w"] + w[f"{prefix}.dense.b"]
    x = ((x - w[f"{prefix}.bn.mean"])
         / torch.sqrt(w[f"{prefix}.bn.var"] + 1e-5) * w[f"{prefix}.bn.g"]
         + w[f"{prefix}.bn.b"])
    return torch.relu(x) if act else x


def pool(h, mask):
    return torch.where(mask[..., None], h, -3.0e38).amax(-2)


def plain_global(cfg, w, p, sizes):
    """Logits of one cloud ``p`` (n, 3) through PointNeXt with InvResMLP
    blocks, global point ops, ``sizes[i + 1]`` centres at stage i."""
    f = p @ w["stem.w"] + w["stem.b"]
    levels = [(p, f)]
    for i, (s, blocks) in enumerate(zip(cfg["stages"], cfg["blocks"])):
        src, feats = levels[-1]
        c = src[plain_fps(src, sizes[i + 1])]
        idx, mask = group(src, c, s["radius"], s["nsample"])
        x = torch.cat([(src[idx] - c[:, None]) / s["radius"], feats[idx]], -1)
        f = pool(layer(w, f"stages.{i}.mlp.0", x), mask)
        r = s["radius"] * cfg["radius_scaling"]
        idx, mask = group(c, c, r, s["nsample"])
        for j in range(blocks):
            b = f"stages.{i}.blocks.{j}"
            x = torch.cat([(c[idx] - c[:, None]) / r, f[idx]], -1)
            g = pool(layer(w, f"{b}.la", x), mask)
            h = layer(w, f"{b}.pw2", layer(w, f"{b}.pw1", g), act=False)
            f = torch.relu(f + h)
        levels.append((c, f))
    up = levels[-1][1]
    for i in range(len(cfg["fp_widths"])):
        lvl = len(cfg["stages"]) - 1 - i
        fine, skip = levels[lvl]
        coarse = levels[lvl + 1][0]
        idx, d2 = nearest(fine, coarse, 3)
        wt = 1.0 / (d2 + 1e-8)
        wt = wt / wt.sum(-1, keepdim=True)
        x = torch.cat([(up[idx] * wt[..., None]).sum(-2), skip], -1)
        for k in range(len(cfg["fp_widths"][i])):
            x = layer(w, f"fp.{i}.{k}", x)
        up = x
    return layer(w, "head.0", up) @ w["out.w"] + w["out.b"]


def test_global_logits_match_a_plain_global_forward():
    m, mcfg = model(point_ops="global")
    pts, valid = clouds(n=1024, seed=4)
    mcfg = dataclasses.replace(mcfg, n_points=1024)
    with torch.no_grad():
        got = pnn.apply(m, mcfg, pts, valid=valid)
        for b in range(2):
            p = pts[b][valid[b]]                     # a valid prefix
            want = plain_global(CFG, weights(), p, mcfg.stage_sizes())
            assert rel(got[b][valid[b]], want) <= TOL


# -- the stride-1 search ---------------------------------------------------

def test_stride1_search_matches_ball_query_plain_per_leaf():
    pts, valid = clouds(seed=7)
    part = partition(pts, valid, th=TH)
    radius, num, w = 0.12, 16, 2 * TH
    nidx, nmask = bppo.blockwise_ball_query_points(
        part, radius=radius, num=num, w=w, bs=TH, chunk=5)
    whole = bppo.blockwise_ball_query_points(part, radius=radius, num=num,
                                             w=w, bs=TH)
    assert torch.equal(nidx, whole[0]) and torch.equal(nmask, whole[1])
    r2 = np.float32(radius) * np.float32(radius)
    seen = torch.zeros(pts.shape[:2], dtype=torch.bool)
    for b in range(2):
        for leaf in range(part.ml):
            if not bool(part.is_leaf[b, leaf]):
                continue
            ls, lv = int(part.leaf_start[b, leaf]), int(part.leaf_vsize[b,
                                                                    leaf])
            ps, pv = int(part.parent_start[b, leaf]), int(
                part.parent_vsize[b, leaf])
            lo = min(max(ls - max((w - lv) // 2, 0), ps), max(ps, ps + pv - w))
            lanes = torch.arange(lo, lo + w)
            wmask = (lanes < ps + pv) & part.valid[b, lanes.clamp(max=N - 1)]
            win = part.coords[b, lanes.clamp(max=N - 1)]
            q = part.coords[b, ls:ls + lv]
            idx, d2, _ = ball_query_plain(
                q[None], torch.ones((1, lv), dtype=torch.bool), win[None],
                wmask[None], radius=radius, num=num)
            ok = d2[0].clamp(min=0) <= r2
            want = torch.where(ok, idx[0], idx[0][:, :1]) + lo
            rows = slice(ls, ls + lv)
            assert torch.equal(nidx[b, rows].long(), want)
            assert torch.equal(nmask[b, rows], ok)
            assert bool(ok[:, 0].all())             # each its own nearest
            seen[b, rows] = True
    assert torch.equal(seen, part.valid)            # every valid point once
    assert not bool(nmask[~part.valid].any())


# -- one search a stage ----------------------------------------------------

@pytest.mark.parametrize("blocks", [(2, 2), (3, 0)])
def test_one_search_a_stage(blocks):
    cfg = dict(CFG, blocks=list(blocks), stem_width=16,
               stages=[dict(s, widths=[16]) for s in CFG["stages"]],
               fp_widths=[[16], [16]], head_widths=[16])
    mcfg = model_config(cfg, n=512)
    obs.reset()
    scfg = ServeConfig(
        buckets=(512,), microbatch=2, variant=mcfg.variant, task="seg",
        num_classes=13, th=TH, stages=mcfg.stages, fp_widths=mcfg.fp_widths,
        head_widths=mcfg.head_widths, blocks=mcfg.blocks,
        expansion=mcfg.expansion, stem_width=mcfg.stem_width,
        normalize_dp=True, norm="batchnorm", on_overflow="silent")
    eng = ServeEngine(scfg, device="cpu")
    pts, _ = clouds(b=3, n=512, seed=9)
    for k in range(3):                               # two microbatches
        eng.submit(pts[k].numpy())
    eng.flush()
    stages_with_blocks = sum(1 for k in blocks if k)
    assert eng.stats()["model"] == {"res_queries": 2 * stages_with_blocks,
                                    "res_blocks": 2 * sum(blocks)}
    names = {s["name"] for r in obs.snapshot()["microbatches"]
             for s in r["spans"]}
    assert "stem.mlp" in names and "sa0.res.group" in names
    assert ("sa1.res.group" in names) == bool(blocks[1])
    assert ("sa1.res.plan" in names) == bool(blocks[1])
    obs.reset()


# -- the other variants ----------------------------------------------------

@pytest.mark.parametrize("variant", ["pointnet2", "pointnext", "pointvector"])
@pytest.mark.parametrize("task", ["cls", "seg"])
@pytest.mark.parametrize("point_ops", ["bppo", "global"])
def test_other_variants_unchanged(variant, task, point_ops):
    """The logits each variant gave before ``pointnext_invres`` existed
    (bit for bit on the machine that wrote the fixture; 1e-6 here, for
    another CPU's float32 matmul kernels)."""
    want = np.load(REPO / "tests" / "fixtures" / "pnn_variants_logits.npz")[
        f"{variant}.{task}.{point_ops}"]
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.normal(0, 1, (2, 256, 3)).astype(np.float32))
    valid = torch.ones((2, 256), dtype=torch.bool)
    valid[1, -40:] = False
    cfg = pnn.PNNConfig(variant=variant, task=task, n_points=256,
                        point_ops=point_ops, th=64)
    m = pnn.init(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = pnn.apply(m, cfg, pts, valid=valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_blocks_need_the_variant():
    cfg = dataclasses.replace(model_config(), variant="pointnext")
    with pytest.raises(ValueError, match="pointnext_invres"):
        pnn.PNN(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="one count a stage"):
        pnn.PNN(dataclasses.replace(model_config(), blocks=(1,)),
                torch.Generator().manual_seed(0))


def test_xl_preset_at_published_widths():
    """PointNeXt-XL: 41.62 M parameters (41.6 M published; the port's
    dense layers before a BatchNorm keep a bias), 20 blocks in its five
    stages (the stem, 4 set abstractions, 15 InvResMLP blocks)."""
    cfg = pnn.pointnext_xl_seg()
    with torch.device("meta"):
        m = pnn.PNN(cfg, None)
    assert sum(p.numel() for p in m.parameters()) == 41_619_469
    assert sum(len(s.blocks) for s in m.stages) == 15
    assert [s.mlp[0].dense.w.shape[1] for s in m.stages] == [128, 256, 512,
                                                             1024]
    assert m.stages[1].blocks[0].pw1.dense.w.shape == (256, 1024)
