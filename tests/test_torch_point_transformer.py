"""The port's ``point_transformer`` variant (Point Transformer for
segmentation) against plain versions, on the CPU at a small size.

* BPPO: logits against the benchmark's plain reference,
  ``perfbench/reference/point_transformer.py`` (which searches once a
  layer, as published, and applies each BatchNorm as written), on seeded
  random weights with BatchNorm statistics.
* The stride-1 kNN (``bppo.blockwise_knn_points``) against ``knn_plain``
  leaf by leaf: all-valid leaves, windows of fewer than k valid lanes, and
  duplicated points, whose bit-equal distances only the lowest lane
  decides.
* One search a level: ``pt_searches`` and ``pt_blocks`` through the
  serving engine.
* The preset at published widths, and the global point ops, which the
  variant does not run.  (The other variants' logits as they were before
  it existed, ``fixtures/pnn_variants_logits.npz``, are held by
  ``test_torch_pnn_invres.py::test_other_variants_unchanged``.)

Logits must agree within 1e-4 relative to the largest logit, the bar
tests/test_point_impls.py sets between two implementations of the same
float32 arithmetic.  Measured: 8.7e-07; what differs is rounding only
(BatchNorm folded into the dense weights and the attention's BatchNorm
folded into q and k in the port, computed as written in the reference),
while computing the reference in TF32 moves it by ~1.8e-3.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import harness  # noqa: E402
from perfbench.reference import point_transformer as refpt  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import bppo  # noqa: E402
from repro_torch.core.fractal import partition  # noqa: E402
from repro_torch.kernels.knn import knn_plain  # noqa: E402
from repro_torch.models import pnn, point_transformer  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.engine import MODEL_FIELDS  # noqa: E402

TOL = 1e-4
N, TH = 2048, 64
CFG = {"variant": "point_transformer", "in_channels": 3, "th": TH,
       "num_classes": 13, "planes": [16, 16, 32, 32, 64],
       "blocks": [2, 3, 2, 2, 2],
       "strides": [1, 4, 4, 4, 4], "nsample": [8, 16, 16, 16, 16],
       "share_planes": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_config(cfg=CFG, n=N, point_ops="bppo"):
    """The ``PNNConfig`` of a benchmark-style configuration ``cfg``."""
    return point_transformer.config(
        planes=cfg["planes"], blocks=cfg["blocks"], nsample=cfg["nsample"],
        strides=cfg["strides"], share_planes=cfg["share_planes"],
        num_classes=cfg["num_classes"], n_points=n,
        in_channels=cfg["in_channels"], th=cfg["th"], point_ops=point_ops)


def weights(cfg=CFG, seed=3):
    """The benchmark's weights: ``harness.make_weights``, BatchNorm's
    running variance exp(0.2 * normal)."""
    w = harness.make_weights(refpt.param_shapes(cfg), seed,
                             torch.device("cpu"))
    return {k: torch.exp(2.0 * v) if k.endswith(".var") else v
            for k, v in w.items()}


def clouds(b=2, n=N, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.random((b, n, 3)).astype(np.float32))
    valid = torch.ones((b, n), dtype=torch.bool)
    valid[1, -700:] = False                     # a padded tail on cloud 1
    return pts, valid


def test_bppo_logits_match_the_reference():
    mcfg = model_config()
    m = pnn.init(mcfg)
    m.load_state_dict(weights(), strict=True)
    pts, valid = clouds()
    with torch.no_grad():
        got = pnn.apply(m, mcfg, pts, valid=valid)
    want = refpt.segment(CFG, weights(), pts, valid, chunk=16)
    assert got.shape == want.shape == (2, N, 13)
    assert bool(torch.isfinite(got).all())
    scale = want[valid].abs().max()
    assert float((got[valid] - want[valid]).abs().max() / scale) <= TOL


# -- the stride-1 kNN --------------------------------------------------------

def _sparse():
    """Cloud 0: a cluster of 67 points and 3 far ones, which split into a
    depth-1 leaf of 3 points that searches itself (3 valid lanes < k);
    cloud 1: 10 valid points, one leaf."""
    rng = np.random.default_rng(11)
    pts = rng.random((2, 256, 3)).astype(np.float32) * 0.1
    pts[0, 67:70, 0] += 5.0
    valid = np.zeros((2, 256), dtype=bool)
    valid[0, :70] = True
    valid[1, :10] = True
    return torch.from_numpy(pts), torch.from_numpy(valid)


def _ties():
    """Lattice points, each repeated 4 times: many bit-equal distances."""
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
    lat = np.repeat(g.reshape(-1, 3).astype(np.float32) * 0.125, 4, 0)
    pts = np.stack([lat, lat[::-1].copy()])
    return torch.from_numpy(pts), torch.ones(pts.shape[:2], dtype=torch.bool)


@pytest.mark.parametrize("case", ["dense", "sparse", "ties"])
def test_stride1_knn_matches_knn_plain_per_leaf(case):
    pts, valid = {"dense": lambda: clouds(seed=7), "sparse": _sparse,
                  "ties": _ties}[case]()
    n = pts.shape[1]
    part = partition(pts, valid, th=TH)
    k, w = 16, 2 * TH
    nidx, nmask = bppo.blockwise_knn_points(part, k=k, w=w, bs=TH, chunk=5)
    whole = bppo.blockwise_knn_points(part, k=k, w=w, bs=TH)
    assert torch.equal(nidx, whole[0]) and torch.equal(nmask, whole[1])
    seen = torch.zeros(pts.shape[:2], dtype=torch.bool)
    short = 0
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
            wmask = (lanes < ps + pv) & part.valid[b, lanes.clamp(max=n - 1)]
            win = part.coords[b, lanes.clamp(max=n - 1)]
            idx, d2 = knn_plain(part.coords[b, ls:ls + lv][None], win[None],
                                wmask[None], k=k)
            ok = d2[0] < 3.0e38
            want = torch.where(ok, idx[0], idx[0][:, :1]) + lo
            rows = slice(ls, ls + lv)
            assert torch.equal(nidx[b, rows].long(), want)
            assert torch.equal(nmask[b, rows], ok)
            assert torch.equal(want[:, 0], torch.arange(ls, ls + lv)) or \
                case == "ties"                      # each its own nearest
            short += int((~ok).any(-1).sum())
            seen[b, rows] = True
    assert torch.equal(seen, part.valid)            # every valid point once
    assert not bool(nmask[~part.valid].any())
    assert (short > 0) == (case == "sparse")


# -- one search a level ------------------------------------------------------

def test_one_search_a_level():
    """The published counts (13 encoder and 5 decoder blocks) at small
    widths: five searches and 18 blocks a forward, two microbatches."""
    cfg = dict(CFG, planes=[8, 8, 16, 16, 16], blocks=[2, 3, 4, 6, 3])
    mcfg = model_config(cfg, n=512)
    obs.reset()
    scfg = ServeConfig(
        buckets=(512,), microbatch=2, variant=mcfg.variant, task="seg",
        num_classes=13, th=TH, on_overflow="silent",
        **{f: getattr(mcfg, f) for f in MODEL_FIELDS})
    eng = ServeEngine(scfg, device="cpu")
    pts, _ = clouds(b=3, n=512, seed=9)
    for k in range(3):
        eng.submit(pts[k].numpy())
    eng.flush()
    st = eng.stats()
    assert st["model"] == {"pt_searches": 2 * 5, "pt_blocks": 2 * 18}
    assert st["phases"]["attn"]["host_ms"] > 0
    names = {s["name"] for r in obs.snapshot()["microbatches"]
             for s in r["spans"]}
    assert {f"pt{l}.group" for l in range(5)} <= names
    assert {"plan", "sa2.plan", "sa3.plan", "sa4.plan", "pt4.plan",
            "pt3.enc4.attn", "pt3.enc4.mlp", "pt0.dec.attn", "fp.top.mlp",
            "fp0.interpolate", "fp3.mlp", "stem.mlp", "head"} <= names
    assert not {"sa1.plan", "pt0.plan"} & names     # the stage-0 plan
    obs.reset()


# -- the preset, the global ops ----------------------------------------------

def test_preset_at_published_widths():
    """Point Transformer (S3DIS): 7,776,305 parameters (7.8 M published;
    the port's dense layers before a BatchNorm keep a bias, 8,672 of
    them), 13 encoder and 5 decoder blocks over planes 32 to 512."""
    cfg = pnn.point_transformer_seg()
    with torch.device("meta"):
        m = point_transformer.PointTransformer(cfg, None)
    assert sum(p.numel() for p in m.parameters()) == 7_776_305
    assert [len(lv.enc) for lv in m.levels] == [1, 2, 3, 5, 2]
    assert [len(lv.dec) for lv in m.levels] == [1] * 5
    assert [lv.down.dense.w.shape for lv in m.levels] == [
        (3, 32), (35, 64), (67, 128), (131, 256), (259, 512)]
    attn = m.levels[4].enc[0].attn
    assert attn.w1.dense.w.shape == (512, 64) and attn.w2.w.shape == (64, 64)
    assert m.levels[4].up.linear1.dense.w.shape == (1024, 512)
    assert m.levels[0].up.linear2.dense.w.shape == (64, 32)
    assert cfg.stage_sizes() == [289_000, 72_250, 18_062, 4_516, 1_129]
    assert point_transformer.level_k(cfg) == (8, 16, 16, 16, 16)
    assert cfg.share_planes == 8 and cfg.num_classes == 13


def test_global_point_ops_raise():
    mcfg = model_config(n=256, point_ops="global")
    m = pnn.init(mcfg)
    pts, valid = clouds(n=256)
    with pytest.raises(ValueError, match="point_transformer"):
        pnn.apply(m, mcfg, pts, valid=valid)
