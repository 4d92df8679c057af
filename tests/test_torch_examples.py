"""The port's thin clients (``repro_torch.examples``) on the CPU: quickstart
against the reference's ``examples/quickstart.py``, the LM smoke client,
and the rules every client keeps.

* quickstart: the reference script runs under ``runpy`` and the port's
  client on the same numpy cloud (``--device cpu``).  The partition's
  integers, the sampled count and every ball-query count are equal
  exactly; the mean in-radius count and the recall within ``MEAN_TOL``
  (both are means of those integers in float64, so only a near-tie in a
  ball-query row could move them: ROADMAP C).
* segment_scene at ``--n 4096 --tile-points 1024 --th 64`` on the
  reference's own scene points: tiles, halo points and the largest tile
  cloud equal the reference ``SceneEngine``'s plan, and every point is
  owned by exactly one tile.
* lm_pretrain_smoke: a reduced smollm-135m with int8 compression; the
  loss is finite, a rerun with the same ``--ckpt`` resumes at the
  checkpoint's step, and one with more steps trains on from there.
* No client imports ``jax`` or ``repro``, and each raises without
  ``--device`` where there is no card.

The serving client is held in tests/test_torch_examples_serve.py, the
PointNet++ trainer in tests/test_torch_examples_train.py, each client's
``python -m`` entry in tests/test_torch_examples_cli.py.
"""
import contextlib
import importlib
import io
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scene as jscene  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.examples import (lm_pretrain_smoke, quickstart,  # noqa: E402
                                  segment_scene)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "src" / "repro_torch" / "examples"
CLIENTS = ("quickstart", "serve_pnn", "segment_scene", "train_pointnet",
           "lm_pretrain_smoke")
MEAN_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_quickstart():
    """The globals of the reference's examples/quickstart.py, run once."""
    import runpy
    with contextlib.redirect_stdout(io.StringIO()):
        return runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                              run_name="__main__")


def test_quickstart_matches_the_reference_script(reference_quickstart):
    ref = reference_quickstart
    part, samp, nb = ref["part"], ref["samp"], ref["nb"]
    pts = np.asarray(ref["pts"])
    np.testing.assert_array_equal(pts, quickstart.cloud())
    seen = []
    got = quickstart.run(pts, torch.device("cpu"), log=seen.append)
    sval = np.asarray(samp.valid)
    assert got == {
        "points": 4096, "k_out": 1024,
        "blocks": int(part.num_leaves), "max_leaf": int(part.max_leaf_vsize),
        "traversals": int(part.traversals), "sorts": int(part.sort_passes),
        "sampled": int(sval.sum()),
        "mean_cnt": pytest.approx(float(np.asarray(nb.cnt)[sval].mean()),
                                  abs=MEAN_TOL),
        "recall": pytest.approx(float(np.mean(ref["recalls"])),
                                abs=MEAN_TOL)}
    assert len(seen) == 4 and seen[0].startswith(
        f"partitioned 4096 points -> {got['blocks']} blocks")
    assert got["sorts"] == 0 and got["max_leaf"] <= quickstart.TH


def test_quickstart_rows_equal_the_reference_script(reference_quickstart):
    """Row by row, not only the means: the partition's permutation, the
    samples, and every sampled center's ball-query count and mask."""
    from repro_torch import core
    ref = reference_quickstart
    part, samp, nb = ref["part"], ref["samp"], ref["nb"]
    tp = core.partition(torch.from_numpy(quickstart.cloud())[None], th=256)
    ts = core.blockwise_fps(tp, rate=0.25, k_out=1024, bs=256)
    tn = core.blockwise_ball_query(tp, ts, radius=0.3, num=16, w=512)
    for name, got, want in (("perm", tp.perm, part.perm),
                            ("idx", ts.idx, samp.idx),
                            ("valid", ts.valid, samp.valid),
                            ("cnt", tn.cnt, nb.cnt),
                            ("mask", tn.mask, nb.mask)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want),
                                      err_msg=name)


def test_lm_smoke_trains_and_resumes(tmp_path):
    argv = ["--steps", "4", "--batch", "2", "--seq", "16", "--compression",
            "int8", "--device", "cpu", "--ckpt", str(tmp_path)]
    first = lm_pretrain_smoke.main(argv)
    assert first["resumed_from"] is None and first["start_step"] == 0
    assert first["steps_run"] == 4 and len(first["losses"]) == 4
    assert all(math.isfinite(x) for x in first["losses"])
    # Random weights: the first loss is near ln(vocab).
    vocab = configs.lm_reduced("smollm-135m").vocab
    assert abs(first["losses"][0] - math.log(vocab)) < 0.5

    again = lm_pretrain_smoke.main(argv)
    assert again["resumed_from"] == 4 and again["steps_run"] == 0
    more = lm_pretrain_smoke.main(argv[:1] + ["6"] + argv[2:])
    assert more["resumed_from"] == 4 and more["start_step"] == 4
    assert more["steps_run"] == 2
    assert all(math.isfinite(x) for x in more["losses"])


def test_lm_smoke_stream_is_seeded_by_step():
    cfg = configs.lm_reduced("smollm-135m")
    nxt = lm_pretrain_smoke.stream(cfg, 2, 16)
    a, b = nxt(3), nxt(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], nxt(4)["tokens"])
    want = (a["tokens"] * 7 + torch.arange(16)) % cfg.vocab
    assert torch.equal(a["labels"], want)


def test_scene_client_plans_as_the_reference_engine():
    args = segment_scene.parse(["--n", "4096", "--tile-points", "1024",
                                "--th", "64", "--device", "cpu"])
    cfg = segment_scene.config(args)
    pts, labels = jsynthetic.scene(args.seed, args.n)
    want = jscene.SceneEngine(jscene.SceneConfig(
        tile_points=1024, halo=0.15, th=64, microbatch=4,
        variant="pointnet2", impl="xla")).plan(pts)
    out = segment_scene.run(pts, labels, cfg, device=args.device,
                            log=lambda *_: None)
    assert want.num_tiles >= 2 and want.halo_points > 0
    assert (out["tiles"], out["halo_points"], out["max_tile_n"]) == (
        want.num_tiles, want.halo_points, want.max_tile_n)
    assert out["points"] == 4096 and out["owned_once"] and out["finite"]
    assert sum(out["class_counts"]) == 4096
    assert 0.0 <= out["agreement"] <= 1.0
    assert "peak_device_gib" not in out and out["peak_rss_mb"] > 0


def test_no_client_loads_jax_or_the_reference():
    """Importing every client, in a fresh process, loads no module of
    ``jax`` or ``repro``, directly or through what it imports (the source
    scan of tests/test_torch_kernels.py sees direct imports only)."""
    assert {f.stem for f in EXAMPLES.glob("*.py")} == set(CLIENTS) | {
        "__init__"}
    code = ("import sys\n"
            + "".join(f"import repro_torch.examples.{n}\n" for n in CLIENTS)
            + "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("name", CLIENTS)
def test_client_needs_a_card_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
