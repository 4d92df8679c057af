"""The port's serving client (``repro_torch.examples.serve_pnn``) against
the reference's engine, on the CPU, at ``--buckets 128,256 --th 64
--requests 6 --microbatch 2`` (PointNeXt, the client's default): the
reference's ``ServeEngine`` weights carried over by
``repro_torch.convert``, the reference's synthetic request stream served
by both.  Every answer has its shape; the logits are held by the serving
rule (|difference| <= ``LOGIT_TOL`` on >= ``LOGIT_SHARE`` of the rows,
PERF.md section 2); one build per plan-cache key.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.examples import serve_pnn  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-3
LOGIT_SHARE = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hold_serving_rule(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    diff = np.abs(got - want).max(-1)
    assert (diff <= LOGIT_TOL).mean() >= LOGIT_SHARE, diff.max()


def test_serve_client_matches_the_reference_engine():
    args = serve_pnn.parse(["--buckets", "128,256", "--th", "64",
                            "--requests", "6", "--microbatch", "2",
                            "--device", "cpu"])
    cfg = serve_pnn.config(args)
    assert cfg.buckets == (128, 256) and cfg.variant == "pointnext"
    jeng = jserve.ServeEngine(jserve.ServeConfig(
        buckets=cfg.buckets, microbatch=2, max_wait_s=cfg.max_wait_s,
        variant="pointnext", th=64, impl="xla"), seed=args.seed)
    sizes = serve.mixed_request_sizes(cfg.buckets, args.requests, args.seed)
    assert sizes == jserve.mixed_request_sizes(cfg.buckets, 6, args.seed)
    clouds = [np.array(jsynthetic.segmentation_batch(args.seed, r, 1,
                                                     n)[0][0])
              for r, n in enumerate(sizes)]
    params = convert.from_jax(jax.tree.map(np.asarray, jeng.params),
                              jeng._model_cfg(cfg.buckets[0]))
    seen = []
    report, got = serve_pnn.run(cfg, iter(clouds), params=params,
                                device=args.device, log=seen.append)

    jrids = [jeng.submit(c) for c in clouds]
    jeng.flush()
    for g, rid, c in zip(got, jrids, clouds):
        assert g.shape == (len(c), cfg.num_classes)
        hold_serving_rule(g, np.asarray(jeng.take(rid)))
    assert report["served"] == len(clouds)
    assert sum(r["count"] for r in report["buckets"].values()) == 6
    assert set(report["buckets"]) <= set(cfg.buckets)
    assert report["executables"] == 4 and report["one_trace_per_key"]
    assert "launches" not in report            # counted on the card only
    assert any(s.startswith("plan cache: 4 executables") for s in seen)
