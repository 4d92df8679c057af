"""The port's ``ServeEngine`` with ``point_ops="global"`` against the JAX
package's, on the CPU.

With the global ops the engine has no partition plan: each microbatch
goes straight through the O(n^2) forward (``core/ref.py``) and ``dim0`` is
ignored.  Both engines serve the same mixed-size stream with the same
weights (the JAX engine's, carried over by ``repro_torch.convert``);
per-request logits must agree within 1e-4, the bar
tests/test_torch_serve.py holds the BPPO engines to.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from test_torch_serve import cloud  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

KW = dict(buckets=(128, 256), microbatch=2, max_wait_s=1.0,
          variant="pointnet2", task="seg", th=64, point_ops="global")


def test_global_engine_matches_jax_engine():
    jeng = jserve.ServeEngine(jserve.ServeConfig(impl="xla", **KW), seed=5)
    params = convert.from_jax(jax.tree.map(np.asarray, jeng.params),
                              jeng._model_cfg(128))
    teng = serve.ServeEngine(serve.ServeConfig(**KW), params=params,
                             device="cpu")
    clouds = [cloud(n, 20 + i) for i, n in enumerate([100, 256, 70, 200])]
    jrids = [jeng.submit(c, dim0=i % 3) for i, c in enumerate(clouds)]
    trids = [teng.submit(c, dim0=i % 3) for i, c in enumerate(clouds)]
    jeng.flush()
    teng.flush()
    for jr, tr, c in zip(jrids, trids, clouds):
        got, want = teng.take(tr), np.asarray(jeng.take(jr))
        assert got.shape == want.shape == (len(c), 6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    keys = {k[0] for k in teng.plans.traces}
    assert keys == {"serve"}                   # no partition plan was built
