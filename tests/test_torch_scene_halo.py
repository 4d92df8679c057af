"""The port's ``SceneEngine.infer`` against the JAX package's, with halos.

The multistage half of tests/test_torch_scene_seg.py (which holds the
method and the 1e-4 bar): the two-stage model of tests/test_scene.py's
multistage case, halo radius 0.3, at most 128 halo points a tile.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scene  # noqa: E402
from test_torch_scene_seg import hold_scene_against_jax  # noqa: E402

KW = dict(tile_points=512, halo=0.3, max_halo_points=128, th=64,
          microbatch=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_multistage_halo_scene_matches_jax():
    plan = hold_scene_against_jax(
        2048, 0, KW, [(0.25, 0.25, 8, (8, 8)), (0.25, 0.5, 8, (8, 16))],
        ((16,), (8,)))
    assert plan.halo_points > 0
    assert plan.max_tile_n <= scene.SceneConfig(**KW).max_tile_cloud()
