"""The port's mesh layouts against the reference's, with no processes.

For worlds of 1, 2, 4 and 8 ranks and model axes of 1, 2 and 4: the
(data, model) shape of ``launch.mesh.make_host_mesh`` against the
reference's (its device list and mesh constructor stubbed, so no forced
host devices are needed), the elastic shape against
``repro.dist.elastic``, every spec the PNN path names against
``repro.dist.logical.spec`` and ``fit_specs``, and where
``logical.placement`` splits a dim against the fitted spec's device
count: a dim splits exactly where the reference's sharding keeps it.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.mesh as jmesh  # noqa: E402
from repro.dist import elastic as jelastic  # noqa: E402
from repro.dist import logical as jlogical  # noqa: E402
from repro_torch.dist import elastic, logical  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

WORLDS = (1, 2, 4, 8)
MODEL_AXES = (1, 2, 4)
PNN_AXES = [("batch", "points", None), ("batch", "points"), ("batch",),
            ("blocks", None, None), ("blocks", None)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def laid_out(shape, names=("data", "model")):
    """A mesh of ``shape`` as rank 0 of a world sees it, its groups
    stand-ins (``placement`` reads their index only)."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    groups = {}
    for k in range(1, len(shape) + 1):
        for axes in itertools.combinations(range(len(shape)), k):
            if int(np.prod([shape[a] for a in axes])) > 1:
                groups[tuple(names[a] for a in axes)] = (None, 0)
    devices = np.empty(ranks.size, dtype=object)
    devices[:] = [torch.device("cpu")] * ranks.size
    return logical.Mesh(devices.reshape(shape), names, ranks=ranks,
                        world=object(), groups=groups)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("model_axis", MODEL_AXES)
def test_host_and_elastic_shapes_equal_the_reference(monkeypatch, n,
                                                     model_axis):
    seen = {}
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda shape, axes, **kw: seen.update(
                            shape=tuple(shape), axes=tuple(axes)))
    jmesh.make_host_mesh(model_axis)
    assert tmesh.host_mesh_shape(n, model_axis) == seen["shape"]
    assert seen["axes"] == ("data", "model")
    assert elastic.choose_mesh_shape(n, model_axis=model_axis) == \
        jelastic.choose_mesh_shape(n, model_axis=model_axis)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("model_axis", MODEL_AXES)
def test_specs_and_splits_equal_the_reference(monkeypatch, n, model_axis):
    # The reference's fit_specs builds a jax NamedSharding, which needs a
    # mesh of real devices: it gets a holder of (mesh, spec) instead.
    monkeypatch.setattr(jlogical, "NamedSharding", _JSharding)
    mesh = laid_out(tmesh.host_mesh_shape(n, model_axis))
    with logical.logical_rules(mesh, logical.RULES_V0), \
            jlogical.logical_rules(mesh, jlogical.RULES_V0):
        for axes in PNN_AXES:
            got, want = logical.spec(axes), jlogical.spec(axes)
            assert got == want and tuple(got) == tuple(want), axes
            for size in range(1, 13):
                shape = (size,) + (5,) * (len(axes) - 1)
                sh = logical.NamedSharding(mesh, got)
                fitted = logical.fit_specs(sh, shape, mesh).spec
                jfitted = jlogical.fit_specs(_JSharding(mesh, want),
                                             _Shape(shape), mesh).spec
                assert fitted == jfitted and tuple(fitted) == tuple(jfitted)
                ways = logical.entry_size(mesh, fitted[0])
                where = logical.placement(axes[0], size)
                assert (1 if where is None else where[1]) == ways, \
                    (axes, size)


class _JSharding:
    """What the reference's ``fit_specs`` reads of a sharding: its spec."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


class _Shape:
    def __init__(self, shape):
        self.shape = shape
