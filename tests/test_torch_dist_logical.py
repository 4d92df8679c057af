"""The port's logical sharding rules and elastic meshes
(``repro_torch.dist.{logical,elastic}``) against the JAX package's.

The reference's own cases run on the port's objects: ``TestLogicalConstraint``
(tests/test_dist_units.py), ``TestLogicalRules`` (tests/test_sharding.py) and
``TestElastic`` (tests/test_train_infra.py).  ``lc`` inside a context is the
identity on the one-card mesh (the reference's
``test_lc_inside_context_constrains`` fails on its own side; the port is
held to what it means).  ``spec`` and ``axis_size`` equal the reference's
over seeded axis tuples under stand-in meshes of shapes (1, 1), (4, 2) and
(2, 16, 16), which the rules read only through ``axis_names`` and
``devices.shape``; ``param_specs`` / ``fit_specs`` equal the reference's
leaf for leaf on the one-device mesh over each reduced LM config's axes
tree; ``choose_mesh_shape`` equals it for 1..1024 devices.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.dist import elastic as jelastic  # noqa: E402
from repro.dist import logical as jlogical  # noqa: E402
from repro.lm import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import elastic, logical  # noqa: E402
from repro_torch.dist.logical import P  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_card_mesh():
    return elastic.make_mesh(model_axis=2, devices=["cpu"])


def stand_in(shape):
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    return SimpleNamespace(axis_names=names,
                           devices=np.empty(shape, dtype=object))


# --------------------------------------------- tests/test_dist_units.py cases

class TestLogicalConstraint:
    def test_lc_outside_context_is_identity(self):
        x = torch.ones((4, 6))
        assert logical.lc(x, "batch", "ff") is x

    def test_lc_inside_context_constrains(self):
        mesh = one_card_mesh()
        x = torch.arange(24.0).reshape(4, 6)
        with logical.logical_rules(mesh, logical.RULES_V0):
            assert logical.lc(x, "batch", "ff") is x
            y = logical.lc(x, "batch", "ff") * 1.0
        assert torch.equal(y, x)

    def test_lc_rank_mismatch_raises(self):
        with logical.logical_rules(one_card_mesh(), logical.RULES_V0):
            with pytest.raises(ValueError, match="rank"):
                logical.lc(torch.ones((2, 2)), "batch")

    def test_priority_resolves_mesh_axis_conflicts(self):
        with logical.logical_rules(one_card_mesh(), logical.RULES_V0):
            assert logical.spec(("batch", "seq_shard", "heads", None)) == \
                P(("data",), "model", None, None)
            assert logical.spec(("batch", "heads", None, "seq_shard")) == \
                P(("data",), None, None, "model")

    def test_axis_size_and_rules_with(self):
        mesh = one_card_mesh()
        assert logical.axis_size("batch") == 1  # no context
        rules = logical.rules_with(points="model", ff=None)
        with logical.logical_rules(mesh, rules):
            assert logical.spec(("points",)) == P("model")
            assert logical.spec(("ff",)) == P(None)
            assert logical.axis_size("batch") == 1  # (1,1) mesh

    def test_nested_contexts_restore(self):
        mesh = one_card_mesh()
        with logical.logical_rules(mesh, logical.RULES_V0):
            with logical.logical_rules(mesh, logical.rules_with(ff=None)):
                assert logical.spec(("ff",)) == P(None)
            assert logical.spec(("ff",)) == P("model")
        assert logical.current() is None


# ---------------------------------------------- tests/test_sharding.py cases

class TestLogicalRules:
    def test_spec_mapping(self):
        with logical.logical_rules(one_card_mesh(), logical.RULES_V0):
            assert logical.spec(("batch", None, "ff")) == \
                P(("data",), None, "model")
            assert logical.spec((None, None)) == P(None, None)
        assert logical.spec(("batch",)) == P()

    def test_missing_mesh_axis_dropped(self):
        with logical.logical_rules(one_card_mesh(), logical.RULES_V0):
            assert logical.spec(("batch",)) == P(("data",),)

    def test_param_specs_tree(self):
        axes = {"w": ("embed_fsdp", "ff"), "g": None,
                "nested": {"e": ("experts", None, "ff")}}
        specs = logical.param_specs(axes, one_card_mesh())
        assert specs["w"].spec == P("data", "model")
        assert specs["g"].spec == P()
        assert specs["nested"]["e"].spec == P("data", None, "model")

    def test_lc_noop_without_context(self):
        x = torch.ones((4, 4))
        assert logical.lc(x, "batch", "ff") is x


# ------------------------------------------- tests/test_train_infra.py cases

class TestElastic:
    def test_mesh_shapes(self):
        assert elastic.choose_mesh_shape(512)[0] == (2, 16, 16)
        assert elastic.choose_mesh_shape(256)[0] == (16, 16)
        shape, names = elastic.choose_mesh_shape(248)  # lost a host
        assert int(np.prod(shape)) == 248
        shape, names = elastic.choose_mesh_shape(4, model_axis=2)
        assert int(np.prod(shape)) == 4

    def test_degradation_sequence(self):
        seq = elastic.degraded_meshes(256, 3)
        sizes = [int(np.prod(s)) for s, _ in seq]
        assert sizes == [256, 248, 240, 232]


# ------------------------------------------------- the port's own contract

def test_partition_spec_compares_as_jax_does():
    for entries in [(("data",), None), ("data", None), ((), "model"),
                    (("pod", "data"), None, "model"), ()]:
        assert P(*entries) == JP(*entries)
        assert JP(*entries) == P(*entries)
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P() != P(None)
    assert P("data") != P("data", None)


def test_lc_refuses_a_mesh_of_several_devices():
    mesh = logical.Mesh(np.array([[torch.device("cpu")] * 2]),
                        ("data", "model"))
    with logical.logical_rules(mesh, logical.RULES_V0):
        assert logical.spec(("ff",)) == P("model")
        with pytest.raises(ValueError, match="stand-in mesh of 2 devices"):
            logical.lc(torch.ones(4), "ff")


RULE_VARIANTS = {
    "v0": {},
    "ff_none": dict(ff=None),
    "points_model": dict(points="model"),
    "batch_all": dict(batch=("pod", "data", "model")),
    "heads_2d": dict(heads=("data", "model"), seq_shard=None),
    "embed_data": dict(embed="data", layers="pod"),
}


@pytest.mark.parametrize("variant", sorted(RULE_VARIANTS))
@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (2, 16, 16)])
def test_spec_and_axis_size_equal_the_reference(shape, variant):
    names = list(logical.RULES_V0) + [None, "unknown_axis"]
    rng = np.random.default_rng(len(shape) * 100 + sum(shape))
    tuples = [tuple(names[i] for i in rng.integers(0, len(names), n))
              for n in rng.integers(1, 6, 200)]
    mesh = stand_in(shape)
    rules = logical.rules_with(**RULE_VARIANTS[variant])
    jrules = jlogical.rules_with(**RULE_VARIANTS[variant])
    assert rules == jrules
    with logical.logical_rules(mesh, rules), \
            jlogical.logical_rules(mesh, jrules):
        for axes in tuples:
            got, want = logical.spec(axes), jlogical.spec(axes)
            assert got == want and tuple(got) == tuple(want), axes
        for name in names:
            assert logical.axis_size(name) == jlogical.axis_size(name), name
    for entry in [None, "data", "model", ("data", "model")]:
        assert logical.entry_size(mesh, entry) == \
            jlogical.entry_size(mesh, entry)


def test_fit_specs_drops_entries_that_do_not_divide():
    mesh = stand_in((4, 2))
    specs = {"a": logical.NamedSharding(mesh, P("data", "model")),
             "b": [logical.NamedSharding(mesh, P(("data", "model"), None))]}
    fitted = logical.fit_specs(specs, {"a": torch.ones(6, 8),
                                       "b": [(16, 3)]}, mesh)
    assert fitted["a"].spec == P(None, "model")
    assert fitted["b"][0].spec == P(("data", "model"), None)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def param_shapes(cfg, model) -> dict:
    """The reference's parameter tree with shapes for leaves (a stacked
    leaf with its leading reps axis), built from the port's model."""
    tree: dict = {"shared": {}}
    for path, ps in M.reference_leaves(cfg, model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        shape = tuple(ps[0].shape)
        node[path[-1]] = ((len(ps),) + shape
                          if path[0] in ("scan", "enc_scan") else shape)
    return tree


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_and_fit_specs_equal_the_reference(arch):
    """Over the reduced config's axes tree, on the one-device mesh."""
    jcfg, cfg = jconfigs.lm_reduced(arch), configs.lm_reduced(arch)
    box = {}

    def init():
        params, box["axes"] = jmodel.init(jax.random.PRNGKey(0), jcfg)
        return params

    jshapes = jax.eval_shape(init)
    jaxes = box["axes"]
    model, axes = M.init(cfg, device="cpu")
    assert axes == jaxes
    shapes = param_shapes(cfg, model)
    assert shapes == jax.tree.map(lambda s: tuple(s.shape), jshapes)

    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    mesh = one_card_mesh()
    for rules in (None, logical.rules_with(ff=None, vocab="data")):
        want = jlogical.fit_specs(jlogical.param_specs(jaxes, jmesh, rules),
                                  jshapes, jmesh)
        got = logical.fit_specs(logical.param_specs(axes, mesh, rules),
                                shapes, mesh)
        want_leaves = dict(_leaves(want))
        got_leaves = dict(_leaves(got))
        assert set(got_leaves) == set(want_leaves)
        for path, sh in got_leaves.items():
            assert sh.spec == want_leaves[path].spec, path
            assert tuple(sh.spec) == tuple(want_leaves[path].spec), path


def test_cache_axes_equal_the_reference():
    for arch in configs.ARCHS:
        assert M.cache_axes(configs.lm_reduced(arch)) == \
            jmodel.cache_axes(jconfigs.lm_reduced(arch)), arch


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_choose_mesh_shape_equals_the_reference(m):
    for n in range(1, 1025):
        assert elastic.choose_mesh_shape(n, model_axis=m) == \
            jelastic.choose_mesh_shape(n, model_axis=m), n
    with pytest.raises(ValueError):
        elastic.choose_mesh_shape(0, model_axis=m)


def test_degraded_meshes_equal_the_reference():
    for n, losses in [(256, 3), (512, 4), (1024, 2), (64, 7), (24, 2)]:
        assert elastic.degraded_meshes(n, losses) == \
            jelastic.degraded_meshes(n, losses)


def test_make_mesh_over_the_given_devices():
    mesh = one_card_mesh()
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (1, 1)
    assert mesh.devices[0, 0] == torch.device("cpu")
    assert mesh.shape == {"data": 1, "model": 1}


def test_make_mesh_needs_the_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic.make_mesh()
