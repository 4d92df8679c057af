"""The port's PNN cells (``repro_torch.launch``) against the JAX package's,
on the CPU.

The cell tables and the useful-FLOP count equal the reference's exactly
(``_model_flops`` for 3 variants x 3 shapes x {serve, train}); the
roofline row has the reference's keys and ``format_table`` prints the
same text for the same row.  A cell at a tiny shape runs on the CPU: its
serving step equals ``pnn.apply`` on the same clouds and its train step
one ``make_train_step`` step; for PointNeXt both are held within 1e-4
against the reference's ``pnn.apply`` and ``train_step_fn`` on converted
weights.  ``dryrun`` refuses the LM archs.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import pnn_cell as jcell  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import pnn as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import dryrun, pnn_cell  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models import pnn  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TINY = pnn_cell.PNNShape("tiny", 512, 2, 32)
REF_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("shape", sorted(jcell.PNN_SHAPES))
@pytest.mark.parametrize("variant", sorted(jcell.PNN_VARIANTS))
def test_model_flops_equal_the_reference(variant, shape, kind):
    s = jcell.PNN_SHAPES[shape]
    jcfg = jcell.PNN_VARIANTS[variant](n=s.n_points, point_ops="bppo",
                                       th=s.th)
    want = jcell._model_flops(jcfg, s.n_points, s.batch, None)
    if kind == "train":
        want *= 3.0      # as the reference's run_pnn_cell scales it
    cfg = pnn_cell.PNN_VARIANTS[variant](n=s.n_points, point_ops="bppo",
                                         th=s.th)
    got = pnn_cell._model_flops(cfg, s.n_points, s.batch, kind=kind)
    assert got == want and got > 0


def test_cell_tables_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in pnn_cell.PNN_SHAPES.items()
            } == {k: dataclasses.asdict(v)
                  for k, v in jcell.PNN_SHAPES.items()}
    assert sorted(pnn_cell.PNN_VARIANTS) == sorted(jcell.PNN_VARIANTS)
    for name, preset in pnn_cell.PNN_VARIANTS.items():
        want = dataclasses.asdict(jcell.PNN_VARIANTS[name](
            n=33_000, point_ops="bppo", th=256))
        got = dataclasses.asdict(preset(n=33_000, point_ops="bppo", th=256))
        want.pop("impl")
        assert got == want, name


def roofline_fields():
    return dict(arch="pointnext", shape="pnn_289k", mesh="1xcuda", chips=1,
                hlo_flops=6.2e11, hlo_bytes=1.05e12, coll_bytes=0.0,
                coll_by_kind={}, coll_count={}, model_flops=3.7e11,
                mem_per_device={"argument_mb": 60.0, "output_mb": 500.0,
                                "temp_mb": 16000.0, "peak_mb": 16560.0})


def test_roofline_row_has_the_reference_keys():
    want = jrl.Roofline(**roofline_fields()).to_dict()
    got = rl.Roofline(**roofline_fields(), step_s=0.77).to_dict()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"step_s", "bound_fraction"}
    for k in ("arch", "shape", "mesh", "chips", "hlo_flops_per_chip",
              "hlo_bytes_per_chip", "coll_bytes_per_chip", "model_flops",
              "mem_per_device", "t_collective_s"):
        assert got[k] == want[k], k
    assert got["t_memory_s"] == pytest.approx(1.05e12 / 3.35e12)
    assert got["bottleneck"] == "memory"
    assert got["bound_fraction"] == pytest.approx(got["t_memory_s"] / 0.77)
    assert got["usefulness"] == pytest.approx(want["usefulness"])


def test_format_table_prints_the_reference_text():
    rows = [jrl.Roofline(**roofline_fields()).to_dict(),
            dict(jrl.Roofline(**roofline_fields()).to_dict(), arch="pointvector",
                 shape="pnn_33k_train")]
    assert rl.format_table(rows) == jrl.format_table(rows)
    row = rl.Roofline(**roofline_fields(), step_s=1.0)
    assert rl.format_table([row]) == rl.format_table([row.to_dict()])


def test_byte_counter_counts_inputs_and_outputs_once():
    x, w = torch.ones(8, 4), torch.ones(4, 2)
    with rl.ByteCounter() as bc:
        y = x @ w               # reads 32 + 8 floats, writes 16
        y.view(16)              # a view moves nothing
        torch.empty(1000)       # nor does an empty allocation
    assert bc.bytes == (32 + 8 + 16) * 4


def jax_params(cfg):
    return jpnn.init(jax.random.PRNGKey(1), cfg)


@pytest.mark.parametrize("variant", ["pointnet2", "pointnext", "pointvector"])
def test_serve_cell_equals_pnn_apply(variant):
    cell = pnn_cell.make_cell(variant, TINY, device="cpu")
    assert cell.batch["points"].shape == (2, 512, 3)
    got = cell.step()
    want = pnn.apply(cell.model, cell.cfg, cell.batch["points"])
    assert torch.equal(got, want)
    assert cell.cfg.leaf_chunk == 512 and cell.cfg.point_ops == "bppo"


@pytest.mark.parametrize("variant", ["pointnet2", "pointnext", "pointvector"])
def test_train_cell_is_one_trainer_step(variant):
    cell = pnn_cell.make_cell(variant, TINY, kind="train", device="cpu")
    model = copy.deepcopy(cell.model)
    metrics = cell.step()
    params = train.param_dict(model)
    step = train.make_train_step(model, cell.cfg, opt_lib.OptConfig(warmup=0))
    _, _, want = step(params, opt_lib.init(params), cell.batch)
    assert float(metrics["loss"]) == float(want["loss"])
    for k, p in train.param_dict(cell.model).items():
        assert torch.equal(p, params[k]), k


def flat_jax(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_pointnext_cells_match_the_reference():
    """Serving logits and one fine-tune step of a PointNeXt cell against
    the reference's ``pnn.apply`` and ``train_step_fn`` on converted
    weights and the same clouds."""
    jcfg = jcell.PNN_VARIANTS["pointnext"](n=TINY.n_points, point_ops="bppo",
                                           th=TINY.th, impl="xla")
    jparams = jax_params(jcfg)
    model = convert.from_jax(jax.tree.map(np.asarray, jparams),
                             pnn_cell.PNN_VARIANTS["pointnext"](
                                 n=TINY.n_points, point_ops="bppo",
                                 th=TINY.th))
    serve = pnn_cell.make_cell("pointnext", TINY, device="cpu",
                               params=copy.deepcopy(model))
    pts = serve.batch["points"].numpy()
    fwd = jax.jit(lambda c: jpnn.apply(jparams, jcfg, c))
    want = np.stack([np.asarray(fwd(c)) for c in pts])
    np.testing.assert_allclose(serve.step().numpy(), want, rtol=REF_TOL,
                               atol=REF_TOL)

    cell = pnn_cell.make_cell("pointnext", TINY, kind="train", device="cpu",
                              params=model)
    metrics = cell.step()
    jbatch = {"points": jnp.asarray(pts),
              "labels": jnp.asarray(cell.batch["labels"].numpy()
                                    .astype(np.int32))}
    jstep = jax.jit(jtrain.train_step_fn(jcfg, jopt.OptConfig(warmup=0)))
    jp, _, jm = jstep(jparams, jopt.init(jparams), jbatch)
    assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]),
                                                   rel=REF_TOL)
    want = flat_jax(jp)
    got = train.param_dict(cell.model)
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=REF_TOL,
                                   atol=REF_TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_run_pnn_cell_row_on_the_cpu(kind):
    d = pnn_cell.run_pnn_cell("pointnext", TINY, kind=kind, device="cpu",
                              reps=2, verbose=False)
    assert set(jrl.Roofline(**roofline_fields()).to_dict()) <= set(d)
    assert d["kind"] == kind and d["batch"] == d["ref_batch"] == 2
    assert d["shape"] == ("tiny_train" if kind == "train" else "tiny")
    assert d["device"] == "cpu" and d["probe"] is None
    assert len(d["steps_s"]) == 2 and d["step_s"] > 0
    assert np.isnan(d["mem_per_device"]["peak_mb"])     # not measured
    assert d["hlo_flops_per_chip"] > 0 and d["hlo_bytes_per_chip"] > 0
    assert d["model_flops"] == pnn_cell._model_flops(
        pnn_cell.PNN_VARIANTS["pointnext"](n=512, point_ops="bppo", th=32),
        512, 2, kind=kind)
    want = {"fps_blocks": 2, "ball_query_blocks": 2, "knn_blocks": 2,
            "gather_blocks": 2}
    if kind == "train":
        want["scatter_add_blocks"] = 2
    assert d["kernel_calls"] == want
    assert {k: len(h["blocks"]) for k, h in d["held"].items()} == want
    assert all(h["max_abs_err"] == 0.0 for h in d["held"].values())
    assert not any(d["launches"].values())          # nothing on the CPU
    assert "pointnext" in rl.format_table([d])


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_run_pnn_cell_holds_every_leaf_chunk(kind):
    """With ``leaf_chunk`` below the leaf count, each point op runs chunk
    by chunk (``leaf_chunk`` leaves of each cloud, so batch x 3 blocks a
    call), the last chunk shorter, and the cell holds every chunk's call;
    the chunked serving step equals the unchunked one."""
    d = pnn_cell.run_pnn_cell("pointnext", TINY, kind=kind, device="cpu",
                              leaf_chunk=3, reps=1, verbose=False)
    names = {"ball_query_blocks", "knn_blocks", "gather_blocks"}
    if kind == "train":
        names.add("scatter_add_blocks")
    for name in names:
        blocks = d["held"][name]["blocks"]
        assert d["kernel_calls"][name] == len(blocks) > 2, name
        assert max(blocks) == TINY.batch * 3 > min(blocks), (name, blocks)
    if kind == "serve":
        whole = pnn_cell.make_cell("pointnext", TINY, device="cpu",
                                   leaf_chunk=None)
        chunked = pnn_cell.make_cell("pointnext", TINY, device="cpu",
                                     leaf_chunk=3, params=whole.model)
        torch.testing.assert_close(chunked.step(), whole.step(), rtol=0,
                                   atol=0)


def test_dryrun_refuses_lm_archs():
    with pytest.raises(ValueError, match="A6"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k"])
    with pytest.raises(ValueError, match="pnn_33k"):
        dryrun.main(["--arch", "pointnext", "--shape", "pnn_2k"])


def test_cells_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn_cell.make_cell("pointnext", TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn_cell.run_pnn_cell("pointnext", TINY, verbose=False)
