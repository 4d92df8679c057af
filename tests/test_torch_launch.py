"""The port's PNN cells (``repro_torch.launch``) against the JAX package's,
on the CPU.

The cell tables and the useful-FLOP count equal the reference's exactly
(``_model_flops`` for 3 variants x 3 shapes x {serve, train}); the
roofline row has the reference's keys and ``format_table`` prints the
same text for the same row.  A cell at a tiny shape runs on the CPU: its
serving step equals ``pnn.apply`` on the same clouds and its train step
one ``make_train_step`` step; for PointNeXt both are held within 1e-4
against the reference's ``pnn.apply`` and ``train_step_fn`` on converted
weights.  ``dryrun`` refuses archs and shapes it does not know.

The LM part: ``count_params`` and ``active_params`` of the ten full
configs, counted on the meta device (``lm.steps.eval_shape_init``, no
allocation), equal the reference's exactly (llama4's 11,512,550,400 with
the reference's count of its shared expert), and ``model_flops_for`` on
all 10 x 4 cells; ``dryrun.run_cell`` runs a train, prefill and decode
cell of a reduced config on the CPU and ``perf`` its variants, a refused
variant raising and ``perf.main`` exiting non-zero.
"""
import ast
import copy
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import pnn_cell as jcell  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.lm import steps as jsteps  # noqa: E402
from repro.models import pnn as jpnn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import pnn as jtrain  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, perf, pnn_cell  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.lm import steps as lm_steps  # noqa: E402
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
        for f in dataclasses.fields(pnn.PNNConfig):
            if f.name not in want:
                # the port's own fields (pointnext_invres) keep their
                # defaults in the reference's presets
                assert got.pop(f.name) == f.default, (name, f.name)
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
            "gather_blocks": 2, "interp_blend": 2}
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
    names = {"ball_query_blocks", "knn_blocks", "gather_blocks",
             "interp_blend"}
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


def test_dryrun_refuses_unknown_archs_and_shapes():
    """An arch or shape that no cell has is refused before anything runs
    (the LM cells themselves run since ``run_cell``)."""
    with pytest.raises(ValueError, match="smollm-135m"):
        dryrun.main(["--arch", "gpt-7", "--shape", "train_4k"])
    with pytest.raises(ValueError, match="train_4k"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "pnn_289k"])
    with pytest.raises(ValueError, match="pnn_33k"):
        dryrun.main(["--arch", "pointnext", "--shape", "pnn_2k"])


def test_cells_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn_cell.make_cell("pointnext", TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn_cell.run_pnn_cell("pointnext", TINY, verbose=False)


# ---------------------------------------------------------------------------
# The LM cells.
# ---------------------------------------------------------------------------

LM_ARCHS = sorted(jconfigs.ARCHS)


@functools.lru_cache(maxsize=None)
def lm_counts(arch):
    """(reference's (count, active), port's (count, active, device))."""
    jcfg = jconfigs.lm_config(arch)
    shapes, _ = jsteps.eval_shape_init(jcfg)
    cfg = configs.lm_config(arch)
    meta, _ = lm_steps.eval_shape_init(cfg)
    return ((jrl.count_params(shapes), jrl.active_params(jcfg, shapes)),
            (rl.count_params(meta), rl.active_params(cfg, meta),
             {p.device.type for p in meta.parameters()}))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_equal_the_reference_without_allocation(arch):
    (jn, ja), (n, a, devices) = lm_counts(arch)
    assert devices == {"meta"}
    assert n == jn and a == ja and type(a) is type(ja)
    if arch == "llama4-scout-17b-16e":
        # the reference counts the shared expert at top_k / num_experts
        assert (n, a) == (107_771_827_200, 11_512_550_400)


@pytest.mark.parametrize("shape", sorted(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_model_flops_equal_the_reference(arch, shape):
    (_, ja), (_, a, _) = lm_counts(arch)
    s = jconfigs.SHAPES[shape]
    want = jrl.model_flops_for(jconfigs.lm_config(arch), s.kind, s.seq_len,
                               s.global_batch, ja)
    got = rl.model_flops_for(configs.lm_config(arch), s.kind, s.seq_len,
                             s.global_batch, a)
    assert got == want and got > 0


def _reference_table(path, name):
    """The literal dict ``name`` of a reference launcher, read from its
    source (importing it would set XLA_FLAGS for 512 host devices)."""
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == name:
            return node.value
    raise KeyError(name)


def test_lm_tables_match_the_reference():
    root = str(Path(__file__).resolve().parents[1] / "src/repro/launch") + "/"
    assert dryrun.MICROBATCH == ast.literal_eval(
        _reference_table(root + "dryrun.py", "MICROBATCH"))
    for name, port in (("VARIANTS", perf.VARIANTS),
                       ("PNN_VARIANTS_PERF", perf.PNN_VARIANTS_PERF)):
        keys = {k.value for k in _reference_table(root + "perf.py",
                                                  name).keys}
        assert keys == set(port) | (keys & set(perf.REFUSED)), name
        assert not set(port) & set(perf.REFUSED)
    assert perf.PNN_VARIANTS_PERF["chunk2k"] == {"leaf_chunk": 2048}
    assert perf.PNN_VARIANTS_PERF["global_ops"] == {"point_ops": "global",
                                                    "batch": 16}


def _whole(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture
def reduced_cells(monkeypatch):
    """``lm_config`` gives the reduced configs and the LM shapes are tiny,
    so the launchers run on the CPU."""
    monkeypatch.setattr(configs, "lm_config", configs.lm_reduced)
    tiny = {"train_4k": ShapeSpec("train_4k", 16, 4, "train"),
            "prefill_32k": ShapeSpec("prefill_32k", 32, 2, "prefill"),
            "decode_32k": ShapeSpec("decode_32k", 32, 2, "decode"),
            "long_500k": ShapeSpec("long_500k", 64, 1, "decode")}
    for k, v in tiny.items():
        monkeypatch.setitem(dryrun.SHAPES, k, v)
    return tiny


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("zamba2-7b", "train_4k"),
    ("seamless-m4t-medium", "prefill_32k"), ("granite-moe-3b-a800m",
                                             "decode_32k"),
    ("zamba2-7b", "long_500k")])
def test_run_lm_cell_row_on_the_cpu(reduced_cells, arch, shape):
    s = reduced_cells[shape]
    d = dryrun.run_cell(arch, shape, device="cpu", reps=2, verbose=False)
    assert set(jrl.Roofline(**roofline_fields()).to_dict()) <= set(d)
    cfg = configs.lm_reduced(arch)
    meta, _ = lm_steps.eval_shape_init(cfg)
    assert d["n_params"] == d["run_params"] == rl.count_params(meta)
    assert d["n_active"] == d["run_active"] == rl.active_params(cfg, meta)
    assert d["model_flops"] == rl.model_flops_for(
        cfg, s.kind, s.seq_len, s.global_batch, d["n_active"])
    assert (d["kind"], d["batch"], d["ref_batch"]) == (
        s.kind, s.global_batch, s.global_batch)
    assert d["reduced"] == [] and d["reps"] == d["ref_reps"] == cfg.reps
    # zamba2 accumulates over MICROBATCH's 4 slices of its batch of 4
    assert d["microbatch"] == (4 if (arch, shape) == ("zamba2-7b",
                                                      "train_4k") else 1)
    assert d["device"] == "cpu" and d["probe"] is None
    assert len(d["steps_s"]) == 2 and d["step_s"] > 0
    assert np.isnan(d["mem_per_device"]["peak_mb"])     # not measured
    assert d["hlo_flops_per_chip"] > 0 and d["hlo_bytes_per_chip"] > 0
    assert d["peak_flops"] == rl.PEAK_FLOPS_FP32    # reduced: float32
    assert arch in rl.format_table([d])


def test_dryrun_lm_cells_and_skips(reduced_cells, tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                        "--device", "cpu", "--out", str(out)]) == 0
    assert "[skip] smollm-135m x long_500k" in capsys.readouterr().out
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--device", "cpu", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [(r["arch"], r["shape"]) for r in rows] == [("smollm-135m",
                                                        "decode_32k")]


def test_fit_reps_cuts_the_depth_of_full_configs():
    """Where the weights and optimizer state of every repetition pass the
    card's share, the depth is cut; widths stay (meta device only)."""
    for arch, kind, want in (("smollm-135m", "train", 30),
                             ("chameleon-34b", "decode", None),
                             ("llama4-scout-17b-16e", "prefill", None)):
        cfg = configs.lm_config(arch)
        meta, _ = lm_steps.eval_shape_init(cfg)
        r = dryrun.fit_reps(cfg, meta, kind)
        if want is not None:
            assert r == want
        else:
            assert 1 <= r < cfg.reps
            cut = dataclasses.replace(cfg, n_layers=r * len(cfg.pattern))
            small, _ = lm_steps.eval_shape_init(cut)
            assert 4 * (rl.count_params(small)) <= (
                dryrun.WEIGHT_SHARE * pnn_cell.MEM_LIMIT)
    cfg = configs.lm_config("llama4-scout-17b-16e")
    meta, _ = lm_steps.eval_shape_init(cfg)
    with pytest.raises(dryrun.DoesNotFit, match="optimizer state"):
        dryrun.fit_reps(cfg, meta, "train", microbatch=4)
    # without the accumulator (a fitted batch's depth is priced at batch 1)
    # one repetition's four copies fit, and the probes decide
    assert dryrun.fit_reps(cfg, meta, "train") == cfg.reps


@pytest.mark.parametrize("oom_from", [None, 12])
def test_probe_reps_checks_its_guess(monkeypatch, oom_from):
    """The peaks at 1 and 2 repetitions guess the depth linearly; the
    guess is probed and stepped down until its peak fits, also where
    the peak grows faster past the probes or the step runs out of
    memory (fake peaks: 30 + 3 r GiB, 8 GiB more past 8 repetitions)."""
    gib = 2**30
    seen = []

    def fake(arch, shape, cfg, device):
        r = cfg.reps
        seen.append(r)
        if oom_from is not None and r >= oom_from:
            raise torch.OutOfMemoryError("fake")
        return (30 + 3 * r + (8 if r > 8 else 0)) * gib

    monkeypatch.setattr(dryrun, "_step_peak", fake)
    assert dryrun.MEM_LIMIT == 70 * gib
    cfg = configs.lm_config("smollm-135m")
    meta, _ = lm_steps.eval_shape_init(cfg)
    shape = dryrun.SHAPES["train_4k"]
    r, probe = dryrun.probe_reps("smollm-135m", shape, cfg, meta, cfg.reps)
    assert r == 10 and probe["estimate_gib"] == 68
    assert seen == ([1, 2, 13, 10] if oom_from is None
                    else [1, 2, 13, 12, 11, 10])
    # one repetition that does not fit is refused; two that do not, 1
    monkeypatch.setattr(dryrun, "_step_peak",
                        lambda a, s, c, d: (70 + c.reps) * gib)
    with pytest.raises(dryrun.DoesNotFit, match="one repetition's step"):
        dryrun.probe_reps("smollm-135m", shape, cfg, meta, cfg.reps)
    monkeypatch.setattr(dryrun, "_step_peak",
                        lambda a, s, c, d: (60 + 9 * c.reps) * gib)
    assert dryrun.probe_reps("smollm-135m", shape, cfg, meta,
                             cfg.reps)[0] == 1


def test_dryrun_all_records_the_cells_that_do_not_fit(monkeypatch, tmp_path):
    """``--all`` records a cell whose one repetition cannot fit as skipped,
    with its reason, and goes on; any other failure ends the run, after
    the rows before it are written."""
    def fake(arch, shape, **kw):
        if arch == "llama4-scout-17b-16e" and shape == "train_4k":
            raise dryrun.DoesNotFit("one repetition passes the card")
        if fail and arch == "xlstm-1.3b" and shape == "long_500k":
            raise RuntimeError("cell failed")
        return {"arch": arch, "shape": shape, "skipped": "stub"}

    monkeypatch.setattr(dryrun, "run_cell", fake)
    monkeypatch.setattr(dryrun, "run_pnn_cell", fake)
    out = tmp_path / "rows.json"
    fail = False
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) == len(configs.ARCHS) * 4 + len(pnn_cell.PNN_VARIANTS)
    assert [r["skipped"] for r in rows
            if r["arch"] == "llama4-scout-17b-16e"
            and r["shape"] == "train_4k"] == ["one repetition passes the "
                                              "card"]
    fail = True
    with pytest.raises(RuntimeError, match="cell failed"):
        dryrun.main(["--all", "--out", str(out)])
    rows = json.loads(out.read_text())["rows"]
    assert (rows[-1]["arch"], rows[-1]["shape"]) == ("xlstm-1.3b",
                                                     "decode_32k")
    with pytest.raises(dryrun.DoesNotFit):
        dryrun.main(["--arch", "llama4-scout-17b-16e", "--shape",
                     "train_4k"])


def test_perf_variants_on_the_cpu(reduced_cells, monkeypatch, capsys):
    row = perf.run_variant("smollm-135m", "train_4k", "flash4k",
                           device="cpu")
    assert row["variant"] == "flash4k" and np.isfinite(row["step_s"])
    monkeypatch.setitem(pnn_cell.PNN_SHAPES, "tiny", TINY)
    row = perf.run_variant("pointnext", "tiny", "chunk2k", device="cpu")
    assert row["variant"] == "chunk2k" and row["batch"] == TINY.batch
    for name in perf.REFUSED:
        with pytest.raises(ValueError, match="no counterpart on one card"):
            perf.run_variant("smollm-135m", "train_4k", name, device="cpu")
    assert perf.main(["--cell", "smollm-135m:prefill_32k", "--variants",
                      "baseline,flash4k", "--device", "cpu"]) == 0
    assert perf.main(["--cell", "smollm-135m:prefill_32k", "--variants",
                      "baseline,dp_only", "--device", "cpu"]) == 1
    assert "dp_only: ERROR" in capsys.readouterr().out


def test_lm_launchers_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("smollm-135m", "train_4k", verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k"])
    assert perf.main(["--cell", "smollm-135m:train_4k"]) == 1
