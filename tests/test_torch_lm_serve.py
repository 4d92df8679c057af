"""LM serving on the port (``repro_torch.lm.model``, ``launch.serve``):
what holds on the port alone, the bfloat16 cast order against the JAX
package, and the edges of the API.

* prefill + one decode step equals the full forward's last logits for the
  ten reduced configs (the reference's bar, tests/test_lm_archs.py), and a
  4-token greedy decode equals recomputing the forward (smollm, and the
  recurrent zamba2 and xlstm: chunked == recurrent);
* zamba2's shared attention is one set of weights: the model counts it
  once, and changing it changes every rep's output;
* bfloat16 (smollm reduced, ``dtype="bfloat16"``): bit for bit against
  the reference run op by op (``scan_layers=False, remat=False``), and
  within 2 bfloat16 ulps of the logits' scale (hidden states within 1/16)
  against the reference under ``lax.scan`` + remat, whose XLA fusion
  rounds differently;
* decoding past the cache raises (the reference clamps the write);
* ``init`` needs the card unless asked for the CPU; the converter refuses
  a missing, extra or misshapen leaf (a shared one too); ``ARCHS`` is the
  reference's ten, each config verbatim; the reference's stack-layout
  knobs are refused;
* ``python -m repro_torch.launch.serve --device cpu`` prints the ids of a
  greedy loop over the port's own prefill / decode (smollm, zamba2), and
  the logits under the one-card mesh's rules equal those without.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.lm import model as jmodel  # noqa: E402
from repro.lm import xlstm as jxlstm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.dist import elastic, logical  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.lm import model as M  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

BF16_LOGITS_TOL = 2 ** -7   # 2 bfloat16 ulps at the logits' scale (~0.5)
BF16_HIDDEN_TOL = 2 ** -4   # 4 bfloat16 ulps at the hidden scale (2..4)
UNCARRIED = ("scan_layers", "remat", "unroll_inner")  # not LMConfig's
XLSTM_UNCARRIED = ("unroll",)                         # not XLSTMConfig's
MOE_UNCARRIED = ("dispatch",)                         # not MoEOpts'


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_for(arch, seed=0, **kw):
    cfg = configs.lm_reduced(arch, **kw)
    model, _ = M.init(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")
    return cfg, model


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_prefill_decode_matches_full_forward(arch):
    cfg, model = model_for(arch)
    b, s = 2, 16
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    with torch.no_grad():
        if cfg.encoder_layers:
            frames = torch.from_numpy(
                (rng.standard_normal((b, s, cfg.d_model)) * 0.1)
                .astype(np.float32))
            h, _ = M.forward(model, cfg, frames=frames, dec_tokens=toks)
            _, cache = M.prefill(model, cfg, frames=frames,
                                 dec_tokens=toks[:, :s - 1], max_len=s)
        else:
            h, _ = M.forward(model, cfg, tokens=toks)
            _, cache = M.prefill(model, cfg, tokens=toks[:, :s - 1],
                                 max_len=s)
        full = M.logits_for(model, cfg, h[:, -1:, :])
    dec, _ = M.decode_step(model, cfg, toks[:, s - 1:s], cache, s - 1)
    np.testing.assert_allclose(dec[:, 0, :cfg.vocab].numpy(),
                               full[:, 0, :cfg.vocab].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b", "xlstm-1.3b"])
def test_multi_step_decode(arch):
    """Greedy decode of 4 tokens through the cache == recomputing the full
    forward, each token consumed once (a recurrent state, unlike a KV
    cache, would take a token fed twice)."""
    cfg, model = model_for(arch)
    s0, n_new = 8, 4
    cur = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, s0)))
    last, cache = M.prefill(model, cfg, tokens=cur, max_len=s0 + n_new)
    for _ in range(n_new):
        with torch.no_grad():
            h, _ = M.forward(model, cfg, tokens=cur)
            nxt_full = torch.argmax(M.logits_for(model, cfg, h[:, -1:]), -1)
        nxt = torch.argmax(last, -1)
        assert torch.equal(nxt, nxt_full)
        last, cache = M.decode_step(model, cfg, nxt, cache, cur.shape[1])
        cur = torch.cat([cur, nxt], dim=1)


def bf16_run(jcfg):
    """Forward hidden, prefill logits and 4 teacher-forced decode logits,
    JAX (``jcfg``) against the port (smollm reduced, bfloat16)."""
    cfg = configs.lm_reduced("smollm-135m", dtype="bfloat16")
    params, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    jh, _ = jmodel.forward(params, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        h, _ = M.forward(model, cfg, tokens=torch.from_numpy(toks))
    assert h.dtype == torch.bfloat16
    pairs = [("hidden", h, jh)]
    jl, jc = jmodel.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :12]),
                            max_len=16)
    tl, tc = M.prefill(model, cfg, tokens=torch.from_numpy(toks[:, :12]),
                       max_len=16)
    pairs.append(("prefill", tl, jl))
    for i in range(4):
        nxt = jnp.argmax(jl, -1)
        assert torch.equal(torch.argmax(tl, -1),
                           torch.from_numpy(np.array(nxt)))
        jl, jc = jmodel.decode_step(params, jcfg, nxt, jc, jnp.int32(12 + i))
        tl, tc = M.decode_step(model, cfg, torch.from_numpy(np.array(nxt)),
                               tc, 12 + i)
        pairs.append((f"decode {i}", tl, jl))
    return [(name, got.float().numpy(), np.asarray(want, np.float32))
            for name, got, want in pairs]


def test_bf16_equals_the_reference_op_by_op():
    jcfg = jconfigs.lm_reduced("smollm-135m", dtype="bfloat16",
                               scan_layers=False, remat=False)
    for name, got, want in bf16_run(jcfg):
        assert np.array_equal(got, want), name


def test_bf16_within_ulps_of_the_scanned_reference():
    jcfg = jconfigs.lm_reduced("smollm-135m", dtype="bfloat16")
    for name, got, want in bf16_run(jcfg):
        tol = BF16_HIDDEN_TOL if name == "hidden" else BF16_LOGITS_TOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)


def test_decode_past_max_len_raises():
    """The reference's ``dynamic_update_slice`` clamps a write past the
    cache onto its last slot; the port refuses it (ROADMAP.md §C)."""
    cfg, model = model_for("smollm-135m")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    last, cache = M.prefill(model, cfg, tokens=toks, max_len=5)
    nxt = torch.argmax(last, -1)
    last, cache = M.decode_step(model, cfg, nxt, cache, 4)
    with pytest.raises(ValueError, match="past a cache of 5 slots"):
        M.decode_step(model, cfg, nxt, cache, 5)


def test_init_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init(configs.lm_reduced("smollm-135m"))


def test_shared_block_is_one_set_of_weights(monkeypatch):
    """zamba2 (reduced: 2 reps of mamba, mamba, shared_attn): the shared
    block is one module in every rep, its parameters count once (as many
    as the reference's tree holds), and a change to one of them changes
    the block's output in every rep."""
    cfg, model = model_for("zamba2-7b")
    shared = model.shared["b2_shared_attn"]
    n = len(cfg.pattern)
    assert all(model.blocks[r * n + 2] is shared for r in range(cfg.reps))
    count = sum(p.numel() for p in model.parameters())
    once = sum(p.numel() for p in shared.parameters())
    assert count == sum(p.numel() for b in model.blocks
                        for p in b.parameters()) - (cfg.reps - 1) * once \
        + model.emb.w.numel() + model.lnf.g.numel()
    jparams, _ = jmodel.init(jax.random.PRNGKey(0),
                             jconfigs.lm_reduced("zamba2-7b"))
    assert count == sum(a.size for a in jax.tree.leaves(jparams))

    runs = [[]]
    real = M._block_fwd

    def spy(p, cfg_, kind, x, enc_out=None):
        out = real(p, cfg_, kind, x, enc_out)
        if p is shared:
            runs[-1].append(out[0])
        return out

    monkeypatch.setattr(M, "_block_fwd", spy)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 8)))
    with torch.no_grad():
        M.forward(model, cfg, tokens=toks)
        runs.append([])
        shared.attn.wo.w.add_(0.5)
        M.forward(model, cfg, tokens=toks)
    before, after = runs
    assert len(before) == len(after) == cfg.reps
    assert all(not torch.equal(a, b) for a, b in zip(before, after))


def test_converter_checks_every_leaf():
    jcfg = jconfigs.lm_reduced("minitron-4b")
    cfg = configs.lm_reduced("minitron-4b")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jcfg)[0])
    convert.lm_from_jax(params, cfg)
    missing = dict(params, scan=dict(params["scan"]))
    missing["scan"]["b0_attn"] = {
        k: v for k, v in params["scan"]["b0_attn"].items() if k != "ln2"}
    with pytest.raises(ValueError, match="scan/b0_attn/ln2/g"):
        convert.lm_from_jax(missing, cfg)
    extra = dict(params, bogus={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="bogus/w"):
        convert.lm_from_jax(extra, cfg)
    untied = dict(params)
    del untied["head"]
    with pytest.raises(ValueError, match="head/w"):
        convert.lm_from_jax(untied, cfg)
    shaped = dict(params, lnf={"g": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="lnf/g: shape"):
        convert.lm_from_jax(shaped, cfg)
    one_rep = dict(params, scan={"b0_attn": jax.tree.map(
        lambda a: a[:1], params["scan"]["b0_attn"])})
    with pytest.raises(ValueError, match="shape"):
        convert.lm_from_jax(one_rep, cfg)
    # zamba2's shared block: one unstacked subtree under "shared".
    zcfg = configs.lm_reduced("zamba2-7b")
    zp = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jconfigs.lm_reduced("zamba2-7b"))[0])
    model = convert.lm_from_jax(zp, zcfg)
    np.testing.assert_array_equal(
        model.shared["b2_shared_attn"].attn.wq.w.detach().numpy(),
        zp["shared"]["b2_shared_attn"]["attn"]["wq"]["w"])
    stacked = dict(zp, shared={"b2_shared_attn": jax.tree.map(
        lambda a: np.stack([a, a]), zp["shared"]["b2_shared_attn"])})
    with pytest.raises(ValueError, match="shared/b2_shared_attn/.*shape"):
        convert.lm_from_jax(stacked, zcfg)
    with pytest.raises(ValueError, match="shared/b2_shared_attn/ln2/g"):
        convert.lm_from_jax(dict(zp, shared={"b2_shared_attn": {
            k: v for k, v in zp["shared"]["b2_shared_attn"].items()
            if k != "ln2"}}), zcfg)


def test_archs_are_the_reference_verbatim():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.PNN_ARCHS == jconfigs.PNN_ARCHS
    assert configs.SHAPES == {k: configs.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCHS:
        for make in ("config", "reduced"):
            got = dataclasses.asdict(getattr(configs.get(arch), make)())
            want = dataclasses.asdict(getattr(jconfigs.get(arch), make)())
            # the stack-layout knobs the port does not have stay at the
            # reference's defaults in every ported config
            assert {k: want.pop(k) for k in UNCARRIED} == \
                {k: getattr(jmodel.LMConfig, k) for k in UNCARRIED}
            if want["xlstm"] is not None:
                assert {k: want["xlstm"].pop(k) for k in XLSTM_UNCARRIED} \
                    == {k: getattr(jxlstm.XLSTMConfig, k)
                        for k in XLSTM_UNCARRIED}
            if want["moe"] is not None:
                assert {k: want["moe"].pop(k) for k in MOE_UNCARRIED} \
                    == {k: getattr(jmodel.MoEOpts, k)
                        for k in MOE_UNCARRIED}
            assert got == want, (arch, make)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-5")


@pytest.mark.parametrize("knob", UNCARRIED)
def test_config_refuses_the_reference_stack_knobs(knob):
    """``scan_layers``, ``remat`` and ``unroll_inner`` only lay out the
    reference's XLA stack; a config that sets one is refused, not
    silently served without it."""
    with pytest.raises(TypeError, match=knob):
        configs.lm_reduced("smollm-135m", **{knob: False})


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_serve_cli_prints_the_greedy_ids(capsys, arch):
    assert serve.main(["--arch", arch, "--batch", "2",
                       "--prompt-len", "16", "--max-new", "8",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ids = eval(re.search(r"generated ids: (\[.*\])", out).group(1))
    cfg, model = model_for(arch, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    last, cache = M.prefill(model, cfg, tokens=toks, max_len=24)
    want = []
    for i in range(8):
        nxt = torch.argmax(last, -1)
        want.append(nxt)
        last, cache = M.decode_step(model, cfg, nxt, cache, 16 + i)
    assert ids == torch.cat(want, 1).tolist()
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])


def test_logits_under_the_one_card_mesh_equal_those_without():
    cfg, model = model_for("gemma2-2b")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)))
    mesh = elastic.make_mesh(devices=["cpu"])
    seen = []
    gen, got_last, _, _, _ = serve.generate(model, cfg, toks, 6, mesh,
                                            on_step=seen.append)
    assert len(seen) == 7 and seen[-1] is got_last
    last, cache = M.prefill(model, cfg, tokens=toks, max_len=18)
    for i in range(6):
        nxt = torch.argmax(last, -1)
        assert torch.equal(nxt, gen[:, i:i + 1])
        assert torch.equal(seen[i], last)
        last, cache = M.decode_step(model, cfg, nxt, cache, 12 + i)
    assert torch.equal(got_last, last)
    with logical.logical_rules(mesh, logical.RULES_V0):
        got, _ = M.prefill(model, cfg, tokens=toks, max_len=18)
    want, _ = M.prefill(model, cfg, tokens=toks, max_len=18)
    assert torch.equal(got, want)
