"""The port's xLSTM blocks (``repro_torch.lm.xlstm``) against the JAX
package's, in float32 within 1e-4, at xlstm's reduced shapes (d_model 64,
4 heads, mLSTM up-projection 2, chunk 8).

For each of mLSTM and sLSTM: the forward over 20 steps (mLSTM: three
chunks, the last padded by 4) with its returned state (mLSTM ``C``, ``n``,
``m``; sLSTM ``c``, ``n``, ``h``, ``m``), then 4 decode steps from that
state; the same in bfloat16 activations under float32 weights, each output
and state in the reference's dtype; and on the port alone, decode after
the forward gives the last outputs of one longer forward.  The port's
``XLSTMConfig`` has no ``unroll`` (it only lays out the reference's XLA
scan) and refuses it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import xlstm as jx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.lm import xlstm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4
BF16_TOL = 2 ** -5     # outputs of O(1): a few bfloat16 roundings
D, B, S, STEPS = 64, 2, 20, 4
CFG = dict(n_heads=4, proj_factor=2.0, chunk=8)
KINDS = ("mlstm", "slstm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fns(mod, kind):
    return (getattr(mod, f"{kind}_init"), getattr(mod, f"{kind}_forward"),
            getattr(mod, f"{kind}_decode"))


def hold(got, want, tol):
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_state_and_decode(kind, dtype):
    jcfg, cfg = jx.XLSTMConfig(**CFG), xlstm.XLSTMConfig(**CFG)
    jinit, jfwd, jdec = fns(jx, kind)
    init, fwd, dec = fns(xlstm, kind)
    params, _ = jinit(jax.random.PRNGKey(0), D, jcfg)
    module, _ = init(torch.Generator(), D, cfg)
    convert._load(module, jax.tree.map(np.asarray, params), "p", set())
    tol = TOL if dtype == "float32" else BF16_TOL
    x = np.random.default_rng(1).standard_normal(
        (B, S + STEPS, D)).astype(np.float32)
    jxs = jnp.asarray(x).astype(dtype)
    txs = torch.from_numpy(x).to(getattr(torch, dtype))

    jy, jst = jfwd(params, jxs[:, :S], d=D, cfg=jcfg, return_state=True)
    y, st = fwd(module, txs[:, :S], d=D, cfg=cfg, return_state=True)
    hold(y, jy, tol)
    assert set(st) == set(jst)
    for key in st:
        hold(st[key], jst[key], tol)
    for i in range(STEPS):
        jy, jst = jdec(params, jxs[:, S + i:S + i + 1], jst, d=D, cfg=jcfg)
        y, st = dec(module, txs[:, S + i:S + i + 1], st, d=D, cfg=cfg)
        hold(y, jy, tol)
        for key in st:
            hold(st[key], jst[key], tol)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_continues_the_forward(kind):
    cfg = xlstm.XLSTMConfig(**CFG)
    init, fwd, dec = fns(xlstm, kind)
    module, _ = init(torch.Generator().manual_seed(3), D, cfg)
    x = torch.randn((B, S + STEPS, D),
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        full = fwd(module, x, d=D, cfg=cfg)
        _, st = fwd(module, x[:, :S], d=D, cfg=cfg, return_state=True)
        for i in range(STEPS):
            y, st = dec(module, x[:, S + i:S + i + 1], st, d=D, cfg=cfg)
            torch.testing.assert_close(y[:, 0], full[:, S + i], rtol=TOL,
                                       atol=TOL)
    fresh = getattr(xlstm, f"{kind}_state")(B, D, cfg)
    assert {k: (v.shape, v.dtype) for k, v in fresh.items()} == \
        {k: (v.shape, v.dtype) for k, v in st.items()}
    assert set(getattr(xlstm, f"{kind}_state_axes")()) == set(fresh)


def test_config_refuses_unroll():
    with pytest.raises(TypeError, match="unroll"):
        xlstm.XLSTMConfig(unroll=True)
