"""The port's Mamba2 block (``repro_torch.lm.ssm``) against the JAX
package's, in float32 within 1e-4, at zamba2's reduced shapes (d_model
64, d_state 16, head dim 16, chunk 16).

``mamba2_forward`` over 40 steps (three chunks, the last padded by 8) with
its returned state (SSD state and conv tail), then ``mamba2_decode`` for
4 steps from that state; and the same in bfloat16 activations under
float32 weights, where the conv's output is float32 on both sides (JAX's
promotion), each output and state in the reference's dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lm import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.lm import ssm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4
BF16_TOL = 2 ** -5     # outputs of O(1): a few bfloat16 roundings
D, B, S, STEPS = 64, 2, 40, 4
CFG = dict(d_state=16, expand=2, headdim=16, chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def hold(got, want, tol):
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_state_and_decode(dtype):
    jcfg, cfg = jssm.SSMConfig(**CFG), ssm.SSMConfig(**CFG)
    params, _ = jssm.mamba2_init(jax.random.PRNGKey(0), D, jcfg)
    module, _ = ssm.mamba2_init(torch.Generator(), D, cfg)
    convert._load(module, jax.tree.map(np.asarray, params), "p", set())
    tol = TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S + STEPS, D)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    jy, jst = jssm.mamba2_forward(params, jx[:, :S], d=D, cfg=jcfg,
                                  return_state=True)
    y, st = ssm.mamba2_forward(module, tx[:, :S], d=D, cfg=cfg,
                               return_state=True)
    hold(y, jy, tol)
    assert set(st) == set(jst) == {"ssd", "conv"}
    for key in st:
        hold(st[key], jst[key], tol)
    assert y.shape == (B, S, D) and not (S % cfg.chunk == 0)
    for i in range(STEPS):
        jy, jst = jssm.mamba2_decode(params, jx[:, S + i:S + i + 1], jst,
                                     d=D, cfg=jcfg)
        y, st = ssm.mamba2_decode(module, tx[:, S + i:S + i + 1], st, d=D,
                                  cfg=cfg)
        hold(y, jy, tol)
        for key in st:
            hold(st[key], jst[key], tol)


def test_decode_continues_the_forward():
    """The state after 40 steps, decoded 4 more, gives the last outputs of
    one 44-step forward (chunked == recurrent), on the port alone."""
    cfg = ssm.SSMConfig(**CFG)
    module, _ = ssm.mamba2_init(torch.Generator().manual_seed(3), D, cfg)
    x = torch.randn((B, S + STEPS, D), generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        full = ssm.mamba2_forward(module, x, d=D, cfg=cfg)
        _, st = ssm.mamba2_forward(module, x[:, :S], d=D, cfg=cfg,
                                   return_state=True)
        for i in range(STEPS):
            y, st = ssm.mamba2_decode(module, x[:, S + i:S + i + 1], st,
                                      d=D, cfg=cfg)
            torch.testing.assert_close(y[:, 0], full[:, S + i], rtol=TOL,
                                       atol=TOL)
    fresh = ssm.init_state(B, D, cfg)
    assert {k: (v.shape, v.dtype) for k, v in fresh.items()} == \
        {k: (v.shape, v.dtype) for k, v in st.items()}
    assert set(ssm.state_axes()) == set(fresh)
