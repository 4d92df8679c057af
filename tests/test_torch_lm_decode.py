"""The port's LM serving path (``prefill`` + ``decode_step``) against the
JAX package's, on the ten reduced configs, within 1e-4.

For each config: prefill's last logits and every layer's cache (KV caches,
SSD and conv states, mLSTM and sLSTM states), then 4 teacher-forced decode
steps (JAX's greedy token is fed to both sides), their logits and the
caches after them (``run_serving`` and the weights' route,
``convert.lm_from_jax``, are those of ``test_torch_lm_model.py``, which
also runs gemma3's and zamba2's rolling caches through their wrap;
``test_torch_lm_kinds.py`` runs each block kind alone).
"""
import jax
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_model import (ARCHS, PROMPT, S, STEPS,  # noqa: E402
                                 run_serving)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(arch):
    run_serving(arch, PROMPT, STEPS, S)

