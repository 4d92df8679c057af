"""Each of the block kinds ``moe``, ``mamba``, ``mlstm``, ``slstm`` and
``shared_attn`` on its own, the port against the JAX package within 1e-4:
a pattern of the kind alone, two reps deep (``shared_attn`` beside an
``attn`` block: the reference's layer scan needs one position that is not
shared), prefill logits and every cache, then one decode step, by
``run_serving`` of ``test_torch_lm_model.py``.
"""
import jax
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_model import PROMPT, S, run_serving  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# kind: (the reduced config it comes from, a pattern of the kind alone)
KINDS = {"moe": ("granite-moe-3b-a800m", ("moe",)),
         "mamba": ("zamba2-7b", ("mamba",)),
         "mlstm": ("xlstm-1.3b", ("mlstm",)),
         "slstm": ("xlstm-1.3b", ("slstm",)),
         "shared_attn": ("zamba2-7b", ("attn", "shared_attn"))}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_each_kind_matches_the_reference(kind):
    """Two reps of the kind's pattern: prefill logits and caches, and one
    decode step."""
    arch, pattern = KINDS[kind]
    run_serving(arch, PROMPT, 1, S, pattern=pattern,
                n_layers=2 * len(pattern))
