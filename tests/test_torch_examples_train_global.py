"""The port's PointNet++ trainer with ``--point-ops global`` against the
reference's step: the rules of tests/test_torch_examples_train.py."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_train import hold_train_client  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_client_matches_the_reference_step_global(tmp_path):
    hold_train_client("global", tmp_path)
