"""One ``make_lm_train_step`` step of the port against the JAX package's
(loss, metrics, every gradient leaf within 1e-4) on the reduced configs
of ``test_torch_lm_training.SPLIT_ARCHS``: the other half of that file's
``test_lm_train_step_matches_jax``, in a file of its own so the two share
the JAX gradient time between workers.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_training import SPLIT_ARCHS, check_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_lm_train_step_matches_jax(arch):
    """One ``make_lm_train_step`` step: the loss, every metric and every
    gradient leaf (carried back by ``transformer_params_to_jax``)."""
    check_train_step(arch)
