"""The GAN step of microbatched codec training (``grad_accum=2``) against
the JAX package's simultaneous update; the check is
``test_torch_vqgan_accum.py``'s, in a file of its own so that the test
runner's per-file workers take it beside the warmup's.
"""
import pytest
import torch

from test_torch_vqgan_accum import check_grad_accum_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gan_grad_accum_step_matches_jax():
    check_grad_accum_step("gan")
