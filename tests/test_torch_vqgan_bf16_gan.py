"""One GAN step in bf16 (codec, discriminator and VGG16 computing in bf16)
against the JAX package's; the setup, the rules and the tolerances are
``test_torch_vqgan_bf16.py``'s.
"""
import pytest
import torch

from test_torch_vqgan_bf16 import run_bf16_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_gan_step_matches_jax():
    run_bf16_step("gan")
