"""One GAN step of a bf16 DAC codec (the fp32 waveform discriminators'
step on the bf16 codec's fp32 reconstruction, then the generator's loss
through the just-updated discriminators) against the JAX package's; the
setup, the rules and the tolerances are ``test_torch_audio_bf16_step.py``'s.
"""
import pytest
import torch

from test_torch_audio_bf16_step import run_bf16_audio_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_gan_step_matches_jax():
    run_bf16_audio_step("gan")
