"""The port's audio signal ops (flocoder_torch.ops.audio) against the JAX
package's on the same numpy waveforms: the magnitude STFT, the mel
filterbank (equal), and the multi-scale STFT and mel losses at odd and
even lengths.

Tolerance (fp32, the tests' ``highest`` matmul precision): 1e-5·max(1,
|ref|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.ops import audio as jaudio
from flocoder_torch.ops import audio as taudio


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, what=""):
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor) else ours, np.float64)
    assert ours.shape == ref.shape, what
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _waves(seed, b, t):
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 16000.0
    chord = 0.4 * np.sin(2 * np.pi * 220.0 * tt) + 0.2 * np.sin(2 * np.pi * 330.0 * tt)
    return (chord + 0.1 * rng.standard_normal((b, t))).astype(np.float32)


@pytest.mark.parametrize("n_fft,t,hop", [(64, 300, None), (64, 301, None), (256, 1001, None),
                                         (512, 2048, 100), (128, 129, None)])
def test_stft_matches_jax(n_fft, t, hop):
    x = _waves(0, 2, t)
    ref = jaudio.stft(jnp.asarray(x), n_fft, hop)
    _close(taudio.stft(torch.from_numpy(x), n_fft, hop), ref, f"stft {n_fft} {t}")
    # (B, T, 1) is read as (B, T)
    _close(taudio.stft(torch.from_numpy(x[..., None]), n_fft, hop), ref)


def test_stft_refuses_other_shapes():
    with pytest.raises(ValueError, match="stft expects"):
        taudio.stft(torch.zeros(2, 64, 2), 16)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 512, 40, 0.0, None), (16000, 1024, 80, 0.0, None), (16000, 2048, 160, 0.0, None),
    (22050, 256, 64, 30.0, 8000.0), (16000, 64, 32, 0.0, None)])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, fmin, fmax):
    ours = taudio.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    ref = jaudio.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("t", [2048, 2049])
def test_multiscale_losses_match_jax(t):
    x, y = _waves(1, 2, t), _waves(2, 2, t)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for sizes in ((2048, 512), (512, 1024)):
        _close(taudio.multiscale_stft_loss(tx, ty, sizes),
               jaudio.multiscale_stft_loss(jnp.asarray(x), jnp.asarray(y), sizes), f"stft {sizes}")
    # the default scales, and n_mels capped at n_fft // 2 at a small n_fft
    for sizes, mels in (((512, 1024, 2048), (40, 80, 160)), ((64, 128), (40, 80))):
        _close(taudio.multiscale_mel_loss(tx, ty, 16000, sizes, mels),
               jaudio.multiscale_mel_loss(jnp.asarray(x), jnp.asarray(y), 16000, sizes, mels),
               f"mel {sizes}")


def test_losses_carry_gradients():
    x = torch.from_numpy(_waves(3, 2, 1024))
    y = torch.from_numpy(_waves(4, 2, 1024)).requires_grad_()
    (taudio.multiscale_stft_loss(x, y, (256, 128))
     + taudio.multiscale_mel_loss(x, y, 16000, (256,), (40,))).backward()
    assert y.grad is not None and torch.isfinite(y.grad).all() and y.grad.abs().max() > 0
