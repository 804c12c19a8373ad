"""Audio signal ops, PyTorch port of ``flocoder_tpu/ops/audio.py``: the
magnitude STFT, the HTK mel filterbank and the DAC recipe's multi-scale
spectral losses.

- ``stft``: centre reflect pad of ``n_fft // 2``, frames by ``unfold``
  (the JAX package's static gather index), a periodic Hann window and
  ``|rfft|`` in fp32. The transform is ``torch.fft.rfft``, as the JAX
  package's is ``jnp.fft.rfft`` outside any Pallas kernel.
- ``mel_filterbank``: the triangular HTK-mel filterbank built once on the
  host in numpy (this module's own copy, lru-cached), (n_fft//2 + 1, n_mels)
  float32.
- ``multiscale_stft_loss``: the mean over FFT sizes of spectral convergence
  (the Frobenius norm over every element, as ``jnp.linalg.norm`` of a 3-D
  array) plus the log-magnitude L1.
- ``multiscale_mel_loss``: the mean over (n_fft, n_mels) pairs of the
  log-mel L1, with ``n_mels`` capped at ``n_fft // 2``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["stft", "mel_filterbank", "multiscale_stft_loss", "multiscale_mel_loss"]


def _hann(win: int) -> np.ndarray:
    """Periodic Hann window (torch.stft's and librosa's default)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)


def stft(x: torch.Tensor, n_fft: int, hop: int | None = None) -> torch.Tensor:
    """Magnitude STFT of (B, T) or (B, T, 1) → (B, frames, n_fft//2 + 1), fp32."""
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.ndim != 2:
        raise ValueError(f"stft expects (B, T), got {tuple(x.shape)}")
    hop = hop or n_fft // 4
    pad = n_fft // 2
    x = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.as_tensor(_hann(n_fft), dtype=torch.float32, device=x.device)
    frames = x.unfold(1, n_fft, hop) * window
    return torch.fft.rfft(frames, dim=-1).abs()


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_fft//2 + 1, n_mels) triangular HTK-mel filterbank, float32."""
    fmax = fmax or sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lower, center, upper = (hz_pts[:-2][None, :], hz_pts[1:-1][None, :],
                            hz_pts[2:][None, :])
    f = fft_freqs[:, None]
    up = (f - lower) / np.maximum(center - lower, 1e-10)
    down = (upper - f) / np.maximum(upper - center, 1e-10)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def multiscale_stft_loss(x: torch.Tensor, y: torch.Tensor,
                         fft_sizes=(2048, 512)) -> torch.Tensor:
    """Mean over FFT sizes of spectral convergence + log-magnitude L1
    between waveforms (B, T)."""
    total = 0.0
    for n_fft in fft_sizes:
        sx, sy = stft(x, n_fft), stft(y, n_fft)
        sc = (torch.linalg.vector_norm(sx - sy)
              / torch.linalg.vector_norm(sx).clamp(min=1e-6))
        logmag = (torch.log(sx + 1e-5) - torch.log(sy + 1e-5)).abs().mean()
        total = total + sc + logmag
    return total / len(fft_sizes)


def multiscale_mel_loss(x: torch.Tensor, y: torch.Tensor, sample_rate: int,
                        fft_sizes=(512, 1024, 2048), n_mels=(40, 80, 160)) -> torch.Tensor:
    """Mean over (n_fft, n_mels) pairs of |log-mel(x) − log-mel(y)|."""
    total = 0.0
    for n_fft, nm in zip(fft_sizes, n_mels):
        nm = min(nm, n_fft // 2)        # keep filters non-degenerate at tiny n_fft
        fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, nm), device=x.device)
        mx = torch.log(stft(x, n_fft) @ fb + 1e-5)
        my = torch.log(stft(y, n_fft) @ fb + 1e-5)
        total = total + (mx - my).abs().mean()
    return total / len(fft_sizes)
