"""The port's WAV I/O and audio datasets (flocoder_torch.data.audio_io)
against the JAX package's: the WAV bytes ``save_wav`` writes are equal,
``load_wav`` reads every PCM width (8/16/24/32-bit, mono and stereo) to
equal arrays, and the synthetic and folder datasets give byte-equal items
for the same seed and the same ``np.random.Generator`` (crops, zero
padding, resampling, class labels)."""
import os
import wave

import numpy as np
import pytest

from flocoder_tpu.data import audio_io as jio
from flocoder_torch.data import audio_io as tio


def _pcm(path, width, channels, rate, n, seed):
    """A WAV file of random PCM samples at ``width`` bytes a sample."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=n * channels * width, dtype=np.uint8).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)
    return str(path)


def test_save_wav_writes_the_jax_bytes(tmp_path):
    x = np.random.default_rng(0).uniform(-1.3, 1.3, size=(1001, 1)).astype(np.float32)
    tio.save_wav(str(tmp_path / "t.wav"), x, 16000)
    jio.save_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    back, sr = tio.load_wav(str(tmp_path / "t.wav"))
    assert sr == 16000 and back.shape == (1001,)
    np.testing.assert_allclose(back, np.clip(x[:, 0], -1, 1), atol=1 / 16384)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_load_wav_matches_jax(tmp_path, width, channels):
    path = _pcm(tmp_path / "a.wav", width, channels, 22050, 257, seed=width + 10 * channels)
    ours, sr = tio.load_wav(path)
    ref, jsr = jio.load_wav(path)
    assert sr == jsr == 22050 and ours.dtype == ref.dtype == np.float32
    assert ours.shape == (257,) and np.array_equal(ours, ref)
    assert np.abs(ours).max() <= 1.0


def test_synthetic_items_equal_jax():
    kw = dict(n=12, crop_len=3001, sample_rate=16000, n_classes=3, seed=5)
    ours, ref = tio.SyntheticAudioDataset(**kw), jio.SyntheticAudioDataset(**kw)
    assert len(ours) == len(ref) == 12 and ours.n_classes == ref.n_classes == 3
    for i in range(12):
        (x, y), (jx, jy) = ours.get(i, None), ref.get(i, None)
        assert x.shape == (3001, 1) and x.dtype == jx.dtype and x.tobytes() == jx.tobytes()
        assert y.dtype == jy.dtype == np.int32 and int(y) == int(jy) == i % 3


def test_folder_items_equal_jax(tmp_path):
    """Class subfolders, a file shorter than the crop (zero-padded), one at
    another sample rate (resampled) and a stereo one; every item equal for
    the same generator."""
    root = tmp_path / "wavs"
    for cls in ("bass", "voice"):
        os.makedirs(root / cls)
    _pcm(root / "bass" / "a.wav", 2, 1, 16000, 5000, 1)
    _pcm(root / "bass" / "short.wav", 2, 1, 16000, 700, 2)
    _pcm(root / "voice" / "b.wav", 3, 2, 16000, 4000, 3)
    _pcm(root / "voice" / "c.wav", 2, 1, 22050, 4000, 4)
    ours = tio.AudioFolderDataset(str(root), crop_len=2048, sample_rate=16000)
    ref = jio.AudioFolderDataset(str(root), crop_len=2048, sample_rate=16000)
    assert len(ours) == len(ref) == 4
    assert ours.class_names == ref.class_names == ["bass", "voice"] and ours.n_classes == 2
    for rep in range(2):                    # the second pass reads the cache
        for i in range(4):
            x, y = ours.get(i, np.random.default_rng(100 + i))
            jx, jy = ref.get(i, np.random.default_rng(100 + i))
            assert x.shape == (2048, 1) and x.tobytes() == jx.tobytes(), (rep, i)
            assert int(y) == int(jy)
    short = ours.get(ours.files.index(str(root / "bass" / "short.wav")),
                     np.random.default_rng(0))[0]
    assert not short[700:].any() and short[:700].any()


def test_folder_without_wavs_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .wav files"):
        tio.AudioFolderDataset(str(tmp_path), crop_len=16)
