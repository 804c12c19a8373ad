"""WAV I/O and audio datasets, the port's own copy of
``flocoder_tpu/data/audio_io.py`` (numpy and the stdlib ``wave`` module
only).

- ``load_wav``: 8-bit unsigned and 16/24/32-bit signed PCM, mixed down to
  mono, as float32 in [-1, 1]; ``save_wav``: 16-bit mono PCM.
- ``AudioFolderDataset``: ``.wav`` files under a tree (class label = the
  first-level subdirectory), fixed-length random crops, zero-padded when a
  file is shorter, linear resampling by ``np.interp`` to the sample rate.
- ``SyntheticAudioDataset``: a chord of three sines a class with random
  phases and a little noise, seeded by ``seed + i``.

Items are ``(waveform (T, 1) float32, label int32)``, the NHWC-like layout
the ``Loader`` stacks, byte for byte the JAX package's for the same seed
and the same ``np.random.Generator``.
"""
from __future__ import annotations

import os
import wave
from typing import Callable, Optional

import numpy as np

from .datasets import fast_scandir

__all__ = ["load_wav", "save_wav", "AudioFolderDataset", "SyntheticAudioDataset"]


def load_wav(path: str) -> tuple:
    """A PCM WAV file → (waveform float32 (T,) in [-1, 1], sample rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 1:          # 8-bit unsigned
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:        # 24-bit packed
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def save_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform (T,) or (T, 1) in [-1, 1] as 16-bit PCM."""
    x = np.asarray(x, np.float32).reshape(-1)
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())


class AudioFolderDataset:
    """``.wav`` files under a directory tree, served as fixed-length random
    crops (zero-padded when a file is shorter); class label = first-level
    subdirectory when there are subdirectories, else 0. A file that fails
    to load is replaced by another draw."""

    def __init__(self, path: str, crop_len: int, sample_rate: int = 16000,
                 cache: bool = True, transform: Optional[Callable] = None):
        self.path = os.path.expanduser(path)
        _, self.files = fast_scandir(self.path, [".wav"])
        if not self.files:
            raise FileNotFoundError(f"no .wav files under {self.path}")
        tops = sorted({self._top(f) for f in self.files})
        self.class_names = tops
        self.class_map = {c: i for i, c in enumerate(tops)}
        self.crop_len = int(crop_len)
        self.sample_rate = int(sample_rate)
        self.transform = transform
        self._cache: Optional[dict] = {} if cache else None

    def _top(self, f: str) -> str:
        parts = os.path.relpath(f, self.path).split(os.sep)
        return parts[0] if len(parts) > 1 else ""

    @property
    def n_classes(self) -> int:
        return len(self.class_names) if self.class_names != [""] else 0

    def __len__(self):
        return len(self.files)

    def _load(self, f: str) -> np.ndarray:
        if self._cache is not None and f in self._cache:
            return self._cache[f]
        x, sr = load_wav(f)
        if sr != self.sample_rate:          # linear resampling
            n_out = int(round(len(x) * self.sample_rate / sr))
            x = np.interp(np.linspace(0.0, len(x) - 1.0, n_out),
                          np.arange(len(x)), x).astype(np.float32)
        if self._cache is not None:
            self._cache[f] = x
        return x

    def get(self, i: int, rng: np.random.Generator):
        f = self.files[i]
        try:
            x = self._load(f)
        except Exception as e:
            print(f"AudioFolderDataset: failed to load {f} ({e}); redrawing")
            j = int(rng.integers(0, len(self.files)))
            return self.get(j if j != i else (i + 1) % len(self.files), rng)
        if len(x) >= self.crop_len:
            start = int(rng.integers(0, len(x) - self.crop_len + 1))
            crop = x[start:start + self.crop_len]
        else:
            crop = np.zeros(self.crop_len, np.float32)
            crop[:len(x)] = x
        if self.transform is not None:
            crop = self.transform(crop, rng)
        return crop.astype(np.float32)[:, None], np.int32(self.class_map[self._top(f)])

    def __getitem__(self, i: int):
        return self.get(i, np.random.default_rng())


class SyntheticAudioDataset:
    """Procedural chords: class k has the fundamental 110·2ᵏ Hz with its
    fifth and octave, random phases and 1% noise, from the generator seeded
    ``seed + i`` (the loader's generator is not used)."""

    def __init__(self, n: int = 256, crop_len: int = 8192, sample_rate: int = 16000,
                 n_classes: int = 4, seed: int = 0):
        self.n = n
        self.crop_len = int(crop_len)
        self.sample_rate = int(sample_rate)
        self._n_classes = n_classes
        self.seed = seed

    @property
    def n_classes(self) -> int:
        return self._n_classes

    def __len__(self):
        return self.n

    def get(self, i: int, rng: np.random.Generator):
        g = np.random.default_rng(self.seed + i)
        label = i % self._n_classes
        t = np.arange(self.crop_len) / self.sample_rate
        base = 110.0 * (2.0 ** label)
        x = np.zeros(self.crop_len, np.float32)
        for harm, amp in ((1.0, 0.5), (1.5, 0.25), (2.0, 0.15)):
            x += amp * np.sin(2 * np.pi * base * harm * t + g.uniform(0, 2 * np.pi))
        x += 0.01 * g.standard_normal(self.crop_len)
        return x.astype(np.float32)[:, None], np.int32(label)
