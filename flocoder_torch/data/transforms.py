"""Host-side augmentation (numpy + PIL), the port's own copy of
``flocoder_tpu/data/transforms.py``, with an explicit
``numpy.random.Generator``; outputs are float32 HWC:

- images: random rotate ±15° → center-crop 90% → RandomResizedCrop(0.8–1.0)
  → horizontal flip → [-1, 1];
- piano rolls (``midi_transforms``): a random roll (musical transposition
  and time shift) → a random crop to the image size → optional grayscale
  and binary gate, kept in [0, 1].

Both packages draw the same numbers from the same generator.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from PIL import Image

__all__ = ["image_transforms", "midi_transforms", "random_roll", "rgb_to_grayscale",
           "binary_gate", "to_array", "normalize"]


def to_array(img) -> np.ndarray:
    """PIL → float32 HWC in [0,1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def normalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5):
    return (arr - mean) / std


def random_roll(arr: np.ndarray, rng: np.random.Generator,
                max_h: Optional[int] = None, max_v: int = 12) -> np.ndarray:
    """Horizontal roll (time shift) then vertical roll (transposition) of an
    HWC array."""
    h_shift = int(rng.integers(0, max_h if max_h else arr.shape[1]))
    v_shift = int(rng.integers(-max_v, max_v + 1))
    return np.roll(np.roll(arr, h_shift, axis=1), v_shift, axis=0)


def rgb_to_grayscale(arr: np.ndarray) -> np.ndarray:
    """Equal-weight gray of an HWC array; one channel passes through."""
    if arr.shape[-1] == 1:
        return arr
    return arr.mean(axis=-1, keepdims=True)


def binary_gate(arr: np.ndarray, threshold: float = 0.1) -> np.ndarray:
    """1 where ``arr > threshold``, else 0, as float32."""
    return (arr > threshold).astype(np.float32)


def _random_resized_crop(img: Image.Image, size: int,
                         rng: np.random.Generator,
                         scale=(0.8, 1.0)) -> Image.Image:
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = rng.uniform(3 / 4, 4 / 3)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return img.crop((x, y, x + cw, y + ch)).resize(
                (size, size), Image.BILINEAR)
    return img.resize((size, size), Image.BILINEAR)


def image_transforms(image_size: int = 128) -> Callable:
    """Build the reference's image aug pipeline (data.py:97-111). Returns
    ``fn(pil_image, rng) -> float32 HWC in [-1, 1]``."""

    def fn(img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        if img.mode != "RGB":
            img = img.convert("RGB")
        angle = float(rng.uniform(-15, 15))
        img = img.rotate(angle, resample=Image.BILINEAR)
        w, h = img.size
        cw, ch = int(w * 0.9), int(h * 0.9)
        img = img.crop(((w - cw) // 2, (h - ch) // 2,
                        (w + cw) // 2, (h + ch) // 2))
        img = _random_resized_crop(img, image_size, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return normalize(to_array(img))

    return fn


def midi_transforms(image_size: int = 128, grayscale: bool = False,
                    binary: bool = False, max_transpose: int = 12) -> Callable:
    """The piano-roll pipeline: ``random_roll``, a random crop to
    ``image_size`` when both sides are larger, then optional grayscale and
    binary gate. Returns ``fn(pil_or_array, rng) -> float32 HWC`` in [0, 1]
    (not mean/std normalised)."""

    def fn(img, rng: np.random.Generator) -> np.ndarray:
        arr = to_array(img) if isinstance(img, Image.Image) else np.asarray(
            img, dtype=np.float32)
        arr = random_roll(arr, rng, max_v=max_transpose)
        h, w = arr.shape[:2]
        if h > image_size and w > image_size:
            y = int(rng.integers(0, h - image_size + 1))
            x = int(rng.integers(0, w - image_size + 1))
            arr = arr[y:y + image_size, x:x + image_size]
        if grayscale:
            arr = rgb_to_grayscale(arr)
        if binary:
            arr = binary_gate(arr)
        return arr

    return fn
