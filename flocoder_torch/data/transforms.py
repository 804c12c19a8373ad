"""Host-side image augmentation (numpy + PIL), the port's own copy of the
image part of ``flocoder_tpu/data/transforms.py``: random rotate ±15° →
center-crop 90% → RandomResizedCrop(0.8–1.0) → horizontal flip → [-1, 1],
with an explicit ``numpy.random.Generator``. Outputs are float32 HWC. The
MIDI transforms wait for the MIDI slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
from PIL import Image

__all__ = ["image_transforms", "to_array", "normalize"]


def to_array(img) -> np.ndarray:
    """PIL → float32 HWC in [0,1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def normalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5):
    return (arr - mean) / std


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
