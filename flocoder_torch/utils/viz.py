"""Image-grid visualization, the port's own copy of
``flocoder_tpu/utils/viz.py``: host-side PIL/numpy. Arrays are NHWC (or NHW
for grayscale). ``save_img_grid`` logs each grid's path as ``demo/<tag>``
with ``epoch`` and ``nfe`` to the metrics log (``utils/logging.py``)."""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .logging import log as metrics_log

__all__ = ["make_grid", "save_img", "save_img_grid"]


def make_grid(images: np.ndarray, ncols: int = 10, pad: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile (N, H, W, C) images into a grid."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.full((nrows * (h + pad) + pad, ncols * (w + pad) + pad, c),
                   pad_value, dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[idx]
    return grid


def _to_uint8_img(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    mn, mx = x.min(), x.max()
    if mx > mn:
        x = (x - mn) / (mx - mn)
    return (x * 255).clip(0, 255).astype(np.uint8)


def save_img(img: np.ndarray, path: str) -> None:
    """Min-max normalize and save one image."""
    arr = _to_uint8_img(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def save_img_grid(images, epoch: int, nfe: int = 0, tag: str = "",
                  use_wandb: bool = True, output_dir: str = "./",
                  ncols: int = 10) -> str:
    """Save a 10-column grid PNG as ``{output_dir}/{tag}_epoch{epoch}.png``
    and, with ``use_wandb``, log its path (``demo/{tag}``, ``epoch``,
    ``nfe``). Latent tensors with >4 channels are shown via their first 3
    channels."""
    arr = np.asarray(images, dtype=np.float32)
    if arr.ndim == 4 and arr.shape[-1] not in (1, 3):
        arr = arr[..., :3]
    grid = make_grid(arr, ncols=ncols)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{tag}_epoch{epoch}.png")
    save_img(grid, path)
    if use_wandb:
        metrics_log({f"demo/{tag}": path, "epoch": epoch, "nfe": nfe})
    return path
