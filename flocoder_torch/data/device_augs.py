"""Image augmentation on the batch's device for the pre-encode pass, the
port's own copy of ``flocoder_tpu/data/device_augs.py``.

The frozen augmentations of ``transforms.image_transforms`` (rotate ±15° →
center-crop 90% → RandomResizedCrop(0.8–1.0) → h-flip → normalise) are each
an affine map, so the chain composes into one map per sample and one
bilinear gather per batch, run on the card between the host-to-device copy
and the encode. The host decodes each image once, with one resize to a fixed
source size ``S0 = ⌈1.25·image_size⌉`` (``load_resized``, or the C++
``native_image.NativeLoadResized``), and the card makes every ``augs_per``
variant.

It comes in two parts, so that a test can inject the JAX package's draws:
``draw_params`` takes an explicit ``torch.Generator`` on the batch's device
and draws per sample the angle, area scale, aspect ratio, x, y and flip, by
the laws of the JAX module; ``warp`` takes those parameters and computes
what the JAX ``_bilinear_zero`` does: a half-pixel grid inside the crop
window, rotation about ``(S0 − 1)/2``, bilinear taps that are each zero
outside the image, then ``(x − 0.5)/0.5``. The rotation's cosine and sine
are taken in float64 and rounded once, so that the card and the CPU give
the same matrix, and the grid's products are added with one rounding
(``_fma``) where XLA's CPU code fuses a multiply-add, so that the
coordinates equal the JAX module's. Distributional parity, not bit parity,
with the host pipeline; see the JAX module for the square-source
assumption.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["AugParams", "default_src_size", "load_resized", "draw_params", "warp",
           "make_device_augment"]


def default_src_size(image_size: int) -> int:
    return int(math.ceil(image_size * 1.25))


def load_resized(img, src_size: int) -> np.ndarray:
    """The host half: a PIL image → float32 (S0, S0, C) in [0, 1], one
    bilinear resize per image. Non-square images are squashed to S0×S0."""
    from PIL import Image
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((src_size, src_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


class AugParams(NamedTuple):
    """Per-sample draws, each (B,): ``angle`` in degrees, ``scale`` (the
    crop's share of the frame's area), ``ratio`` (aspect), ``x`` and ``y``
    (the window's offset as a fraction of the room left, in [0, 1)) and
    ``flip`` (bool)."""
    angle: torch.Tensor
    scale: torch.Tensor
    ratio: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    flip: torch.Tensor


def draw_params(batch: int, generator: torch.Generator, rotate_deg: float = 15.0,
                rrc_scale: Tuple[float, float] = (0.8, 1.0),
                rrc_ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                hflip: float = 0.5) -> AugParams:
    """The draws of ``batch`` samples from ``generator`` (on the batch's
    device), by the JAX module's laws: angle U(−rotate_deg, rotate_deg),
    scale U(rrc_scale), ratio U(rrc_ratio), x and y U(0, 1), flip
    U(0, 1) < hflip."""
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        return torch.rand(batch, generator=generator, device=dev) * (hi - lo) + lo

    return AugParams(angle=u(-rotate_deg, rotate_deg), scale=u(*rrc_scale),
                     ratio=u(*rrc_ratio), x=u(), y=u(), flip=u() < hflip)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a·b + c with one rounding to fp32 (the product of two fp32 values is
    exact in float64)."""
    return (a.double() * b.double() + torch.as_tensor(c, dtype=torch.float64)).float()


def _bilinear_zero(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Samples ``img`` (B, H, W, C) at float coordinates ``ys``, ``xs`` (B,
    S, S), each tap zero outside the image (PIL rotate's black fill)."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0 = y0.long()
    x0 = x0.long()

    def tap(yi, xi):
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(*yi.shape, C)
        return v * valid

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def warp(images: torch.Tensor, params: AugParams, image_size: int,
         center_crop: float = 0.9, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """``images`` (B, S0, S0, C) in [0, 1] → (B, S, S, C) normalised to
    [−1, 1]: each sample's crop window, flip and rotation from ``params``,
    sampled bilinearly, in float32 on ``images``' device."""
    images = images.float()
    B, S0 = images.shape[0], images.shape[1]
    S = image_size
    dev = images.device
    p = AugParams(*(t.to(dev) for t in params))
    cc = center_crop * S0                     # the center crop's edge
    m = (S0 - cc) / 2.0                       # its origin
    area = cc * cc * p.scale.float()
    ar = p.ratio.float()
    cw = torch.clamp(torch.sqrt(area * ar), max=cc)
    ch = torch.clamp(torch.sqrt(area / ar), max=cc)
    x0 = _fma(p.x.float(), cc - cw, m)
    y0 = _fma(p.y.float(), cc - ch, m)

    ar_s = torch.arange(S, dtype=torch.float32, device=dev)
    jj = torch.where(p.flip[:, None], S - 1 - ar_s[None, :], ar_s[None, :])   # (B, S)
    # half-pixel-center sampling grid inside the crop window
    us = _fma(jj + 0.5, (cw / S)[:, None], x0[:, None]) - 0.5                 # (B, S)
    vs = _fma(ar_s[None, :] + 0.5, (ch / S)[:, None], y0[:, None]) - 0.5      # (B, S)
    U = us[:, None, :].expand(B, S, S)
    V = vs[:, :, None].expand(B, S, S)
    # rotation about the source center (PIL rotate, expand=False)
    theta = p.angle.float() * (math.pi / 180.0)
    cos = torch.cos(theta.double()).float()[:, None, None]
    sin = torch.sin(theta.double()).float()[:, None, None]
    c = (S0 - 1) / 2.0
    Xs = _fma(cos, U - c, c) - sin * (V - c)
    Ys = _fma(sin, U - c, c) + cos * (V - c)
    out = _bilinear_zero(images, Ys, Xs)
    return (out - mean) / std


def make_device_augment(image_size: int, src_size: Optional[int] = None,
                        rotate_deg: float = 15.0, center_crop: float = 0.9,
                        rrc_scale: Tuple[float, float] = (0.8, 1.0),
                        rrc_ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                        hflip: float = 0.5, mean: float = 0.5, std: float = 0.5):
    """``fn(images (B, S0, S0, C) in [0, 1], generator) -> (B, S, S, C)`` in
    [−1, 1]: the batched equivalent of ``transforms.image_transforms``, its
    draws from ``generator``."""
    S0 = src_size or default_src_size(image_size)

    def fn(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if images.shape[1] != S0 or images.shape[2] != S0:
            raise ValueError(f"device augment expects {S0}² sources, got "
                             f"{tuple(images.shape)}")
        params = draw_params(images.shape[0], generator, rotate_deg, rrc_scale,
                             rrc_ratio, hflip)
        return warp(images, params, image_size, center_crop, mean, std)

    return fn
