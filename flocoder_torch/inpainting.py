"""Inpainting, PyTorch port of ``flocoder_tpu/inpainting.py``:

- ``MaskEncoder`` (with ``_DownsampleBlock``): a pixel mask (B, H, W, 1) to a
  latent-shaped conditioning (B, H/16, W/16, C), NHWC in and out. Two
  learnable 4× downsampling blocks, each with a hard average-pooled copy of
  the mask as a skip channel, a 1×1 head with a sigmoid, and the doubly
  shrunk raw mask as channel 0. With ``target_hw`` the encoding is resized
  to the codec's latent size (``jax.image.resize`` bilinear, built from the
  same weights as the JAX resize: ``ops/fid.py:resize_weights``).
  Submodules carry linen's names, so the weight bridge maps the JAX tree.
- ``mask_blending``: source + mask·(noise − source).
- The host-side mask generators (brush strokes, rectangles, noise, total,
  nothing, sampled with ``MASK_PROBS``), numpy with an explicit
  ``numpy.random.Generator``: the same seed gives the JAX package's masks.
- ``create_inpainting_triplet``: encode the image, mask it in pixel space,
  encode the masked image.
- ``approx_AL`` (a least-squares latent measurement operator, by the
  pseudo-inverse, which is the JAX ``lstsq``'s minimum-norm solution) and
  ``algorithm3`` (a training-free ΠGDM-style velocity correction).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops.fid import resize_weights

__all__ = ["MaskEncoder", "mask_blending", "simulate_brush_stroke",
           "generate_rectangles", "generate_mask", "generate_mask_batch",
           "create_inpainting_triplet", "approx_AL", "algorithm3",
           "resize_bilinear", "MASK_CHOICES", "MASK_PROBS"]


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), 'bilinear')`` of an NHWC tensor:
    separable linear weights, antialiased when downscaling, as jax builds
    them."""
    h, w = int(hw[0]), int(hw[1])
    if tuple(x.shape[1:3]) == (h, w):
        return x
    wh = torch.from_numpy(resize_weights(x.shape[1], h)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weights(x.shape[2], w)).to(x.device, x.dtype)
    return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)


def _shrink(x: torch.Tensor, f: int, mode: str) -> torch.Tensor:
    """NHWC ``f``× shrink: average pooling (``mode='pool'``) or the
    bilinear resize."""
    if mode == "pool":
        return F.avg_pool2d(x.permute(0, 3, 1, 2), f).permute(0, 2, 3, 1)
    return resize_bilinear(x, (x.shape[1] // f, x.shape[2] // f))


class _DownsampleBlock(nn.Module):
    """``shrink_fac``× learnable downsample (an f×f conv of stride f, SiLU,
    a 3×3 conv, SiLU) with the shrunk mask concatenated first. NHWC."""

    def __init__(self, in_channels: int, out_channels: int, shrink_fac: int = 4,
                 mode: str = "pool"):
        super().__init__()
        self.shrink_fac, self.mode = shrink_fac, mode
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, shrink_fac, stride=shrink_fac)
        self.Conv_1 = nn.Conv2d(out_channels, out_channels, 3, padding=1)

    def forward(self, x):
        skip = _shrink(x[..., 0:1], self.shrink_fac, self.mode)
        h = F.silu(self.Conv_0(x.permute(0, 3, 1, 2)))
        h = F.silu(self.Conv_1(h)).permute(0, 2, 3, 1)
        return torch.cat([skip, h], dim=-1)


class MaskEncoder(nn.Module):
    """Pixel mask (B, H, W, 1) → conditioning (B, H/16, W/16, C), or
    (B, *target_hw, C). Channel 0 is the raw doubly shrunk mask; the rest
    are learned features through ``final_act``."""

    def __init__(self, output_channels: int = 4, shrink_fac: int = 4,
                 mode: str = "pool", final_act: str = "sigmoid",
                 target_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.shrink_fac, self.mode, self.final_act = shrink_fac, mode, final_act
        self.target_hw = tuple(target_hw) if target_hw is not None else None
        self._DownsampleBlock_0 = _DownsampleBlock(1, 16, shrink_fac, mode)
        self._DownsampleBlock_1 = _DownsampleBlock(17, 32, shrink_fac, mode)
        self.Conv_0 = nn.Conv2d(33, output_channels - 1, 1)

    def forward(self, mask_pixels: torch.Tensor) -> torch.Tensor:
        x = mask_pixels.to(self.Conv_0.weight.dtype)
        if x.dim() == 3:
            x = x[..., None]
        h = self._DownsampleBlock_1(self._DownsampleBlock_0(x))
        h = self.Conv_0(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.final_act == "sigmoid":
            h = torch.sigmoid(h)
        elif self.final_act == "silu":
            h = F.silu(h)
        out = torch.cat([_shrink(x, self.shrink_fac ** 2, self.mode), h], dim=-1)
        if self.target_hw is not None:
            out = resize_bilinear(out, self.target_hw)
        return out


def mask_blending(source, mask, noise=None, generator: Optional[torch.Generator] = None):
    """source + mask·(noise − source); ``noise`` is drawn on ``generator``
    when not given."""
    if noise is None:
        if generator is None:
            raise ValueError("mask_blending needs noise or a generator")
        noise = torch.randn(source.shape, generator=generator, dtype=source.dtype,
                            device=generator.device)
    return source + mask * (noise - source)


# --------------------------------------------------------------------------
# Host-side mask generators (numpy): the JAX package's draws, in its order
# --------------------------------------------------------------------------

MASK_CHOICES = ("total", "brush", "rectangles", "noise", "nothing")
MASK_PROBS = (0.4, 0.35, 0.15, 0.05, 0.05)


def simulate_brush_stroke(size=(128, 128), num_strokes: int = 1,
                          brush_size: Optional[int] = None,
                          max_brush_size: int = 15,
                          rng: Optional[np.random.Generator] = None):
    """Random-walk brush strokes of varying radius."""
    rng = rng or np.random.default_rng()
    mask = np.zeros(size)
    for _ in range(num_strokes):
        bs = brush_size if brush_size is not None else int(
            rng.integers(3, max_brush_size))
        x = float(rng.integers(0, size[0]))
        y = float(rng.integers(size[1] // 3, 2 * size[1] // 3))
        length = int(rng.integers(100, 300))
        direction = rng.uniform(-np.pi / 10, np.pi / 10)
        if x > size[0] / 2:
            direction += np.pi
        for _ in range(length):
            direction += rng.normal(0, 0.04)
            nx, ny = x + np.cos(direction) * 0.7, y + np.sin(direction) * 0.7
            if not (0 <= nx < size[0] and 0 <= ny < size[1]):
                break
            x, y = nx, ny
            cur = max(1, bs + int(rng.integers(-bs // 2, max(bs // 2, 1))))
            xi, yi, r = int(x), int(y), cur + 1
            y0, y1 = max(0, yi - r), min(size[0], yi + r + 1)
            x0, x1 = max(0, xi - r), min(size[1], xi + r + 1)
            yy, xx = np.ogrid[y0:y1, x0:x1]
            mask[y0:y1, x0:x1][(xx - xi) ** 2 + (yy - yi) ** 2 <= cur ** 2] = 1
    return mask


def generate_rectangles(size=(128, 128), max_size_ratio_x: float = 0.8,
                        max_size_ratio_y: float = 0.3,
                        rng: Optional[np.random.Generator] = None):
    """2–10 random rectangles."""
    rng = rng or np.random.default_rng()
    mask = np.zeros(size)
    max_w = int(size[0] * max_size_ratio_x)
    max_h = int(size[1] * max_size_ratio_y)
    for _ in range(int(rng.integers(2, 11))):
        w = int(rng.integers(3, max(max_w, 4)))
        h = int(rng.integers(3, max(max_h, 4)))
        x = int(rng.integers(0, max(size[0] - w, 1)))
        y = int(rng.integers(0, max(size[1] - h, 1)))
        mask[x:x + w, y:y + h] = 1
    return mask.T


def generate_mask(size=(128, 128), mask_type: str = "", choices=MASK_CHOICES,
                  p=MASK_PROBS, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Draw a mask type (unless given) and the mask: float32 (H, W) in
    {0, 1}."""
    rng = rng or np.random.default_rng()
    if not mask_type:
        mask_type = rng.choice(choices, p=np.asarray(p) / np.sum(p))
    if mask_type == "total":
        mask = np.ones(size)
    elif mask_type == "brush":
        mask = simulate_brush_stroke(size, num_strokes=int(rng.integers(2, 6)), rng=rng)
    elif mask_type == "rectangles":
        mask = generate_rectangles(size, rng=rng)
    elif mask_type == "noise":
        mask = (rng.random(size) > 0.7).astype(float)
    elif mask_type == "nothing":
        mask = np.zeros(size)
    else:
        raise ValueError(f"Unsupported mask_type: {mask_type}")
    return mask.astype(np.float32)


def generate_mask_batch(size=(128, 128), batch_size: int = 1,
                        unique_masks: bool = True, seed: Optional[int] = None,
                        **kwargs) -> np.ndarray:
    """(B, H, W, 1) float32 masks from one generator seeded with ``seed``:
    one draw per item, or one mask tiled."""
    rng = np.random.default_rng(seed)
    if unique_masks:
        out = np.stack([generate_mask(size, rng=rng, **kwargs)
                        for _ in range(batch_size)], axis=0)
    else:
        out = np.tile(generate_mask(size, rng=rng, **kwargs)[None], (batch_size, 1, 1))
    return out[..., None]


@torch.no_grad()
def create_inpainting_triplet(full_image: torch.Tensor, codec, quantize: bool = False,
                              rng: Optional[np.random.Generator] = None,
                              seed: Optional[int] = None) -> tuple:
    """``(target_latents, mask_pixels, source_latents)`` of one NHWC image
    batch: encode the image, draw the masks (``generate_mask_batch`` seeded
    with ``seed``, else with a draw of ``rng``), encode the masked image;
    with ``quantize``, both latents through the codec's RVQ. The masks are a
    (B, H, W, 1) numpy array; the latents stay on the image's device."""
    target = codec.encode(full_image)
    if seed is None:
        seed = None if rng is None else int(rng.integers(2 ** 31))
    mask = generate_mask_batch(tuple(full_image.shape[1:3]),
                               batch_size=full_image.shape[0], seed=seed)
    mask_t = torch.from_numpy(mask).to(full_image.device, full_image.dtype)
    source = codec.encode(full_image * (1 - mask_t))
    if quantize and hasattr(codec, "quantize"):
        source = codec.quantize(source)[0]
        target = codec.quantize(target)[0]
    return target, mask, source


def approx_AL(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Least-squares latent measurement operator A_L with Y ≈ X·A_Lᵀ (X the
    flattened targets, Y the flattened sources), the minimum-norm solution."""
    X = target.reshape(target.shape[0], -1)
    Y = source.reshape(source.shape[0], -1)
    return (torch.linalg.pinv(X) @ Y).T


def algorithm3(v, x, t, tp, y, A, sigma_y: float = 0.05, gamma_t: float = 1.0):
    """Training-free inverse-problem velocity correction (ΠGDM-style) on
    the conditional-OT path α_t = t, σ_t = 1 − t."""
    r_tp_sq = (1 - tp) ** 2 / (tp ** 2 + (1 - tp) ** 2)
    alpha_t, sigma_t = tp, 1 - tp
    d_ln_ratio_dt = 1.0 / (tp * (1 - tp))
    d_ln_sigma_dt = -1.0 / (1 - tp)
    coeff_inv = 1.0 / (alpha_t * d_ln_ratio_dt)
    x1_hat = coeff_inv * (v - d_ln_sigma_dt * x)
    residual = y - A @ x1_hat.reshape(-1)
    cov = r_tp_sq * (A @ A.T) + sigma_y ** 2 * torch.eye(A.shape[0], dtype=x.dtype,
                                                         device=x.device)
    g = (residual @ torch.linalg.solve(cov, A)).reshape(x.shape)
    return v + sigma_t ** 2 * d_ln_ratio_dt * gamma_t * g
