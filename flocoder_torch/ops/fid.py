"""Fréchet distance on image features, PyTorch port of
``flocoder_tpu/ops/fid.py``.

The statistics (feature means and covariances, the matrix square root by
Newton–Schulz iteration) run in fp32 on the images' device. The default
feature function is the JAX package's "rp2048": multi-scale average pooling
of the pixels (8², 4², 2²) through a fixed Gaussian projection and tanh. Its
projection matrix comes from numpy's Philox stream, so both packages use
the same matrix bit for bit. The pooling is ``jax.image.resize(...,
"linear")``, which antialiases when it downscales: the port builds the
same resize weights from jax's formula (``scale_and_translate`` with a
triangle kernel widened by the downscale factor) instead of trusting
``F.interpolate``'s antialiasing to agree. These are not Inception features:
absolute values are not comparable to published FIDs. When
``weights/fid_inception.npz`` (relative to the working directory) exists,
``default_feature_fn`` returns the FID-Inception features instead
(``models/inception.py``), as the JAX package does.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["frechet_distance", "fid_score", "fid_score_chunked",
           "make_random_projection_features", "sqrtm_newton_schulz",
           "default_feature_fn", "feature_backend_name", "resize_weights"]


def sqrtm_newton_schulz(A: torch.Tensor, n_iters: int = 20) -> torch.Tensor:
    """Square root of a PSD matrix by the Newton–Schulz iteration."""
    dim = A.shape[0]
    norm = torch.linalg.norm(A)
    Y = A / norm
    eye = torch.eye(dim, dtype=A.dtype, device=A.device)
    Z = eye
    for _ in range(n_iters):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Y * torch.sqrt(norm)


def frechet_distance(mu1, cov1, mu2, cov2, eps_rel: float = 1e-3,
                     n_sqrt_iters: int = 20) -> torch.Tensor:
    """|μ1−μ2|² + tr(C1 + C2 − 2·sqrt(C1 C2)), the covariances ridged by
    ``eps_rel`` times their mean diagonal (rank-deficient covariances of
    fewer samples than features would make the iteration diverge)."""
    diff = mu1 - mu2
    dim = cov1.shape[0]
    scale = 0.5 * (torch.trace(cov1) + torch.trace(cov2)) / dim
    off = (eps_rel * scale + 1e-10) * torch.eye(dim, dtype=cov1.dtype, device=cov1.device)
    c1, c2 = cov1 + off, cov2 + off
    covmean = sqrtm_newton_schulz(c1 @ c2, n_iters=n_sqrt_iters)
    return diff @ diff + torch.trace(c1) + torch.trace(c2) - 2.0 * torch.trace(covmean)


def _stats(feats: torch.Tensor) -> tuple:
    mu = feats.mean(0)
    centered = feats - mu
    return mu, centered.T @ centered / (feats.shape[0] - 1)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    'linear' method along one axis, antialiased: jax's
    ``compute_weight_mat`` with scale out/in and no translation."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _projection_matrix(in_dim: int, out_dim: int, seed: int) -> np.ndarray:
    """The fixed Gaussian projection from numpy's Philox stream, float32."""
    rng = np.random.Generator(np.random.Philox(seed))
    W = rng.standard_normal((in_dim, out_dim), dtype=np.float64)
    return (W / np.sqrt(in_dim)).astype(np.float32)


def make_random_projection_features(dim: int = 2048, seed: int = 0,
                                    image_size: int = 128) -> Callable:
    """The deterministic random-feature extractor ``f(images) -> (N, dim)``.
    Input: uint8 in [0, 255], or float in [-1, 1] (clipped; a float image
    that looks like 0–255 warns). NHWC, any channel count."""
    cache: dict = {}

    def feature_fn(images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        if images.dtype == torch.uint8:
            x = x / 127.5 - 1.0
        else:
            if float(x.abs().max()) > 8.0:
                warnings.warn("fid feature_fn: float input range looks like 0-255; "
                              "pass uint8 or rescale to [-1,1] (values are clipped "
                              "to [-1,1])")
            x = x.clamp(-1.0, 1.0)
        b, h, w, c = x.shape
        feats = []
        for s in (8, 4, 2):
            key = (h, w, s, x.device)
            if key not in cache:
                cache[key] = (torch.from_numpy(resize_weights(h, s)).to(x.device),
                              torch.from_numpy(resize_weights(w, s)).to(x.device))
            wh, ww = cache[key]
            feats.append(torch.einsum("bhwc,hi,wj->bijc", x, wh, ww).reshape(b, -1))
        flat = torch.cat(feats, dim=1)
        key = (flat.shape[1], x.device)
        if key not in cache:
            cache[key] = torch.from_numpy(_projection_matrix(flat.shape[1], dim, seed)
                                          ).to(x.device)
        return torch.tanh(flat @ cache[key])

    feature_fn.backend_name = f"rp{dim}"
    return feature_fn


def default_feature_fn(image_size: int = 128) -> Callable:
    """The FID-Inception features when ``weights/fid_inception.npz`` exists
    (``backend_name`` ``fid_inception``), else rp2048."""
    if os.path.exists("weights/fid_inception.npz"):
        from ..models.inception import make_inception_feature_fn
        return make_inception_feature_fn()
    return make_random_projection_features(image_size=image_size)


def feature_backend_name(feature_fn: Optional[Callable]) -> str:
    if feature_fn is None:
        return getattr(default_feature_fn(), "backend_name", "unknown")
    return getattr(feature_fn, "backend_name", "custom")


@torch.no_grad()
def fid_score(real: torch.Tensor, fake: torch.Tensor,
              feature_fn: Optional[Callable] = None,
              eps_rel: float = 1e-3) -> torch.Tensor:
    """FID between two NHWC image batches (uint8, or float in [-1, 1])."""
    if feature_fn is None:
        feature_fn = default_feature_fn()
    mu1, c1 = _stats(feature_fn(real))
    mu2, c2 = _stats(feature_fn(fake))
    return frechet_distance(mu1, c1, mu2, c2, eps_rel=eps_rel)


@torch.no_grad()
def fid_score_chunked(real, fake, feature_fn: Optional[Callable] = None,
                      chunk_size: int = 128, eps_rel: float = 1e-3) -> torch.Tensor:
    """``fid_score`` with the features taken ``chunk_size`` images at a
    time; the same statistics."""
    if feature_fn is None:
        feature_fn = default_feature_fn()

    def feats(x):
        return torch.cat([feature_fn(x[i:i + chunk_size])
                          for i in range(0, x.shape[0], chunk_size)])

    mu1, c1 = _stats(feats(real))
    mu2, c2 = _stats(feats(fake))
    return frechet_distance(mu1, c1, mu2, c2, eps_rel=eps_rel)
