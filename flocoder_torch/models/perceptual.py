"""Perceptual features (VGG16 conv1_1..conv3_3), PyTorch port of
``flocoder_tpu/models/perceptual.py``: ``VGG16Features`` and
``make_perceptual_fn``.

The weights load from a converted ``weights/vgg16_features.npz`` (flat
``Conv_i/kernel`` HWIO and ``Conv_i/bias``, the JAX package's format) when
that file exists; otherwise the network is a fixed seeded random init, as in
the JAX package. Nothing is downloaded. The weights are frozen; gradients
flow to the input images. ``dtype`` is the compute dtype, as the JAX
``VGG16Features(dtype)``: fp32 parameters, each convolution in ``dtype``
(``layers.Conv``), the features in ``dtype``; codec training passes the
codec's. The ResNet50 perceptual loss is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Scope, init_params

__all__ = ["VGG16Features", "make_perceptual_fn", "load_vgg16_weights"]

# torchvision vgg16.features[:16]: channel plan per conv, 'M' = maxpool
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256)


class VGG16Features(nn.Module):
    """conv1_1..conv3_3; returns the post-ReLU activation before each max
    pool and at the end (3 feature maps). NHWC in and out; ``dtype`` the
    compute dtype (None or fp32: the parameters')."""

    def __init__(self, dtype=None):
        super().__init__()
        s = Scope(self)
        self.plan, c = [], 3
        for spec in _VGG16_PLAN:
            if spec == "M":
                self.plan.append(None)
            else:
                self.plan.append(s.conv(c, spec, 3,
                                        dtype=None if dtype == torch.float32 else dtype))
                c = spec

    def forward(self, x):
        h, feats = x.permute(0, 3, 1, 2), []
        for conv in self.plan:
            if conv is None:
                feats.append(h)
                h = F.max_pool2d(h, 2)
            else:
                h = F.relu(conv(h))
        feats.append(h)
        return [f.permute(0, 2, 3, 1) for f in feats]


def load_vgg16_weights(model: VGG16Features, path: str) -> Optional[VGG16Features]:
    """Load the JAX package's flat npz into ``model`` if the file exists."""
    if not os.path.exists(path):
        return None
    from ..training.checkpoint import VGG_PREFIXES, load_jax_flat
    with np.load(path) as z:
        flat = {f"params/{k}": z[k] for k in z.files}
    return load_jax_flat(model, flat, VGG_PREFIXES)


def make_perceptual_fn(weights_path: str = "weights/vgg16_features.npz",
                       seed: int = 0, device=None, model: Optional[VGG16Features] = None,
                       dtype=None):
    """``feature_fn(images_imagenet_normalized) -> [feature maps]`` for
    ``metrics.perceptual_loss``: converted weights when the file exists,
    else a seeded random init (or the given ``model``), frozen, on
    ``device``; a network built here computes in ``dtype``."""
    if model is None:
        model = VGG16Features(dtype)
        if load_vgg16_weights(model, weights_path) is None:
            init_params(model, torch.Generator().manual_seed(seed))
    if device is not None:
        model = model.to(device)
    return model.requires_grad_(False).eval()
