"""Perceptual networks, PyTorch port of ``flocoder_tpu/models/perceptual.py``:
the VGG16 features (conv1_1..conv3_3, ``VGG16Features``,
``make_perceptual_fn``) and ResNet50's logits (``ResNet50Logits``,
``make_resnet50_perceptual_fn``), with the converters of torchvision
state_dicts to the JAX package's weight files.

The weights load from a converted ``weights/vgg16_features.npz`` (flat
``Conv_i/kernel`` HWIO and ``Conv_i/bias``, the JAX package's format) when
that file exists; otherwise the network is a fixed seeded random init, as in
the JAX package. Nothing is downloaded. The weights are frozen; gradients
flow to the input images. ``dtype`` is the compute dtype, as the JAX
``VGG16Features(dtype)``: fp32 parameters, each convolution in ``dtype``
(``layers.Conv``), the features in ``dtype``; codec training passes the
codec's.

ResNet50 (``ResNet50Logits``): torchvision's topology through the
classifier, (N, 1000) logits, BatchNorm in inference (running statistics,
flax's ``(x − mean) · (scale · rsqrt(var + ε)) + bias``), fp32 only, under
linen's names (``conv1``, ``bn1``, ``layer1_0/conv1``, ...,
``downsample_conv``, ``fc``), so the JAX variables load through the bridge
(``RESNET_PREFIXES``). ``make_resnet50_perceptual_fn`` loads
``weights/resnet50_imagenet.npz`` when it exists, else a seeded random init
(BatchNorm at scale 1, bias 0, mean 0, var 1), and returns the loss
``mse(logits(img1), logits(img2).detach())`` of ImageNet-normalised images,
whose gradient reaches ``img1``. No entry point selects it, in either
package. ``convert_torch_vgg16`` and ``convert_torch_resnet50`` map
torchvision state_dicts to the flat weight files (``/``-joined flax paths);
nothing is downloaded.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Scope, conv, init_params

__all__ = ["VGG16Features", "make_perceptual_fn", "load_vgg16_weights",
           "convert_torch_vgg16", "ResNet50Logits", "convert_torch_resnet50",
           "load_resnet50_weights", "make_resnet50_perceptual_fn"]

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


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def convert_torch_vgg16(state_dict) -> dict:
    """A torchvision ``vgg16`` (or ``vgg16.features``) state_dict → the flat
    ``{Conv_i/kernel (HWIO), Conv_i/bias}`` mapping of the weight file
    ``load_vgg16_weights`` reads: the first seven convolutions
    (conv1_1..conv3_3) in order."""
    weights: dict = {}
    for k, v in state_dict.items():
        parts = k.removeprefix("features.").split(".")
        if len(parts) == 2 and parts[0].isdigit():
            weights.setdefault(int(parts[0]), {})[parts[1]] = _np(v)
    conv_ids = sorted(i for i in weights
                      if "weight" in weights[i] and weights[i]["weight"].ndim == 4)
    flat = {}
    for ci, tid in enumerate(conv_ids[:sum(1 for s in _VGG16_PLAN if s != "M")]):
        flat[f"Conv_{ci}/kernel"] = weights[tid]["weight"].transpose(2, 3, 1, 0)
        flat[f"Conv_{ci}/bias"] = weights[tid]["bias"]
    return flat


# ---------------------------------------------------------------------------
# ResNet50 logits

class BatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-5)``: the
    parameters ``scale`` and ``bias``, the statistics ``mean`` and ``var``
    (buffers, flax's ``batch_stats``)."""

    batch_stats = ("mean", "var")

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def init_special_(self, generator):
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x):
        col = lambda t: t[:, None, None]  # noqa: E731
        mul = torch.rsqrt(col(self.var) + self.eps) * col(self.scale)
        return (x - col(self.mean)) * mul + col(self.bias)


class _Bottleneck(nn.Module):
    """torchvision's Bottleneck: 1×1 → 3×3(stride) → 1×1 to 4·width, each
    with BatchNorm; a 1×1(stride) + BatchNorm projection where the shape
    changes."""

    def __init__(self, c_in: int, width: int, stride: int = 1):
        super().__init__()
        out = 4 * width
        self.conv1, self.bn1 = conv(c_in, width, 1, bias=False), BatchNorm(width)
        self.conv2, self.bn2 = conv(width, width, 3, stride, bias=False), BatchNorm(width)
        self.conv3, self.bn3 = conv(width, out, 1, bias=False), BatchNorm(out)
        self.project = stride != 1 or c_in != out
        if self.project:
            self.downsample_conv = conv(c_in, out, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.project:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + h)


class ResNet50Logits(nn.Module):
    """ResNet50 through the classifier: NHWC images → (N, 1000) logits."""

    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 7, 2, bias=False), BatchNorm(64)
        c, self.blocks = 64, []
        for li, (n, width) in enumerate([(3, 64), (4, 128), (6, 256), (3, 512)]):
            for b in range(n):
                blk = _Bottleneck(c, width, 2 if (b == 0 and li > 0) else 1)
                self.add_module(f"layer{li + 1}_{b}", blk)
                self.blocks.append(blk)
                c = 4 * width
        self.fc = Dense(c, 1000, bias=True)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for blk in self.blocks:
            h = blk(h)
        return self.fc(h.mean(dim=(2, 3)))


def convert_torch_resnet50(state_dict) -> dict:
    """A torchvision ``resnet50`` state_dict → the flat (``/``-joined) form
    of the JAX converter's tree: ``params/…`` (kernels HWIO, Dense (in,
    out), BatchNorm ``scale``/``bias``) and ``batch_stats/…`` (``mean``,
    ``var``), the layout of the weight file ``load_resnet50_weights``
    reads."""
    flat = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        v, parts = _np(val), key.split(".")
        if parts[0].startswith("layer"):        # layer1.0.conv1.weight → layer1_0/conv1
            mod, sub, leaf = [f"{parts[0]}_{parts[1]}"], parts[2], parts[3]
            if sub == "downsample":
                sub = "downsample_conv" if parts[3] == "0" else "downsample_bn"
                leaf = parts[4]
        else:
            mod, sub, leaf = [], parts[0], parts[-1]
        path = "/".join(mod + [sub])
        if sub.startswith("conv") or sub == "downsample_conv":
            flat[f"params/{path}/kernel"] = v.transpose(2, 3, 1, 0)
        elif sub == "fc":
            flat[f"params/{path}/{'kernel' if leaf == 'weight' else 'bias'}"] = (
                v.T if leaf == "weight" else v)
        elif leaf in ("weight", "bias"):
            flat[f"params/{path}/{'scale' if leaf == 'weight' else 'bias'}"] = v
        elif leaf in ("running_mean", "running_var"):
            flat[f"batch_stats/{path}/{leaf.removeprefix('running_')}"] = v
    return flat


def load_resnet50_weights(model: ResNet50Logits, path: str) -> Optional[ResNet50Logits]:
    """Load the flat weight file (``convert_torch_resnet50``'s keys) into
    ``model`` if the file exists."""
    if not os.path.exists(path):
        return None
    from ..training.checkpoint import RESNET_PREFIXES, load_jax_flat
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return load_jax_flat(model, flat, RESNET_PREFIXES)


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def make_resnet50_perceptual_fn(weights_path: str = "weights/resnet50_imagenet.npz",
                                seed: int = 0, device=None,
                                model: Optional[ResNet50Logits] = None):
    """``loss_fn(img1, img2) -> scalar``: the mean squared difference of the
    ResNet50 logits of the ImageNet-normalised [0, 1] NHWC images. The
    network is frozen (converted weights when the file exists, else a
    seeded random init, or the given ``model``); gradients reach ``img1``,
    ``img2`` is a target."""
    if model is None:
        model = ResNet50Logits()
        if load_resnet50_weights(model, weights_path) is None:
            init_params(model, torch.Generator().manual_seed(seed))
    if device is not None:
        model = model.to(device)
    model.requires_grad_(False).eval()

    def loss_fn(img1, img2):
        mean = torch.tensor(_IMAGENET_MEAN, device=img1.device)
        std = torch.tensor(_IMAGENET_STD, device=img1.device)
        logits = lambda img: model((img - mean) / std)  # noqa: E731
        return ((logits(img1) - logits(img2).detach()) ** 2).mean()

    return loss_fn
