"""The FID InceptionV3 feature extractor (pool3, 2048 features), the port's
twin of ``flocoder_tpu/models/inception.py``.

- ``InceptionV3Features(fid_variant=True)``: torchvision's ``inception_v3``
  through the global average pool, with the FID-Inception pooling quirks of
  pytorch-fid and torch-fidelity: ``count_include_pad=False`` in the A and
  C blocks' and Mixed_7b's average pools, and a max pool in Mixed_7c's pool
  branch. BatchNorm runs on its running statistics (eps 1e-3).
  Submodules carry the torch tree's names (``Mixed_5b.branch1x1.conv``), so
  a torchvision or pytorch-fid ``state_dict`` loads strictly
  (``convert_torch_inception`` only drops the classifier heads).
- ``save_inception_weights`` / ``load_inception_weights``: the JAX package's
  flat npz (``params/<module>/conv/kernel`` HWIO, ``params/…/bn/scale``,
  ``bias``, ``batch_stats/…/bn/mean``, ``var``), so that one converted file
  serves both packages.
- ``make_inception_feature_fn``: ``feature_fn(images) -> (N, 2048)`` with
  the JAX function's input pipeline: uint8, or float clipped to [-1, 1]
  and scaled to [0, 255]; a grey image repeated to three channels; a
  bilinear resize to 299² with ``jax.image.resize``'s weights (half-pixel
  centres, and antialiased when it shrinks, which ``F.interpolate`` does
  not do by default: ``ops/fid.resize_weights``); then (x − 128)/128.
  Its ``backend_name`` is ``fid_inception``, or
  ``fid_inception_random_init`` when no weights file exists (a seeded
  random init: self-consistent features, not comparable to published
  FIDs). No weights are shipped or fetched.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import init_params

__all__ = ["InceptionV3Features", "convert_torch_inception", "save_inception_weights",
           "load_inception_weights", "make_inception_feature_fn"]


class BasicConv2d(nn.Module):
    """Conv (no bias) → BatchNorm (eps 1e-3, running statistics) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, False, 0.0, bn.eps))


def _avg3(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x, not self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3(x, not self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool``: 'avg' (torchvision), 'avg_nopad' (FID Mixed_7b) or 'max'
    (FID Mixed_7c)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg3(x, self.pool == "avg")
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """InceptionV3 through the global average pool: (N, 3, 299, 299) NCHW,
    normalised to about [-1, 1] → (N, 2048). ``make_inception_feature_fn``
    takes NHWC images and applies the input pipeline."""

    def __init__(self, fid_variant: bool = True):
        super().__init__()
        fid = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_nopad" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# weights: torchvision / pytorch-fid state_dicts and the JAX flat npz

_SKIP_PREFIXES = ("fc.", "AuxLogits.")


def convert_torch_inception(state_dict) -> dict:
    """A torch ``inception_v3`` state_dict (torchvision / pytorch-fid names)
    as this module's: the classifier heads (``fc.``, ``AuxLogits.``) and
    ``num_batches_tracked`` dropped, every other key kept as it is; a key
    outside a ``conv``/``bn`` submodule raises."""
    out = {}
    for key, val in state_dict.items():
        if key.startswith(_SKIP_PREFIXES) or key.endswith("num_batches_tracked"):
            continue
        if key.split(".")[-2] not in ("conv", "bn"):
            raise ValueError(f"unrecognized inception key: {key}")
        out[key] = torch.as_tensor(np.asarray(getattr(val, "numpy", lambda: val)()))
    return out


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def save_inception_weights(model: nn.Module, path: str) -> None:
    """``model``'s weights as the JAX package's flat npz: conv kernels HWIO
    under ``params/<module>/conv/kernel``, BatchNorm under
    ``params/<module>/bn/{scale,bias}`` and ``batch_stats/<module>/bn/{mean,var}``."""
    flat = {}
    for key, val in model.state_dict().items():
        *mod, sub, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        v = val.detach().cpu().numpy()
        if sub == "conv":
            flat["/".join(["params", *mod, "conv", "kernel"])] = v.transpose(2, 3, 1, 0)
        else:
            coll, name = _BN_LEAVES[leaf]
            flat["/".join([coll, *mod, "bn", name])] = v
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_inception_weights(path: str) -> Optional[dict]:
    """The JAX flat npz at ``path`` as this module's ``state_dict`` (None if
    the file does not exist)."""
    if not os.path.exists(path):
        return None
    back = {v: k for k, v in _BN_LEAVES.items()}
    state = {}
    with np.load(path) as z:
        for key in z.files:
            coll, *mod, sub, leaf = key.split("/")
            v = z[key]
            if sub == "conv":
                state[".".join([*mod, "conv", "weight"])] = torch.from_numpy(
                    np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
            else:
                state[".".join([*mod, "bn", back[(coll, leaf)]])] = torch.from_numpy(v)
    return state


# ---------------------------------------------------------------------------
# feature_fn for ops.fid

def make_inception_feature_fn(weights_path: str = "weights/fid_inception.npz",
                              state: Optional[dict] = None, seed: int = 0):
    """``feature_fn(images) -> (N, 2048)`` on NHWC images (uint8 in [0, 255]
    or float in about [-1, 1]; 1 or 3 channels), run on the images' device.
    Weights: ``state`` (this module's ``state_dict``) if given, else the
    npz at ``weights_path`` if it exists, else a seeded random init
    (``layers.init_params`` with ``seed``; BatchNorm at mean 0, variance
    1). The model is built on each device the images arrive on, at its
    first call there."""
    from ..ops.fid import resize_weights
    pretrained = True
    if state is None:
        state = load_inception_weights(weights_path)
        pretrained = state is not None
    models: dict = {}
    weights: dict = {}

    def model_on(dev):
        if dev not in models:
            with torch.device(dev):
                model = InceptionV3Features(fid_variant=True)
            if state is None:
                init_params(model, torch.Generator(dev).manual_seed(seed))
            else:
                model.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True)
            models[dev] = model.eval()
        return models[dev]

    @torch.no_grad()
    def feature_fn(images: torch.Tensor) -> torch.Tensor:
        x = images
        if not torch.is_floating_point(x):
            x = x.float()
        else:
            x = x.float().clamp(-1.0, 1.0) * 127.5 + 127.5
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        _, h, w, _ = x.shape
        key = (h, w, x.device)
        if key not in weights:
            weights[key] = tuple(torch.from_numpy(resize_weights(n, 299)).to(x.device)
                                 for n in (h, w))
        wh, ww = weights[key]
        x = torch.einsum("bhwc,hi,wj->bcij", x, wh, ww)          # NCHW at 299²
        x = (x - 128.0) / 128.0
        return model_on(x.device)(x)

    feature_fn.backend_name = "fid_inception" if pretrained else "fid_inception_random_init"
    return feature_fn
