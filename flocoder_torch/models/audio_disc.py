"""Waveform discriminators of the DAC codec's adversarial stage, PyTorch
port of ``flocoder_tpu/models/audio_disc.py``: the multi-period
(``PeriodDiscriminator``) and multi-scale (``ScaleDiscriminator``)
ensembles, plain convolutions and LeakyReLU(0.1) (``layers.leaky_relu``).

- A period view folds (B, T, 1) into a (T/p) × p map, after padding a
  length that does not divide by p with the reversed last samples, as the
  JAX module concatenates them, and applies (5, 1) convolutions of stride
  (3, 1) over time with flax's asymmetric ``SAME`` padding.
- A scale view average-pools by ``pool`` (flax ``avg_pool`` with ``SAME``
  zero padding, counted in the mean), then a k-15 stem, grouped k-41
  convolutions of stride 4 (``max(1, min(4, c // 16))`` groups) and a k-5
  convolution.

Both views cast the waveform to their parameters' dtype first (fp32; the
JAX modules cast a bf16 waveform to their own dtype, fp32 as the trainer
builds them). Each returns (logits, features) in torch's layout:
(B, C, T/p, p) maps for a period view, (B, C, T') for a scale view; the JAX
modules return the same values channels-last. ``DACDiscriminator`` returns (logits list,
features lists) in the JAX order, the periods first and then the scales,
its submodules named ``mpd_<p>`` and ``msd_<pool>`` as in linen.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .audio_codec import Conv1d, same_pads
from .layers import leaky_relu

__all__ = ["PeriodDiscriminator", "ScaleDiscriminator", "DACDiscriminator"]


class _TimeConv2d(nn.Conv2d):
    """flax ``nn.Conv`` with a (k, 1) kernel, stride (s, 1) and ``SAME``
    padding on (B, C, T/p, p): padded over time only."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, (k, 1), stride=(stride, 1))

    def forward(self, x):
        lo, hi = same_pads(x.shape[2], self.kernel_size[0], self.stride[0])
        return F.conv2d(F.pad(x, (0, 0, lo, hi)), self.weight, self.bias, self.stride)


class PeriodDiscriminator(nn.Module):
    """One period view: ``n_layers`` (5, 1) stride-3 convolutions with the
    channels ×4 a stage from ``base_channels`` (capped at
    ``max_channels``), a (5, 1) convolution and a (3, 1) head."""

    def __init__(self, period: int, base_channels: int = 32, n_layers: int = 4,
                 max_channels: int = 512):
        super().__init__()
        self.period = period
        convs, cin, c = [], 1, base_channels
        for _ in range(n_layers):
            convs.append(_TimeConv2d(cin, min(c, max_channels), 5, 3))
            cin, c = min(c, max_channels), c * 4
        convs.append(_TimeConv2d(cin, min(c, max_channels), 5))
        convs.append(_TimeConv2d(min(c, max_channels), 1, 3))
        for i, m in enumerate(convs):
            self.add_module(f"Conv_{i}", m)
        self.convs = convs

    def forward(self, x):
        b, t, _ = x.shape
        p = self.period
        pad = (-t) % p
        if pad:
            x = torch.cat([x, x[:, t - pad:].flip(1)], dim=1)
        h = x.reshape(b, (t + pad) // p, p)[:, None].to(self.convs[0].weight.dtype)
        feats = []
        for conv in self.convs[:-1]:
            h = leaky_relu(conv(h), 0.1)
            feats.append(h)
        return self.convs[-1](h).float(), feats


class ScaleDiscriminator(nn.Module):
    """One scale view: average pool by ``pool``, a k-15 stem, ``n_layers``
    grouped k-41 stride-4 convolutions, a k-5 convolution and a k-3 head."""

    def __init__(self, pool: int = 1, base_channels: int = 32, n_layers: int = 4,
                 max_channels: int = 512):
        super().__init__()
        self.pool = pool
        convs, c = [Conv1d(1, base_channels, 15)], base_channels
        for _ in range(n_layers):
            cout = min(c * 4, max_channels)
            convs.append(Conv1d(c, cout, 41, 4, groups=max(1, min(4, cout // 16))))
            c = cout
        convs.append(Conv1d(c, min(2 * c, max_channels), 5))
        convs.append(Conv1d(min(2 * c, max_channels), 1, 3))
        for i, m in enumerate(convs):
            self.add_module(f"Conv_{i}", m)
        self.convs = convs

    def forward(self, x):
        h = x.permute(0, 2, 1).to(self.convs[0].weight.dtype)
        if self.pool > 1:
            lo, hi = same_pads(h.shape[-1], self.pool, self.pool)
            h = F.avg_pool1d(F.pad(h, (lo, hi)), self.pool, self.pool)
        feats = []
        for conv in self.convs[:-1]:
            h = leaky_relu(conv(h), 0.1)
            feats.append(h)
        return self.convs[-1](h).float(), feats


class DACDiscriminator(nn.Module):
    """The ensemble: period views over ``periods``, then scale views over
    pools 1, 2, …, 2^(scales−1). ``forward(x)`` of (B, T, 1) or (B, T) →
    (list of logits, list of feature lists)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), scales: int = 3,
                 base_channels: int = 32, n_layers: int = 4, max_channels: int = 512):
        super().__init__()
        self.periods, self.scales = tuple(periods), scales
        views = []
        for p in self.periods:
            views.append(PeriodDiscriminator(p, base_channels, n_layers, max_channels))
            self.add_module(f"mpd_{p}", views[-1])
        for s in range(scales):
            views.append(ScaleDiscriminator(2 ** s, base_channels, n_layers, max_channels))
            self.add_module(f"msd_{2 ** s}", views[-1])
        self.views = views

    def forward(self, x):
        if x.ndim == 2:
            x = x[..., None]
        logits, feats = [], []
        for view in self.views:
            lg, f = view(x)
            logits.append(lg)
            feats.append(f)
        return logits, feats
