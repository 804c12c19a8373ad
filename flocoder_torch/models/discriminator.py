"""Patch discriminators for VQGAN adversarial training, PyTorch port of
``flocoder_tpu/models/discriminator.py``: ``GaussianBlur``,
``DiscrResBlock``, ``PatchDiscriminator``, ``VQGANPlusPatchDiscriminator``
(the one training uses by default) and ``VQGANPlusDiscriminator``. Each
takes NHWC images and returns ``(patch_logits, features)``, NHWC.

Spectral normalisation follows flax 0.12's ``SpectralNorm`` (not
``torch.nn.utils.spectral_norm``, whose layout and update rule differ): each
conv kernel, in flax's HWIO layout reshaped to (kh·kw·in, out), is divided
by σ = v·W·uᵀ after one power-iteration step from the stored ``u`` (1, out),
v = ‖u Wᵀ‖-normalised, u' = ‖v W‖-normalised, both held constant for the
gradient. Every forward runs that step; only ``update_stats=True`` stores
u' and σ (the JAX package's ``batch_stats``, ``<layer>/kernel/u`` and
``/sigma`` under the wrapper's ``SpectralNorm_<i>``; the weight bridge is
``training/checkpoint.py``). The discriminator step runs with
``update_stats=True``, real batch then fake; the generator's view with
``False``.

``dtype`` is the compute dtype, with flax's ``dtype=`` semantics (the JAX
modules' ``dtype``; ``train_vqgan`` passes the codec's): the parameters,
``u`` and σ stay fp32, and the power iteration and the division run in
fp32, since flax's ``SpectralNorm`` has no dtype of its own; each conv then
casts its input, the normalised kernel and the bias to ``dtype`` and adds
the bias after the product is rounded; GroupNorm takes its statistics in
fp32 and gives ``dtype``; LeakyReLU multiplies by the slope rounded to
``dtype``, as ``jax.nn.leaky_relu``. Logits and features come out in
``dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, group_norm, init_params, leaky_relu

__all__ = ["SNConv", "GaussianBlur", "DiscrResBlock", "PatchDiscriminator",
           "VQGANPlusPatchDiscriminator", "VQGANPlusDiscriminator",
           "init_discriminator", "make_disc_apply"]


def _compute(dtype):
    """None (compute in the parameters' dtype) for fp32, as the codecs do:
    a float64 copy then computes in float64."""
    return None if dtype == torch.float32 else dtype


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv(Conv):
    """A conv whose kernel is spectrally normalised as flax's
    ``SpectralNorm(nn.Conv(..., dtype=dtype))``. ``sn_name`` is the
    wrapper's name in the JAX tree (``SpectralNorm_<i>``); ``u`` and
    ``sigma`` are fp32 buffers."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, sn_name: str = "SpectralNorm_0", dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = _compute(dtype)
        self.sn_name = sn_name
        self.register_buffer("u", torch.ones(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def init_special_(self, generator: torch.Generator):
        self.u.copy_(torch.randn(self.u.shape, generator=generator,
                                 device=generator.device))
        self.sigma.fill_(1.0)

    def forward(self, x, update_stats: bool = False):
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.out_channels)
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ w.T)
            u0 = _l2_normalize(v0 @ w)
        sigma = (v0 @ w @ u0.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        kernel = self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return self.conv_with(x, kernel)


class GaussianBlur(nn.Module):
    """Fixed 4×4 Gaussian depthwise conv, stride 2, padding 1: the
    anti-aliased downsample. No parameters."""

    def forward(self, x):
        k = (torch.tensor([[1., 2., 2., 1.], [2., 4., 4., 2.],
                           [2., 4., 4., 2.], [1., 2., 2., 1.]],
                          device=x.device) / 36.0).to(x.dtype)
        c = x.shape[1]
        return F.conv2d(x, k.expand(c, 1, 4, 4), stride=2, padding=1, groups=c)


class _SNScope:
    """Names a module's spectrally normalised convs as linen does: the conv
    ``Conv_<i>`` and its wrapper ``SpectralNorm_<j>``, in creation order."""

    def __init__(self, owner: nn.Module, dtype=None):
        self.owner, self.n, self.dtype = owner, 0, dtype

    def __call__(self, cin, cout, kernel, stride=1, padding=0) -> str:
        """Registers the conv; returns its name."""
        name = f"Conv_{self.n}"
        self.owner.add_module(name, SNConv(cin, cout, kernel, stride, padding,
                                           f"SpectralNorm_{self.n}", self.dtype))
        self.n += 1
        return name


class DiscrResBlock(nn.Module):
    """Spectral-norm residual block with GroupNorm and LeakyReLU(0.2)."""

    def __init__(self, c_in: int, out_channels: int, stride: int = 1, dtype=None):
        super().__init__()
        groups = min(32, max(1, out_channels // 4))
        dtype = _compute(dtype)
        sn = _SNScope(self, dtype)
        self.convs = []        # names: [identity projection,] conv a, conv b
        if stride != 1 or c_in != out_channels:
            self.convs.append(sn(c_in, out_channels, 1, stride))
        self.convs.append(sn(c_in, out_channels, 3, stride, 1))
        self.GroupNorm_0 = group_norm(groups, out_channels, 1e-5, dtype)
        self.convs.append(sn(out_channels, out_channels, 3, 1, 1))
        self.GroupNorm_1 = group_norm(groups, out_channels, 1e-5, dtype)

    def forward(self, x, update_stats: bool = False):
        *proj, conv_a, conv_b = (getattr(self, n) for n in self.convs)
        identity = proj[0](x, update_stats) if proj else x
        h = leaky_relu(self.GroupNorm_0(conv_a(x, update_stats)), 0.2)
        h = self.GroupNorm_1(conv_b(h, update_stats))
        return leaky_relu(h + identity, 0.2)


class _Discriminator(nn.Module):
    """Stem conv → LeakyReLU → per layer [blur] + DiscrResBlock → head conv
    to one logit per patch; features after the stem and every block."""

    def __init__(self, in_channels, base, n_layers, stem_kernel, blur, strided,
                 dtype=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        dtype = _compute(dtype)
        sn = _SNScope(self, dtype)
        sn(in_channels, base, stem_kernel, 1, 1)                 # Conv_0
        layers, cur = [], base
        for i in range(n_layers):
            nxt = min(base * (2 ** (i + 1)), 512)
            last = i == n_layers - 1
            if blur and not last:
                layers.append(GaussianBlur())
            block = DiscrResBlock(cur, nxt, stride=2 if strided and not last else 1,
                                  dtype=dtype)
            self.add_module(f"DiscrResBlock_{i}", block)
            layers.append(block)
            cur = nxt
        self.layers = layers
        sn(cur, 1, stem_kernel, 1, 1)                            # Conv_1

    def forward(self, x, update_stats: bool = False):
        h = leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2), update_stats), 0.2)
        features = [h]
        for layer in self.layers:
            if isinstance(layer, GaussianBlur):
                h = layer(h)
            else:
                h = layer(h, update_stats)
                features.append(h)
        logits = self.Conv_1(h, update_stats)
        return (logits.permute(0, 2, 3, 1),
                [f.permute(0, 2, 3, 1) for f in features])


class PatchDiscriminator(_Discriminator):
    """The original PatchGAN: 4×4 stem, strided DiscrResBlocks, 4×4 head."""

    def __init__(self, in_channels: int = 3, hidden_channels: int = 64,
                 n_layers: int = 3, dtype=None):
        super().__init__(in_channels, hidden_channels, n_layers, 4, blur=False,
                         strided=True, dtype=dtype)


class VQGANPlusPatchDiscriminator(_Discriminator):
    """3×3 stem, GaussianBlur before each strided block, 3×3 head."""

    def __init__(self, in_channels: int = 3, hidden_channels: int = 64,
                 n_layers: int = 3, dtype=None):
        super().__init__(in_channels, hidden_channels, n_layers, 3, blur=True,
                         strided=True, dtype=dtype)


class VQGANPlusDiscriminator(_Discriminator):
    """The full VQGAN+ discriminator: base 128, stride-1 blocks, spatial
    downsampling only by the stride-2 GaussianBlur before each non-final
    block."""

    def __init__(self, in_channels: int = 3, base_channels: int = 128,
                 n_layers: int = 3, dtype=None):
        super().__init__(in_channels, base_channels, n_layers, 3, blur=True,
                         strided=False, dtype=dtype)


def init_discriminator(disc: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init of the weights and of the power-iteration vectors."""
    return init_params(disc, generator)


def make_disc_apply(disc: nn.Module, update_stats: bool = False):
    """``disc_apply(x) -> (logits, features)``; with ``update_stats`` every
    call advances the stored power iteration by one step."""
    def apply_fn(x):
        return disc(x, update_stats=update_stats)
    return apply_fn
