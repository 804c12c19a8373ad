"""Stable-Diffusion VAE (AutoencoderKL), PyTorch port of
``flocoder_tpu/models/sd_vae.py``.

The architecture of ``stabilityai/sd-vae-ft-mse``: a 128→512-channel
encoder of four stages of two resnets (a stride-2 downsample after each but
the last), a mid resnet–attention–resnet, an 8-channel moment head and a
1×1 ``quant_conv``; a mirrored decoder with three resnets a stage and a
nearest 2× upsample + 3×3 conv between stages. Latents are H/8 × W/8 × 4.
``SDVAE.encode`` returns the posterior mean (no 0.18215 scaling), as the
reference's wrapper does.

Public methods take and return NHWC like the JAX package; the modules run
NCHW inside. Submodules carry linen's auto-names (``Conv_0``, ``_Resnet_3``,
``_Attn_0``, ``GroupNorm_0``, ``Dense_2``), so the JAX tree
``{"encoder": {"params": …}, "decoder": {"params": …}}`` maps onto the
``state_dict`` key for key (``training.checkpoint.SDVAE_PREFIXES``).

Weights: ``load_sd_vae_weights`` reads the converted flat npz the JAX
package reads (HWIO kernels) strictly, and raises when it does not fit.
``convert_sd_vae_state_dict`` maps a diffusers ``AutoencoderKL`` state dict
onto this module's ``state_dict``. Fetching that checkpoint needs diffusers
and the network and is not ported; without a weights file the codec runs
from a seeded random init.

``dtype`` is the compute dtype, with flax's ``dtype=`` semantics
(``layers``): fp32 parameters, convolutions and projections in ``dtype``,
GroupNorm statistics and attention logits in fp32. ``quant_encode`` /
``quant_decode`` make the convolutions the JAX package routes to its W8A8
``QuantConv`` int8 (``ops/quant.py``; those under 32 channels stay plain);
the attention block and the decoder's output head stay in ``dtype``.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import conv_or_quant
from .codecs import _attend, gn_groups
from .layers import Scope, group_norm, init_params, silu

__all__ = ["SDVAE", "SDVAEEncoder", "SDVAEDecoder", "load_sd_vae_weights",
           "convert_sd_vae_state_dict", "SD_VAE_WEIGHTS"]

_CH = (128, 256, 512, 512)
_EPS = 1e-6          # every GroupNorm of the SD VAE
SD_VAE_WEIGHTS = "weights/sd_vae_ft_mse.npz"


def _gn(channels: int, dtype=None) -> nn.GroupNorm:
    return group_norm(gn_groups(32, channels), channels, _EPS, dtype)


class _Resnet(nn.Module):
    """GN → SiLU → 3×3 → GN → SiLU → 3×3, plus a 1×1 shortcut when the
    width changes."""

    def __init__(self, in_ch: int, out_ch: int, dtype=None, quant: bool = False):
        super().__init__()
        s = Scope(self)
        s.add("GroupNorm", _gn(in_ch, dtype))
        s.add("Conv", conv_or_quant(quant, in_ch, out_ch, 3, dtype=dtype))
        s.add("GroupNorm", _gn(out_ch, dtype))
        s.add("Conv", conv_or_quant(quant, out_ch, out_ch, 3, dtype=dtype))
        if in_ch != out_ch:
            s.add("Conv", conv_or_quant(quant, in_ch, out_ch, 1, dtype=dtype))

    def forward(self, x):
        h = self.Conv_0(silu(self.GroupNorm_0(x)))
        h = self.Conv_1(silu(self.GroupNorm_1(h)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class _Attn(nn.Module):
    """Single-head self-attention over the pixels: fp32 logits, scale
    c^-0.5, residual output projection."""

    def __init__(self, ch: int, dtype=None):
        super().__init__()
        s = Scope(self)
        s.add("GroupNorm", _gn(ch, dtype))
        for _ in range(4):
            s.dense(ch, ch, dtype=dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x).flatten(2).transpose(1, 2)          # (b, n, c)
        q, k, v = self.Dense_0(h), self.Dense_1(h), self.Dense_2(h)
        out = _attend(q, k, v, c ** -0.5)
        return x + self.Dense_3(out).transpose(1, 2).reshape(b, c, hh, ww)


class SDVAEEncoder(nn.Module):
    """Pixels (NHWC) → the 2·latent_channels moments (NHWC)."""

    def __init__(self, latent_channels: int = 4, channels: tuple = _CH,
                 in_channels: int = 3, dtype=None, quant: bool = False):
        super().__init__()
        ch = tuple(channels)
        s = Scope(self)
        qconv = lambda *a, **kw: s.add("Conv", conv_or_quant(  # noqa: E731
            quant, *a, **kw, dtype=dtype))
        qconv(in_channels, ch[0], 3)
        ops, prev = [], ch[0]
        for i, c in enumerate(ch):
            ops.append(s.add("_Resnet", _Resnet(prev, c, dtype, quant)))
            ops.append(s.add("_Resnet", _Resnet(c, c, dtype, quant)))
            prev = c
            if i < len(ch) - 1:
                # diffusers' downsample: pad (0, 1) on H and W, VALID stride 2
                ops.append(qconv(c, c, 3, 2, padding=0))
        ops.append(s.add("_Resnet", _Resnet(prev, prev, dtype, quant)))
        ops.append(s.add("_Attn", _Attn(prev, dtype)))
        ops.append(s.add("_Resnet", _Resnet(prev, prev, dtype, quant)))
        self.ops = ops
        s.add("GroupNorm", _gn(prev, dtype))
        # conv_out and quant_conv (a list, so that they keep linen's names)
        self.head = [qconv(prev, 2 * latent_channels, 3),
                     qconv(2 * latent_channels, 2 * latent_channels, 1)]

    def forward(self, x):
        h = self.Conv_0(x.permute(0, 3, 1, 2))
        for op in self.ops:
            if isinstance(op, nn.Conv2d):
                h = op(F.pad(h, (0, 1, 0, 1)))
            else:
                h = op(h)
        conv_out, quant_conv = self.head
        h = conv_out(silu(self.GroupNorm_0(h)))
        return quant_conv(h).permute(0, 2, 3, 1)


class SDVAEDecoder(nn.Module):
    """Latents (NHWC) → pixels (NHWC)."""

    def __init__(self, out_channels: int = 3, latent_channels: int = 4,
                 channels: tuple = _CH, dtype=None, quant: bool = False):
        super().__init__()
        ch = tuple(channels)
        s = Scope(self)
        qconv = lambda *a: s.add("Conv", conv_or_quant(quant, *a, dtype=dtype))  # noqa: E731
        qconv(latent_channels, latent_channels, 1)          # post_quant_conv
        qconv(latent_channels, ch[-1], 3)
        ops = [s.add("_Resnet", _Resnet(ch[-1], ch[-1], dtype, quant)),
               s.add("_Attn", _Attn(ch[-1], dtype)),
               s.add("_Resnet", _Resnet(ch[-1], ch[-1], dtype, quant))]
        prev = ch[-1]
        for i, c in enumerate(reversed(ch)):
            for _ in range(3):
                ops.append(s.add("_Resnet", _Resnet(prev, c, dtype, quant)))
                prev = c
            if i < len(ch) - 1:
                ops.append(qconv(c, c, 3))                   # after a 2× upsample
        self.ops = ops
        s.add("GroupNorm", _gn(prev, dtype))
        self.head = [s.conv(prev, out_channels, 3, dtype=dtype)]   # output head: plain

    def forward(self, z):
        h = self.Conv_1(self.Conv_0(z.permute(0, 3, 1, 2)))
        for op in self.ops:
            if isinstance(op, nn.Conv2d):
                # jax.image.resize "nearest" at exactly 2×: index i // 2
                h = op(F.interpolate(h, scale_factor=2, mode="nearest"))
            else:
                h = op(h)
        h = self.head[0](silu(self.GroupNorm_0(h)))
        return h.permute(0, 2, 3, 1)


class SDVAE(nn.Module):
    """The codec interface of ``models/codecs.py``: ``encode`` (posterior
    mean), ``decode``, ``forward`` and ``latent_shape``, NHWC."""

    in_channels = 3

    def __init__(self, image_size: int = 128, latent_channels: int = 4,
                 channels: tuple = _CH, weights_path: str = SD_VAE_WEIGHTS,
                 dtype=torch.float32, quant_decode: bool = False,
                 quant_encode: bool = False):
        super().__init__()
        self.image_size = image_size
        self.latent_channels = latent_channels
        self.channels = tuple(channels)
        self.weights_path = weights_path
        self.dtype = dtype
        dt = None if dtype == torch.float32 else dtype     # fp32: the parameters' dtype
        self.encoder = SDVAEEncoder(latent_channels, self.channels, dtype=dt,
                                    quant=quant_encode)
        self.decoder = SDVAEDecoder(3, latent_channels, self.channels, dtype=dt,
                                    quant=quant_decode)

    def init(self, generator: torch.Generator) -> "SDVAE":
        """Seeded random init (``layers.init_params``); returns self."""
        return init_params(self, generator)

    def encode(self, x, **_):
        return self.encoder(x)[..., : self.latent_channels]

    def decode(self, z, **_):
        return self.decoder(z)

    def forward(self, x, **_):
        """Full autoencode: (recon, 0, None, None), the codec contract."""
        return self.decode(self.encode(x)), x.new_zeros(()), None, None

    def latent_shape(self, image_size: int) -> Tuple[int, int, int]:
        s = image_size // 8
        return (s, s, self.latent_channels)


def load_sd_vae_weights(codec: SDVAE, path: str = SD_VAE_WEIGHTS) -> bool:
    """Load the converted flat npz at ``path`` (``encoder/params/…``,
    ``decoder/params/…``, flax layouts) into ``codec`` strictly. Returns
    False when there is no such file; a file that does not fit raises."""
    from ..training.checkpoint import SDVAE_PREFIXES, load_jax_flat
    if not path or not os.path.exists(path):
        return False
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    load_jax_flat(codec, flat, SDVAE_PREFIXES)
    return True


def convert_sd_vae_state_dict(sd: dict) -> dict:
    """Map a diffusers ``AutoencoderKL`` state dict (keys like
    ``encoder.down_blocks.0.resnets.0.conv1.weight``, OIHW conv weights;
    numpy arrays or tensors) onto ``SDVAE``'s ``state_dict`` keys. Both
    sides are torch layouts, so only the names change; an attention
    projection stored as a 1×1 conv (older diffusers) becomes a Linear
    weight. Load the result with ``load_state_dict(..., strict=True)``."""
    out: dict = {}

    def t(a):
        return torch.as_tensor(np.asarray(a))

    def put(path, src, dense=False):
        w = t(sd[f"{src}.weight"])
        out[f"{path}.weight"] = w[:, :, 0, 0] if dense and w.ndim == 4 else w
        out[f"{path}.bias"] = t(sd[f"{src}.bias"])

    def resnet(path, src):
        put(f"{path}.GroupNorm_0", f"{src}.norm1")
        put(f"{path}.Conv_0", f"{src}.conv1")
        put(f"{path}.GroupNorm_1", f"{src}.norm2")
        put(f"{path}.Conv_1", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            put(f"{path}.Conv_2", f"{src}.conv_shortcut")

    def attn(path, src):
        put(f"{path}.GroupNorm_0", f"{src}.group_norm")
        for i, name in enumerate(("to_q", "to_k", "to_v", "to_out.0")):
            put(f"{path}.Dense_{i}", f"{src}.{name}", dense=True)

    def mid(side, r0):
        resnet(f"{side}._Resnet_{r0}", f"{side}.mid_block.resnets.0")
        attn(f"{side}._Attn_0", f"{side}.mid_block.attentions.0")
        resnet(f"{side}._Resnet_{r0 + 1}", f"{side}.mid_block.resnets.1")

    n_blocks = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("encoder.down_blocks."))
    # encoder: Conv_0 conv_in, Conv_1.. the downsamplers, then conv_out and
    # quant_conv; _Resnet_0.. the down blocks' resnets, then the mid block's
    put("encoder.Conv_0", "encoder.conv_in")
    res = 0
    for blk in range(n_blocks):
        for r in range(2):
            resnet(f"encoder._Resnet_{res}", f"encoder.down_blocks.{blk}.resnets.{r}")
            res += 1
        if blk < n_blocks - 1:
            put(f"encoder.Conv_{blk + 1}", f"encoder.down_blocks.{blk}.downsamplers.0.conv")
    mid("encoder", res)
    put("encoder.GroupNorm_0", "encoder.conv_norm_out")
    put(f"encoder.Conv_{n_blocks}", "encoder.conv_out")
    put(f"encoder.Conv_{n_blocks + 1}", "quant_conv")
    # decoder: Conv_0 post_quant_conv, Conv_1 conv_in, Conv_2.. the
    # upsamplers, then conv_out; _Resnet_0, _1 the mid block's, then the up
    # blocks' three each
    put("decoder.Conv_0", "post_quant_conv")
    put("decoder.Conv_1", "decoder.conv_in")
    mid("decoder", 0)
    res = 2
    for blk in range(n_blocks):
        for r in range(3):
            resnet(f"decoder._Resnet_{res}", f"decoder.up_blocks.{blk}.resnets.{r}")
            res += 1
        if blk < n_blocks - 1:
            put(f"decoder.Conv_{blk + 2}", f"decoder.up_blocks.{blk}.upsamplers.0.conv")
    put("decoder.GroupNorm_0", "decoder.conv_norm_out")
    put(f"decoder.Conv_{n_blocks + 1}", "decoder.conv_out")
    return out
