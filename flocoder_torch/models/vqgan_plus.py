"""The VQGAN+ codec, PyTorch port of ``flocoder_tpu/models/vqgan_plus.py``:
a purely convolutional encoder and decoder (two residual blocks a scale, no
attention) around the same RVQ bottleneck as the VQVAE.

NHWC in and out like the JAX package; NCHW inside. Submodules carry linen's
names (``Conv_0``, ``GroupNorm_1``, ``VQGANPlusResidualBlock_3``, ...), so the
JAX tree (``encoder/params/…``, ``decoder/params/…``, ``vq/…``) maps onto
the ``state_dict`` key for key (``training/checkpoint.py``,
``VQVAE_PREFIXES``). No kernel of the port runs here: the codec has no
attention and no fused tail, so ``preencoding.fused_vq`` takes the unfused
RVQ on it, as in the JAX package.

Compute dtype as the VQVAE's (``layers.Conv``, ``layers.GroupNorm``,
``layers.silu``: fp32 parameters, bf16 arithmetic for a bf16 codec).
``quant_encode`` / ``quant_decode`` put ``ops/quant.py``'s W8A8
``QuantConv`` on exactly the convolutions the JAX module routes to its
``QuantConv``; the encoder's compression head (``Conv_2``, ``Conv_3``) and
the decoder's output ``Conv_1`` stay in the compute dtype. The parameter
tree is the same either way.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import conv_or_quant
from ..ops.rvq import RVQState, rvq_apply
from .codecs import gn_groups
from .layers import Scope, conv, group_norm, init_params, silu

__all__ = ["VQGANPlus", "VQGANPlusEncoder", "VQGANPlusDecoder",
           "VQGANPlusResidualBlock", "multipliers_for", "upsample_nearest_2x"]


def multipliers_for(num_downsamples: int) -> Tuple[int, ...]:
    """The channel multipliers of each scale for ``num_downsamples``."""
    if num_downsamples == 3:
        return (1, 2, 4)
    if num_downsamples == 4:
        return (1, 1, 2, 4)
    if num_downsamples == 5:
        return (1, 1, 2, 2, 4)
    return tuple([1] + [2 ** min(i, 2) for i in range(num_downsamples - 1)])


def upsample_nearest_2x(h: torch.Tensor) -> torch.Tensor:
    """NCHW nearest-neighbour 2× upsampling: each pixel repeated 2×2, which
    is what ``jax.image.resize(..., "nearest")`` gives at exactly twice the
    size."""
    return F.interpolate(h, scale_factor=2, mode="nearest")


class VQGANPlusResidualBlock(nn.Module):
    """conv3×3(stride)→GN→SiLU→conv3×3→GN → +skip (1×1(stride)→GN where the
    shape changes) → SiLU."""

    def __init__(self, c_in: int, out_channels: int, stride: int = 1, dtype=None,
                 quant: bool = False):
        super().__init__()
        g = gn_groups(8, out_channels)
        self.Conv_0 = conv_or_quant(quant, c_in, out_channels, 3, stride, dtype=dtype)
        self.GroupNorm_0 = group_norm(g, out_channels, 1e-5, dtype)
        self.Conv_1 = conv_or_quant(quant, out_channels, out_channels, 3, dtype=dtype)
        self.GroupNorm_1 = group_norm(g, out_channels, 1e-5, dtype)
        self.project = stride != 1 or c_in != out_channels
        if self.project:
            self.Conv_2 = conv_or_quant(quant, c_in, out_channels, 1, stride, dtype=dtype)
            self.GroupNorm_2 = group_norm(g, out_channels, 1e-5, dtype)

    def forward(self, x):
        h = silu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if self.project:
            x = self.GroupNorm_2(self.Conv_2(x))
        return silu(h + x)


class VQGANPlusEncoder(nn.Module):
    """3×3 stem; per scale a stride-2 and a stride-1 residual block; 3×3 to
    ``latent_channels``→GN→SiLU; then the 1×1→GN→SiLU→3×3 compression to
    ``vq_embedding_dim``. NHWC in and out."""

    def __init__(self, in_channels: int = 3, base_channels: int = 128,
                 channel_multipliers: Sequence[int] = (1, 2, 4), latent_channels: int = 256,
                 vq_embedding_dim: int = 8, dtype=None, quant: bool = False):
        super().__init__()
        s = Scope(self)
        s.add("Conv", conv_or_quant(quant, in_channels, base_channels, 3, dtype=dtype))
        blocks, c = [], base_channels
        for mult in channel_multipliers:
            ch = base_channels * mult
            blocks.append(s.add("VQGANPlusResidualBlock",
                                VQGANPlusResidualBlock(c, ch, 2, dtype, quant)))
            blocks.append(s.add("VQGANPlusResidualBlock",
                                VQGANPlusResidualBlock(ch, ch, 1, dtype, quant)))
            c = ch
        self.blocks = blocks
        s.add("Conv", conv_or_quant(quant, c, latent_channels, 3, dtype=dtype))
        s.add("GroupNorm", group_norm(gn_groups(8, latent_channels), latent_channels,
                                      1e-5, dtype))
        s.conv(latent_channels, vq_embedding_dim, 1, dtype=dtype)
        s.add("GroupNorm", group_norm(gn_groups(8, vq_embedding_dim), vq_embedding_dim,
                                      1e-5, dtype))
        s.conv(vq_embedding_dim, vq_embedding_dim, 3, dtype=dtype)

    def forward(self, x):
        h = self.Conv_0(x.permute(0, 3, 1, 2))
        for blk in self.blocks:
            h = blk(h)
        h = silu(self.GroupNorm_0(self.Conv_1(h)))
        h = self.Conv_3(silu(self.GroupNorm_1(self.Conv_2(h))))
        return h.permute(0, 2, 3, 1)


class VQGANPlusDecoder(nn.Module):
    """3×3 from the latents→GN→SiLU at the widest scale; per remaining scale
    a nearest 2× upsampling and two residual blocks; a last 2× upsampling
    and the 3×3 output convolution. NHWC in and out."""

    def __init__(self, out_channels: int = 3, base_channels: int = 128,
                 channel_multipliers: Sequence[int] = (1, 2, 4), vq_embedding_dim: int = 8,
                 dtype=None, quant: bool = False):
        super().__init__()
        s = Scope(self)
        rev = list(reversed(channel_multipliers))
        c = base_channels * rev[0]
        s.add("Conv", conv_or_quant(quant, vq_embedding_dim, c, 3, dtype=dtype))
        s.add("GroupNorm", group_norm(gn_groups(8, c), c, 1e-5, dtype))
        stages = []
        for mult in rev[1:]:
            ch = base_channels * mult
            stages.append((s.add("VQGANPlusResidualBlock",
                                 VQGANPlusResidualBlock(c, ch, 1, dtype, quant)),
                           s.add("VQGANPlusResidualBlock",
                                 VQGANPlusResidualBlock(ch, ch, 1, dtype, quant))))
            c = ch
        self.stages = stages
        s.conv(c, out_channels, 3, dtype=dtype)

    def forward(self, z):
        h = silu(self.GroupNorm_0(self.Conv_0(z.permute(0, 3, 1, 2))))
        for first, second in self.stages:
            h = second(first(upsample_nearest_2x(h)))
        return self.Conv_1(upsample_nearest_2x(h)).permute(0, 2, 3, 1)


class VQGANPlus(nn.Module):
    """VQGAN+ codec: encoder + RVQ bottleneck + decoder, with the codec
    interface of ``models.codecs.VQVAE`` (``init``, ``encode``,
    ``quantize``, ``decode``, ``forward``, ``latent_shape``). The codec has
    no dropout or noise: a training forward's randomness is the RVQ
    update's alone."""

    def __init__(self, in_channels=3, hidden_channels=128, num_downsamples=4,
                 vq_num_embeddings=1024, internal_dim=256, codebook_levels=4,
                 vq_embedding_dim=8, commitment_weight=0.25, dtype=torch.float32,
                 quant_decode=False, quant_encode=False):
        super().__init__()
        self.in_channels = in_channels
        self.num_downsamples = num_downsamples
        self.codebook_levels = codebook_levels
        self.vq_num_embeddings = vq_num_embeddings
        self.vq_embedding_dim = vq_embedding_dim
        self.commitment_weight = commitment_weight
        self.dtype = dtype
        dt = None if dtype == torch.float32 else dtype     # fp32: the parameters' dtype
        mults = multipliers_for(num_downsamples)
        self.encoder = VQGANPlusEncoder(in_channels, hidden_channels, mults, internal_dim,
                                        vq_embedding_dim, dt, quant_encode)
        self.decoder = VQGANPlusDecoder(in_channels, hidden_channels, mults,
                                        vq_embedding_dim, dt, quant_decode)
        self.vq = RVQState(codebook_levels, vq_num_embeddings, vq_embedding_dim)

    def init(self, generator: torch.Generator) -> "VQGANPlus":
        """Seeded random init (``layers.init_params``); returns self."""
        return init_params(self, generator)

    def encode(self, x):
        return self.encoder(x)

    def quantize(self, z, train: bool = False, generator=None, **draws):
        """NHWC latents → (z_q, indices (B,H,W,L), commit_loss, new_vq)
        (``ops.rvq.rvq_apply``; ``draws`` are its injected
        ``kmeans_seeds``/``reseed_picks``)."""
        b, h, w, c = z.shape
        z_q, idx, loss, new_vq = rvq_apply(
            self.vq, z.reshape(-1, c), train=train, generator=generator,
            commitment_weight=self.commitment_weight, **draws)
        return z_q.reshape(b, h, w, c), idx.reshape(b, h, w, -1), loss, new_vq

    def decode(self, z_q):
        return self.decoder(z_q)

    def forward(self, x, train: bool = False, generator=None, deterministic: bool = False,
                **draws):
        """Full autoencode: (recon, commit_loss, indices, new_vq). The
        training steps' ``deterministic`` is accepted and changes nothing
        (the codec has neither dropout nor noise)."""
        z = self.encode(x)
        z_q, idx, commit_loss, new_vq = self.quantize(z, train=train, generator=generator,
                                                      **draws)
        return self.decode(z_q), commit_loss, idx, new_vq

    def latent_shape(self, image_size: int) -> Tuple[int, int, int]:
        s = image_size // (2 ** self.num_downsamples)
        return (s, s, self.vq_embedding_dim)
