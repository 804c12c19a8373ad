"""Image codecs, PyTorch port of ``flocoder_tpu/models/codecs.py``: NoOp,
SimpleResize and the VQGAN-style VQVAE encoder/decoder.

Public functions take and return NHWC like the JAX package; the modules run
NCHW inside. Submodule attributes carry linen's auto-names (``Conv_0``,
``GroupNorm_1``, ``EncDecResidualBlock_2``, ...), so the JAX parameter tree
maps onto the ``state_dict`` key for key (``training/checkpoint.py``).
Neighborhood attention goes through ``ops.neighborhood_attention.na2d``:
on the card K1 forward and K2 backward, on the CPU their plain twins.

Training mode (``VQVAE.forward(x, train=True, generator=g)``): dropout in
the encoder's blocks (0.05 / 0.15) and the decoder's first block (0.05),
NoiseInjection at strength 0.05, and the RVQ bottleneck's EMA update. Its
randomness comes from the explicit generator; ``deterministic=True`` turns
dropout and noise off (for parity tests). ``VQVAE.encode_quantize_fused``
runs the compression tail and the RVQ search as one kernel on the card (K3,
``ops/fused_vq.py``). ``setup_codec`` also builds the SD VAE
(``models/sd_vae.py``).

Compute dtype: every block takes ``dtype`` with flax's ``dtype=`` semantics
(``layers.Conv``, ``Dense`` and ``GroupNorm``): fp32 parameters, the
convolutions and projections computed in ``dtype``, GroupNorm's statistics
in fp32. Attention logits stay fp32 and the softmax is cast to ``dtype``.
NATTEN's ``gamma`` is the one parameter held in ``dtype``, as the JAX module
declares it. ``setup_codec`` builds the codec in bf16 when ``codec.bf16``
is set (or ``dtype=`` says so). ``quant_encode`` / ``quant_decode`` route
the convolutions the JAX package routes to its W8A8 ``QuantConv``
(``ops/quant.py``) there; the compression and output heads stay plain.
``setup_codec`` also builds the DAC audio codec (``models/audio_codec.py``,
in bf16 too with ``codec.bf16``) for ``codec.choice=dac`` and the VQGAN+
codec (``models/vqgan_plus.py``) for ``codec.choice=vqgan_plus``.

Ring attention: with ``ring_axis_size`` > 1 (``setup_codec``'s, with
``codec.ring_attention=true``; VQVAE only, as in the JAX package) the
decoder's ``SpatialNonLocalAttention`` runs as the ring over the mesh's
model axis (``parallel/ring_attention.py``), v at full width. No entry point
builds such a codec, in either package; its callers run it on every rank of
the model group.
"""
from __future__ import annotations

import contextlib
import glob
import math
import os
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_vq import fused_compress_tail_vq
from ..ops.neighborhood_attention import na2d
from ..ops.quant import conv_or_quant
from ..ops.rvq import RVQState, rvq_apply
from ..parallel.ring_attention import ring_attention_replicated
from .layers import Dense, Scope, SiLU, conv, group_norm, init_params, silu

__all__ = ["gn_groups", "NoOpAE", "SimpleResizeAE", "VQVAE", "VQVAEEncoder",
           "VQVAEDecoder", "AttnBlock", "NATTENBlock", "EncDecResidualBlock",
           "NoiseInjection", "SpatialNonLocalAttention", "setup_codec",
           "load_codec_weights", "latest_checkpoint", "codec_checkpoint"]


def gn_groups(proposed: int, channels: int) -> int:
    """Nearest valid GroupNorm group count ≥ proposed that divides channels."""
    if channels % proposed == 0:
        return proposed
    for cand in range(proposed, channels):
        if channels % cand == 0:
            return cand
    return 1


# --------------------------------------------------------------------------
# Trivial codecs
# --------------------------------------------------------------------------

class NoOpAE(nn.Module):
    """Identity codec. Latents are pixels."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels

    def encode(self, x):
        return x

    def decode(self, z):
        return z

    def latent_shape(self, image_size: int) -> Tuple[int, int, int]:
        return (image_size, image_size, self.in_channels)


class SimpleResizeAE(nn.Module):
    """Bilinear-resize pseudo-codec: 'latents' are a resized image; extra
    latent channels are copies of the channel mean; only the first 3
    channels decode."""

    def __init__(self, latent_shape=(32, 32, 3), image_size: int = 128):
        super().__init__()
        # accepts reference-style (C,H,W) lists for recipe compat
        if len(latent_shape) == 3 and latent_shape[0] <= 4 < latent_shape[-1]:
            c, h, w = latent_shape
            latent_shape = (h, w, c)
        self._latent_shape = tuple(latent_shape)
        self.image_size = image_size
        self.in_channels = self._latent_shape[-1]

    @staticmethod
    def _resize(x, size):
        y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                          align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1)

    def encode(self, x):
        h, w, c = self._latent_shape
        small = self._resize(x, (h, w))
        if c == x.shape[-1]:
            return small
        extra = small.mean(dim=-1, keepdim=True).expand(
            *small.shape[:3], c - x.shape[-1])
        return torch.cat([small, extra], dim=-1)

    def decode(self, z):
        z = z[..., : min(3, z.shape[-1])]
        return self._resize(z, (self.image_size, self.image_size))

    def latent_shape(self, image_size: int) -> Tuple[int, int, int]:
        return self._latent_shape


# --------------------------------------------------------------------------
# Building blocks (NCHW inside)
# --------------------------------------------------------------------------

def _tokens(x):
    """(b, c, h, w) → (b, h·w, c), row-major tokens as the JAX reshape."""
    return x.flatten(2).transpose(1, 2)


def _untokens(t, h, w):
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


def _acc(t):
    """At least fp32: attention logits accumulate there (a float64 copy of
    a model stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _attend(q, k, v, scale: float):
    """softmax(q·kᵀ·scale) · v over (b, n, c) tokens: fp32 logits and
    softmax, the weights cast to v's dtype, as flax's
    ``preferred_element_type`` einsum and ``.astype(dtype)``."""
    logits = torch.einsum("bnc,bmc->bnm", _acc(q), _acc(k)) * scale
    return torch.einsum("bnm,bmc->bnc", logits.softmax(dim=-1).to(v.dtype), v)


class AttnBlock(nn.Module):
    """VQGAN-style single-head non-local block: GroupNorm → 1×1 q/k/v →
    softmax attention over all tokens → 1×1 out, residual."""

    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.GroupNorm_0 = group_norm(gn_groups(32, c), c, 1e-6, dtype)
        self.Conv_0 = conv(c, c, 1, dtype=dtype)
        self.Conv_1 = conv(c, c, 1, dtype=dtype)
        self.Conv_2 = conv(c, c, 1, dtype=dtype)
        self.Conv_3 = conv(c, c, 1, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.GroupNorm_0(x)
        q, k, v = (_tokens(m(hn)) for m in (self.Conv_0, self.Conv_1, self.Conv_2))
        return x + self.Conv_3(_untokens(_attend(q, k, v, c ** -0.5), h, w))


class NATTENBlock(nn.Module):
    """Neighborhood-attention block: GroupNorm → qkv projection → k×k
    window attention (``na2d``) → out projection, residual gated by a
    zero-init gamma. ``gamma`` is a parameter in the compute dtype (the
    JAX module declares it so): a bf16 block holds a bf16 gamma, and loading
    an fp32 checkpoint rounds it."""

    def __init__(self, c: int, kernel_size: int = 7, num_heads: int = 8,
                 init_scale: float = 0.02, dtype=None):
        super().__init__()
        self.kernel_size, self.num_heads = kernel_size, num_heads
        self.init_scale = init_scale
        self.GroupNorm_0 = group_norm(gn_groups(8, c), c, 1e-5, dtype)
        self.Dense_0 = Dense(c, 3 * c, bias=False, dtype=dtype)
        self.Dense_1 = Dense(c, c, bias=False, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1, dtype=dtype or torch.float32))

    def init_special_(self, generator):
        for lin in (self.Dense_0, self.Dense_1):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator,
                                         device=generator.device)
                             * self.init_scale)
        self.gamma.zero_()

    def forward(self, x):
        c = x.shape[1]
        xn = self.GroupNorm_0(x).permute(0, 2, 3, 1)          # NHWC
        # q, k, v as three products with row blocks of the fused weight:
        # each comes out contiguous, as the kernel requires, with no copy
        dt = self.Dense_0.compute_dtype or self.Dense_0.weight.dtype
        w = self.Dense_0.weight.to(dt)
        q, k, v = (F.linear(xn.to(dt), w[i * c:(i + 1) * c]) for i in range(3))
        out = na2d(q, k, v, kernel_size=self.kernel_size, heads=self.num_heads)
        out = self.Dense_1(out) * self.gamma
        return x + out.permute(0, 3, 1, 2)


def _dropout(x, rate: float, generator):
    """flax ``nn.Dropout``: keep with probability 1 − rate and scale by
    1/(1 − rate); the identity without a generator (deterministic)."""
    if generator is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class EncDecResidualBlock(nn.Module):
    """Strided residual block with optional attention:
    conv3×3(stride)→GN→SiLU→dropout→[attn]→conv3×3→GN → +skip(1×1 proj if
    needed) → SiLU → dropout. Dropout runs only when a generator is given.
    ``quant``: the three convolutions are W8A8 (``ops/quant.py``)."""

    def __init__(self, c_in: int, out_channels: int, stride: int = 1,
                 attention=None, dropout_rate: float = 0.0, dtype=None,
                 quant: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        g = gn_groups(8, out_channels)
        self.Conv_0 = conv_or_quant(quant, c_in, out_channels, 3, stride, dtype=dtype)
        self.GroupNorm_0 = group_norm(g, out_channels, 1e-5, dtype)
        if attention == "natten":
            self.NATTENBlock_0 = NATTENBlock(out_channels, dtype=dtype)
        elif attention == "full":
            self.AttnBlock_0 = AttnBlock(out_channels, dtype)
        self.attn = ({"natten": "NATTENBlock_0", "full": "AttnBlock_0"}
                     .get(attention))
        self.Conv_1 = conv_or_quant(quant, out_channels, out_channels, 3, dtype=dtype)
        self.GroupNorm_1 = group_norm(g, out_channels, 1e-5, dtype)
        self.project = stride != 1 or c_in != out_channels
        if self.project:
            self.Conv_2 = conv_or_quant(quant, c_in, out_channels, 1, stride, dtype=dtype)
            self.GroupNorm_2 = group_norm(g, out_channels, 1e-5, dtype)

    def forward(self, x, generator=None):
        h = silu(self.GroupNorm_0(self.Conv_0(x)))
        h = _dropout(h, self.dropout_rate, generator)
        if self.attn is not None:
            h = getattr(self, self.attn)(h)
        h = self.GroupNorm_1(self.Conv_1(h))
        if self.project:
            x = self.GroupNorm_2(self.Conv_2(x))
        return _dropout(silu(h + x), self.dropout_rate, generator)


class NoiseInjection(nn.Module):
    """Learned spatially-varying noise, x + s·(noise·scale(x) + bias(x)),
    with zero-init 1×1 convs; the identity at strength 0 (serving)."""

    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.Conv_0 = conv(c, c, 1, dtype=dtype)
        self.Conv_1 = conv(c, c, 1, dtype=dtype)

    def init_special_(self, generator):
        for m in (self.Conv_0, self.Conv_1):
            m.weight.zero_()
            m.bias.zero_()

    def forward(self, x, strength: float = 0.0, generator=None):
        if strength == 0.0:
            return x
        # in x's dtype, as the JAX module draws it: fp32 noise would promote
        # a bf16 block's output to fp32
        noise = torch.randn(x.shape, generator=generator,
                            device=generator.device).to(x)
        return x + strength * (noise * self.Conv_0(x) + self.Conv_1(x))


def _rope_1d(x: torch.Tensor, max_log: float = math.log(10000.0)) -> torch.Tensor:
    """1-D RoPE over flattened spatial tokens (b, n, c), computed in x's
    dtype; the constants are rounded to it first, as JAX does with a Python
    scalar (a weak type takes the array's dtype)."""
    b, n, c = x.shape
    c_pad = c + (c % 2)
    if c_pad != c:
        x = F.pad(x, (0, 1))
    half = c_pad // 2
    const = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    pos = torch.arange(n, device=x.device).to(x.dtype)[:, None]
    inv_freq = torch.exp(-torch.arange(half, device=x.device).to(x.dtype)
                         * const(max_log) / const(half))
    ang = pos * inv_freq[None, :]
    sin, cos = torch.sin(ang)[None], torch.cos(ang)[None]
    x_even, x_odd = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x_even * cos - x_odd * sin,
                       x_odd * cos + x_even * sin], dim=-1).reshape(b, n, c_pad)
    return out[..., :c] if c_pad != c else out


class SpatialNonLocalAttention(nn.Module):
    """Full attention over flattened H·W tokens with 1-D RoPE on q/k;
    zero-init output projection so the block starts as identity; residual.
    With ``ring_axis_size`` > 1, one head of the ring over the model axis
    (q and k of width c/2, v of width c)."""

    def __init__(self, c: int, reduction_factor: int = 2, dtype=None,
                 ring_axis_size: int = 1):
        super().__init__()
        self.ring_axis_size = ring_axis_size
        rd = max(1, c // reduction_factor)
        self.Conv_0 = conv(c, rd, 1, dtype=dtype)
        self.Conv_1 = conv(c, rd, 1, dtype=dtype)
        self.Conv_2 = conv(c, c, 1, dtype=dtype)
        self.Conv_3 = conv(c, c, 1, dtype=dtype)

    def init_special_(self, generator):
        # flax variance_scaling(1e-4, "fan_avg", "uniform") on q/k/v
        for m in (self.Conv_0, self.Conv_1, self.Conv_2):
            fan_avg = (m.in_channels + m.out_channels) / 2
            lim = math.sqrt(3e-4 / fan_avg)
            u = torch.rand(m.weight.shape, generator=generator,
                           device=generator.device)
            m.weight.copy_((u * 2 - 1) * lim)
        self.Conv_3.weight.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        q = _rope_1d(_tokens(self.Conv_0(x)))
        k = _rope_1d(_tokens(self.Conv_1(x)))
        v = _tokens(self.Conv_2(x))
        if self.ring_axis_size > 1:
            out = ring_attention_replicated(q[:, :, None], k[:, :, None], v[:, :, None],
                                            self.ring_axis_size)[:, :, 0]
        else:
            out = _attend(q, k, v, q.shape[-1] ** -0.5)
        return x + self.Conv_3(_untokens(out, h, w))


# --------------------------------------------------------------------------
# VQVAE encoder / decoder stacks
# --------------------------------------------------------------------------

class VQVAEEncoder(nn.Module):
    """Per scale a stride-2 block plus a stride-1 block, neighborhood
    attention on the last two scales; then a block to internal_dim, a 1×1
    and the 1×1→GN→SiLU→3×3 compression to vq_embedding_dim.
    NHWC in and out. ``quant``: the blocks' convolutions and the 1×1 are
    W8A8; the compression head stays in ``dtype``."""

    def __init__(self, in_channels: int = 3, hidden_channels: int = 256,
                 num_downsamples: int = 3, internal_dim: int = 128,
                 vq_embedding_dim: int = 4, use_attention: bool = True,
                 dtype=None, quant: bool = False):
        super().__init__()
        s = Scope(self)
        blocks, c, attention = [], in_channels, None
        kw = dict(dtype=dtype, quant=quant)
        for i in range(num_downsamples):
            out_ch = hidden_channels * (2 ** i)
            attention = ("natten" if use_attention and i >= num_downsamples - 2
                         else None)
            blocks.append(s.add("EncDecResidualBlock", EncDecResidualBlock(
                c, out_ch, stride=2, attention=attention, dropout_rate=0.05, **kw)))
            blocks.append(s.add("EncDecResidualBlock", EncDecResidualBlock(
                out_ch, out_ch, stride=1, attention=attention,
                dropout_rate=0.15, **kw)))
            c = out_ch
        blocks.append(s.add("EncDecResidualBlock", EncDecResidualBlock(
            c, internal_dim, stride=1, attention=attention, dropout_rate=0.15, **kw)))
        self.blocks = blocks
        s.add("Conv", conv_or_quant(quant, internal_dim, internal_dim, 1, dtype=dtype))
        s.conv(internal_dim, vq_embedding_dim, 1, dtype=dtype)
        s.add("GroupNorm", group_norm(gn_groups(2, vq_embedding_dim), vq_embedding_dim,
                                      1e-5, dtype))
        s.conv(vq_embedding_dim, vq_embedding_dim, 3, dtype=dtype)

    def forward(self, x, generator=None, stop_before_compress: bool = False):
        """``generator``: dropout's randomness; none means deterministic.
        ``stop_before_compress`` returns the activations after ``Conv_0``,
        the hand-off point of the fused tail (``VQVAE.encode_quantize_fused``),
        as an NHWC view of the NCHW tensor, without a copy."""
        h = x.permute(0, 3, 1, 2)
        for blk in self.blocks:
            h = blk(h, generator)
        h = self.Conv_0(h)
        if stop_before_compress:
            return h.permute(0, 2, 3, 1)
        h = self.Conv_2(silu(self.GroupNorm_0(self.Conv_1(h))))
        return h.permute(0, 2, 3, 1)


class VQVAEDecoder(nn.Module):
    """RoPE non-local attention at latent resolution, 1×1 expansion, then per
    scale conv→SiLU→PixelShuffle2× → NoiseInjection → two residual blocks
    (neighborhood attention in the first at the coarsest upsampled scale);
    3×3 head to pixels. NHWC in and out. ``quant``: the expansion, the
    per-scale and the residual blocks' convolutions are W8A8; attention,
    NoiseInjection and the output head stay in ``dtype``."""

    def __init__(self, in_channels: int = 3, hidden_channels: int = 256,
                 num_downsamples: int = 3, internal_dim: int = 128,
                 vq_embedding_dim: int = 4, decoder_nonlocal: bool = True,
                 use_attention: bool = True, dtype=None, quant: bool = False,
                 ring_axis_size: int = 1):
        super().__init__()
        s = Scope(self)
        noise = lambda c: s.add("NoiseInjection", NoiseInjection(c, dtype))  # noqa: E731
        block = lambda *a, **kw: s.add("EncDecResidualBlock",  # noqa: E731
                                       EncDecResidualBlock(*a, **kw, dtype=dtype,
                                                           quant=quant))
        qconv = lambda *a: s.add("Conv", conv_or_quant(quant, *a, dtype=dtype))  # noqa: E731
        ops = []
        if decoder_nonlocal:
            ops.append(s.add("SpatialNonLocalAttention",
                             SpatialNonLocalAttention(vq_embedding_dim, dtype=dtype,
                                                      ring_axis_size=ring_axis_size)))
        cur = hidden_channels * (2 ** (num_downsamples - 1))
        ops += [qconv(vq_embedding_dim, internal_dim, 1),
                s.add("GroupNorm", group_norm(gn_groups(vq_embedding_dim, internal_dim),
                                              internal_dim, 1e-5, dtype)),
                SiLU(),
                qconv(internal_dim, cur, 1),
                noise(cur)]
        first_attn = "full" if decoder_nonlocal else (
            "natten" if use_attention else None)
        ops.append(block(cur, cur, attention=first_attn, dropout_rate=0.05))
        for i in range(num_downsamples - 1, -1, -1):
            out_ch = hidden_channels * (2 ** max(0, i - 1))
            if i == 0:
                out_ch = hidden_channels
            attn = ("natten" if use_attention and i > num_downsamples - 2
                    else None)
            ops += [qconv(cur, cur * 4, 3), SiLU(), nn.PixelShuffle(2),
                    noise(cur),
                    block(cur, out_ch, attention=attn),
                    noise(out_ch),
                    block(out_ch, out_ch, attention=None)]
            cur = out_ch
        ops += [noise(cur), qconv(cur, 64, 3), SiLU(), noise(64),
                s.conv(64, in_channels, 3, dtype=dtype)]
        self.ops = ops

    def forward(self, z, generator=None, noise_strength: float = 0.0):
        """``generator``: the randomness of dropout and of NoiseInjection at
        ``noise_strength``; none (with strength 0) means deterministic."""
        h = z.permute(0, 3, 1, 2)
        for op in self.ops:
            if isinstance(op, EncDecResidualBlock):
                h = op(h, generator)
            elif isinstance(op, NoiseInjection):
                h = op(h, noise_strength, generator)
            else:
                h = op(h)
        return h.permute(0, 2, 3, 1)


class VQVAE(nn.Module):
    """VQGAN codec: encoder + RVQ bottleneck + decoder. ``encode``/``decode``
    are NHWC; the JAX checkpoint's ``encoder/params/…``, ``decoder/params/…``
    and ``vq/…`` map onto ``encoder.…``, ``decoder.…`` and ``vq.…``."""

    def __init__(self, in_channels=3, hidden_channels=256, num_downsamples=3,
                 vq_num_embeddings=512, internal_dim=256, codebook_levels=3,
                 vq_embedding_dim=4, commitment_weight=0.25, use_attention=True,
                 decoder_nonlocal=True, dtype=torch.float32, quant_decode=False,
                 quant_encode=False, ring_axis_size=1):
        super().__init__()
        self.in_channels = in_channels
        self.num_downsamples = num_downsamples
        self.vq_embedding_dim = vq_embedding_dim
        self.commitment_weight = commitment_weight
        self.dtype = dtype
        dt = None if dtype == torch.float32 else dtype     # fp32: the parameters' dtype
        self.encoder = VQVAEEncoder(in_channels, hidden_channels,
                                    num_downsamples, internal_dim,
                                    vq_embedding_dim, use_attention, dt, quant_encode)
        self.decoder = VQVAEDecoder(in_channels, hidden_channels,
                                    num_downsamples, internal_dim,
                                    vq_embedding_dim, decoder_nonlocal,
                                    use_attention, dt, quant_decode, ring_axis_size)
        self.vq = RVQState(codebook_levels, vq_num_embeddings, vq_embedding_dim)

    def init(self, generator: torch.Generator) -> "VQVAE":
        """Seeded random init (``layers.init_params``); returns self."""
        return init_params(self, generator)

    def encode(self, x, generator=None):
        return self.encoder(x, generator)

    def quantize(self, z, train: bool = False, generator=None, **draws):
        """NHWC latents → (z_q, indices (B,H,W,L), commit_loss, new_vq), the
        new RVQ state as tensors (``ops.rvq.rvq_apply``; ``draws`` are its
        injected ``kmeans_seeds``/``reseed_picks``)."""
        b, h, w, c = z.shape
        z_q, idx, loss, new_vq = rvq_apply(
            self.vq, z.reshape(-1, c), train=train, generator=generator,
            commitment_weight=self.commitment_weight, **draws)
        return z_q.reshape(b, h, w, c), idx.reshape(b, h, w, -1), loss, new_vq

    def encode_quantize_fused(self, x):
        """Inference encode + quantize with the compression tail (1×1 →
        GroupNorm → SiLU → 3×3) and the RVQ search fused: one launch of K3
        on the card, its plain twin on the CPU (``ops/fused_vq.py``). A bf16
        encoder hands over its bf16 activations, which the tail widens to
        fp32, as the JAX method does; the tail's weights and codebooks are
        fp32 and so is its arithmetic, so the picks agree with an fp64
        oracle up to ties inside fp32 rounding; z_q comes back in the
        activations' dtype. Unlike the JAX method there is no ``tile_b``:
        one block per image, and no batch padding. Returns (z_q (B,h,w,D),
        indices (B,h,w,L) int32)."""
        enc = self.encoder
        h = enc(x, stop_before_compress=True)
        return fused_compress_tail_vq(
            h, enc.Conv_1.weight, enc.Conv_1.bias, enc.GroupNorm_0.weight,
            enc.GroupNorm_0.bias, enc.Conv_2.weight, enc.Conv_2.bias,
            self.vq.codebooks, groups=gn_groups(2, self.vq_embedding_dim),
            eps=enc.GroupNorm_0.eps)

    def decode(self, z_q, generator=None, noise_strength: float = 0.0):
        return self.decoder(z_q, generator, noise_strength)

    def forward(self, x, train: bool = False, generator=None,
                deterministic: bool = False, noise_strength=None, **draws):
        """Full autoencode. Returns (recon, commit_loss, indices, new_vq).
        With ``train``: dropout and NoiseInjection (strength 0.05) draw from
        ``generator`` unless ``deterministic``, and the RVQ state update
        draws from it too (or takes ``draws``)."""
        rand = generator if train and not deterministic else None
        if noise_strength is None:
            noise_strength = 0.05 if rand is not None else 0.0
        z = self.encode(x, rand)
        z_q, idx, commit_loss, new_vq = self.quantize(
            z, train=train, generator=generator, **draws)
        recon = self.decode(z_q, rand, noise_strength)
        return recon, commit_loss, idx, new_vq

    def latent_shape(self, image_size: int) -> Tuple[int, int, int]:
        s = image_size // (2 ** self.num_downsamples)
        return (s, s, self.vq_embedding_dim)


# --------------------------------------------------------------------------
# Factory
# --------------------------------------------------------------------------

def setup_codec(config, device=None, dtype=None, quant_decode=None,
                ring_axis_size: int = 1) -> nn.Module:
    """Build a codec from ``config.codec.choice`` ∈ {noop, resize, vqgan,
    vqgan_plus, sd, dac} on ``device``. Weights are the caller's concern
    (``load_codec_weights``). Compute dtype: ``dtype`` when given, else
    bf16 if and only if ``codec.bf16`` is set (never because of
    ``flow.bf16``). ``codec.quant_encode`` / ``codec.quant_decode`` =
    ``int8`` build the W8A8 encoder / decoder (``ops/quant.py``);
    ``quant_decode`` (a bool), when given, overrides the latter, as serving's
    ``+quant`` does (``dac`` has no W8A8 path, as in the JAX package).
    ``ring_axis_size`` > 1 with ``codec.ring_attention=true`` builds the
    VQVAE whose decoder's non-local attention is the ring over the mesh's
    model axis (its callers run it on every model rank). Other choices
    raise."""
    from ..config import ldcfg
    choice = config.codec.choice if "codec" in config else "noop"
    image_size = ldcfg(config, "image_size", 128)
    in_channels = ldcfg(config, "in_channels", 3)
    if dtype is None:
        bf16 = "codec" in config and bool(config.codec.get("bf16", False))
        dtype = torch.bfloat16 if bf16 else torch.float32
    if quant_decode is None:
        quant_decode = str(ldcfg(config, "quant_decode", "")) == "int8"
    quant_encode = str(ldcfg(config, "quant_encode", "")) == "int8"
    # built on ``device``: the default init of its parameters, which every
    # caller overwrites (``init_params``, a checkpoint), runs there, not on
    # the host (about a second for the VQGAN's 153 M parameters)
    with torch.device(device) if device is not None else contextlib.nullcontext():
        if choice == "noop":
            codec = NoOpAE(in_channels=in_channels)
        elif choice == "resize":
            lat = config.codec.get("latent_shape", [in_channels, 32, 32])
            codec = SimpleResizeAE(latent_shape=tuple(lat),
                                   image_size=config.codec.get("image_size",
                                                               image_size))
        elif choice in ("vqgan", "vqgan_plus"):
            from .vqgan_plus import VQGANPlus
            ring = {}
            if (choice == "vqgan" and bool(ldcfg(config, "ring_attention", False))
                    and ring_axis_size > 1):
                ring = dict(ring_axis_size=ring_axis_size)
            codec = (VQGANPlus if choice == "vqgan_plus" else VQVAE)(
                in_channels=in_channels,
                hidden_channels=ldcfg(config, "hidden_channels", 256),
                num_downsamples=ldcfg(config, "num_downsamples", 3),
                vq_num_embeddings=ldcfg(config, "vq_num_embeddings", 512),
                internal_dim=ldcfg(config, "internal_dim", 256),
                codebook_levels=ldcfg(config, "codebook_levels", 3),
                vq_embedding_dim=ldcfg(config, "vq_embedding_dim", 4),
                commitment_weight=ldcfg(config, "commitment_weight", 0.25),
                dtype=dtype, quant_decode=quant_decode, quant_encode=quant_encode, **ring)
        elif choice == "sd":
            from .sd_vae import SDVAE
            codec = SDVAE(image_size=image_size, dtype=dtype, quant_decode=quant_decode,
                          quant_encode=quant_encode)
        elif choice == "dac":
            from .audio_codec import DACCodec
            codec = DACCodec(
                sample_rate=int(ldcfg(config, "sample_rate", 16000)),
                strides=tuple(ldcfg(config, "strides", [2, 4, 8, 8])),
                base_channels=int(ldcfg(config, "base_channels", 32)),
                vq_embedding_dim=int(ldcfg(config, "vq_embedding_dim", 8)),
                codebook_levels=int(ldcfg(config, "codebook_levels", 4)),
                vq_num_embeddings=int(ldcfg(config, "vq_num_embeddings", 512)),
                commitment_weight=float(ldcfg(config, "commitment_weight", 0.25)),
                dtype=dtype)
        else:
            raise ValueError(f"Unknown codec choice: {choice}")
    return codec.to(device) if device is not None else codec


def load_codec_weights(codec: nn.Module, checkpoint=None) -> list:
    """Load a codec's weights in place, strictly: for the SD VAE first its
    converted weights file (``SDVAE.weights_path``) when it exists, then,
    for the SD VAE, the VQVAE, the VQGAN+ codec (whose tree has the VQVAE's
    heads) and the DAC codec, ``checkpoint`` (an npz of the checkpoint
    contract) when that file exists. A file that does not fit raises.
    Returns the paths loaded; with none the codec keeps its weights."""
    from ..training.checkpoint import (DAC_PREFIXES, SDVAE_PREFIXES, VQVAE_PREFIXES,
                                       load_checkpoint, load_jax_flat)
    from .audio_codec import DACCodec
    from .sd_vae import SDVAE, load_sd_vae_weights
    from .vqgan_plus import VQGANPlus
    prefixes = {SDVAE: SDVAE_PREFIXES, VQVAE: VQVAE_PREFIXES, VQGANPlus: VQVAE_PREFIXES,
                DACCodec: DAC_PREFIXES}.get(type(codec))
    if prefixes is None:            # noop and resize hold no weights
        return []
    loaded = []
    if isinstance(codec, SDVAE) and load_sd_vae_weights(codec, codec.weights_path):
        loaded.append(codec.weights_path)
    if checkpoint and os.path.exists(str(checkpoint)):
        load_jax_flat(codec, load_checkpoint(str(checkpoint))["model_state_dict"],
                      prefixes)
        loaded.append(str(checkpoint))
    print(f"codec weights loaded from {loaded}" if loaded else
          f"codec checkpoint not found ({checkpoint!r}): the codec keeps its "
          "seeded random weights")
    return loaded


def latest_checkpoint(ckpt_dir: str, prefix: str):
    """The newest ``{ckpt_dir}/{prefix}*.npz`` by modification time, or
    None."""
    files = glob.glob(os.path.join(ckpt_dir, f"{prefix}*.npz"))
    return max(files, key=os.path.getmtime) if files else None


def codec_checkpoint(config, given=None):
    """The codec checkpoint a script loads: ``given`` (else
    ``codec.checkpoint``) where that file exists; for the DAC codec
    otherwise the newest ``dac_*.npz`` under ``+ckpt_dir`` (default
    ``checkpoints``), as the JAX scripts default to the newest
    ``checkpoints/dac_*``."""
    if given is None and "codec" in config:
        given = config.codec.get("checkpoint")
    is_dac = "codec" in config and config.codec.get("choice") == "dac"
    if is_dac and not (given and os.path.exists(str(given))):
        given = latest_checkpoint(str(config.get("ckpt_dir", "checkpoints")), "dac_")
    return given
