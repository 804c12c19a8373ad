"""DAC-style audio codec, PyTorch port of ``flocoder_tpu/models/audio_codec.py``:
Snake-activated residual 1-D convolutions with strided downsampling, the
shared residual VQ (``ops/rvq.py``) and a transposed-convolution decoder
with a tanh head.

Public functions take and return NLC like the JAX package, (B, T, 1)
waveforms and (B, T', D) latents; the modules run NCL inside. Submodules
carry linen's names (``Conv_0``, ``Snake_1``, ``ResidualUnit1D_2``,
``ConvTranspose_0``), so the JAX parameter tree maps onto the
``state_dict`` (``training/checkpoint.py``, ``DAC_PREFIXES``).

flax's padding is reproduced, not torch's:
- ``Conv1d`` is ``nn.Conv(padding="SAME")``: out = ⌈T/s⌉, and the total pad
  ``max((out − 1)·s + (k − 1)·d + 1 − T, 0)`` splits with ``total // 2``
  low, the rest high. The encoder's strided convolutions have even kernels
  (2s), so their pads are asymmetric.
- ``ConvTranspose1d`` is ``nn.ConvTranspose(padding="SAME")``, which is
  ``lax.conv_transpose`` with ``transpose_kernel=False``: a convolution of
  the input dilated by the stride with the kernel as stored (not flipped),
  padded by lax's rule (``pad_a`` = k − 1 when s > k − 1, else
  ⌈(k + s − 2)/2⌉; ``pad_b`` = k + s − 2 − ``pad_a``), giving T·s samples.
  It runs as ``F.conv_transpose1d`` on the flipped kernel, whose implicit
  pad k − 1 − p is set to ``pad_a`` and whose output is trimmed or extended
  at the end to ``pad_b``. Its weight is held in a ``Conv1d``'s layout
  (out, in, k), the flax kernel (k, in, out) transposed.

Compute dtype (``dtype``, flax's ``dtype=`` semantics): the parameters stay
fp32. ``Conv1d`` and ``ConvTranspose1d`` cast the input, the kernel and the
bias to ``dtype`` and add the bias after the product is rounded; Snake
takes ``exp(log_alpha)`` in fp32 and casts it to x's dtype, and each of its
operations then rounds to that dtype, as ``jax.numpy`` does. The encoder
returns fp32 latents and the decoder fp32 waveforms (its tanh in fp32), as
the JAX modules cast them, so the RVQ, the losses and the discriminators
see fp32 in a bf16 codec too.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rvq import RVQState, rvq_apply
from .layers import Scope, init_params, weak

__all__ = ["Snake", "Conv1d", "ConvTranspose1d", "ResidualUnit1D", "DACEncoder",
           "DACDecoder", "DACCodec", "fold_latents", "unfold_latents", "same_pads",
           "transpose_pads"]


def same_pads(n: int, k: int, s: int = 1, d: int = 1) -> Tuple[int, int]:
    """flax/lax ``SAME`` padding of a length-``n`` axis: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s ``SAME`` padding of the dilated input:
    (pad_a, pad_b)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def _compute_dtype(dtype):
    """``None`` (the parameters' own dtype) for fp32, else ``dtype``."""
    return None if dtype in (None, torch.float32) else dtype


def _narrow_conv(fn, x, w, dt, **kw):
    """``fn(x, w)`` on ``x`` and ``w`` rounded to ``dt``, the result rounded
    to ``dt`` once, as XLA and cuDNN compute it (products summed in fp32).
    On the CPU the sum runs in fp32 on the rounded values: PyTorch's CPU
    bf16 1-D convolution gives wrong results for some shapes (8 input
    channels with a kernel of 8, for one, off by the whole output)."""
    x, w = x.to(dt), w.to(dt)
    if x.device.type == "cpu":
        return fn(x.float(), w.float(), **kw).to(dt)
    return fn(x, w, **kw)


class Conv1d(nn.Conv1d):
    """flax ``nn.Conv`` with ``padding="SAME"`` on (B, C, T), computing in
    ``dtype`` (None: the parameters' dtype) with the bias added after the
    product is rounded."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, dilation=dilation,
                         groups=groups)
        self.compute_dtype = _compute_dtype(dtype)

    def forward(self, x):
        lo, hi = same_pads(x.shape[-1], self.kernel_size[0], self.stride[0],
                           self.dilation[0])
        if lo != hi:
            x, lo = F.pad(x, (lo, hi)), 0
        dt = self.compute_dtype
        if dt is None:
            return F.conv1d(x, self.weight, self.bias, self.stride, lo, self.dilation,
                            self.groups)
        y = _narrow_conv(F.conv1d, x, self.weight, dt, stride=self.stride, padding=lo,
                         dilation=self.dilation, groups=self.groups)
        return y + self.bias.to(dt)[:, None]


class ConvTranspose1d(Conv1d):
    """flax ``nn.ConvTranspose`` with ``padding="SAME"`` (module docstring);
    the weight in a ``Conv1d``'s (out, in, k) layout, the output T·s long;
    ``dtype`` as ``Conv1d``'s."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pad_a, pad_b = transpose_pads(k, s)
        dt = self.compute_dtype
        w = self.weight.flip(-1).transpose(0, 1)            # (in, out, k)
        extra = pad_b - pad_a
        kw = dict(stride=s, padding=k - 1 - pad_a, output_padding=max(extra, 0))
        if dt is None:
            y = F.conv_transpose1d(x, w, self.bias, **kw)
        else:
            y = _narrow_conv(F.conv_transpose1d, x, w, dt, **kw)
        y = y[..., :y.shape[-1] + extra] if extra < 0 else y
        return y if dt is None else y + self.bias.to(dt)[:, None]


class Snake(nn.Module):
    """x + sin²(αx)/(α + 1e-9) with a per-channel α = exp(log_alpha),
    zero-initialised, taken in the parameter's dtype and cast to x's; in
    bf16 every operation rounds, and 1e-9 is rounded to bf16 first, as a
    Python scalar beside a JAX array is."""

    def __init__(self, c: int):
        super().__init__()
        self.log_alpha = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        alpha = self.log_alpha.exp().to(x.dtype)[:, None]
        return x + torch.sin(alpha * x) ** 2 / (alpha + weak(1e-9, alpha))


class ResidualUnit1D(nn.Module):
    """snake → dilated conv (k 7) → snake → conv (k 1, zero-initialised),
    residual add."""

    def __init__(self, dim: int, dilation: int = 1, dtype=None):
        super().__init__()
        self.Snake_0 = Snake(dim)
        self.Conv_0 = Conv1d(dim, dim, 7, dilation=dilation, dtype=dtype)
        self.Snake_1 = Snake(dim)
        self.Conv_1 = Conv1d(dim, dim, 1, dtype=dtype)

    def init_special_(self, generator):
        self.Conv_1.weight.zero_()

    def forward(self, x):
        return x + self.Conv_1(self.Snake_1(self.Conv_0(self.Snake_0(x))))


class DACEncoder(nn.Module):
    """(B, T, 1) → (B, T/prod(strides), D) fp32. Per stage three residual
    units (dilations 1, 3, 9), then snake and a conv of kernel 2s and stride
    s that doubles the channels; then snake and a k-3 conv to D. Computes
    in ``dtype``; the latents come out fp32."""

    def __init__(self, strides: Sequence[int] = (2, 4, 8, 8), base_channels: int = 32,
                 vq_embedding_dim: int = 8, dtype=None):
        super().__init__()
        s = Scope(self)
        c = base_channels
        ops = [s.add("Conv", Conv1d(1, c, 7, dtype=dtype))]
        for st in strides:
            ops += [s.add("ResidualUnit1D", ResidualUnit1D(c, d, dtype)) for d in (1, 3, 9)]
            ops += [s.add("Snake", Snake(c)),
                    s.add("Conv", Conv1d(c, 2 * c, 2 * st, st, dtype=dtype))]
            c *= 2
        ops += [s.add("Snake", Snake(c)),
                s.add("Conv", Conv1d(c, vq_embedding_dim, 3, dtype=dtype))]
        self.ops = ops

    def forward(self, x):
        h = x.permute(0, 2, 1)
        for op in self.ops:
            h = op(h)
        return h.permute(0, 2, 1).float()


class DACDecoder(nn.Module):
    """(B, T', D) → (B, T, 1) in [-1, 1]. A k-7 conv to base·2^S channels,
    then per stage (strides reversed) snake and a transposed conv of kernel
    2s and stride s that halves the channels, and three residual units;
    snake, a k-7 conv to one channel, tanh in fp32. Computes in
    ``dtype``."""

    def __init__(self, strides: Sequence[int] = (2, 4, 8, 8), base_channels: int = 32,
                 vq_embedding_dim: int = 8, dtype=None):
        super().__init__()
        s = Scope(self)
        c = base_channels * (2 ** len(strides))
        ops = [s.add("Conv", Conv1d(vq_embedding_dim, c, 7, dtype=dtype))]
        for st in reversed(tuple(strides)):
            ops += [s.add("Snake", Snake(c)),
                    s.add("ConvTranspose", ConvTranspose1d(c, c // 2, 2 * st, st,
                                                           dtype=dtype))]
            c //= 2
            ops += [s.add("ResidualUnit1D", ResidualUnit1D(c, d, dtype)) for d in (1, 3, 9)]
        ops += [s.add("Snake", Snake(c)), s.add("Conv", Conv1d(c, 1, 7, dtype=dtype))]
        self.ops = ops

    def forward(self, z):
        h = z.permute(0, 2, 1)
        for op in self.ops:
            h = op(h)
        return torch.tanh(h.float()).permute(0, 2, 1)


def fold_latents(z: torch.Tensor) -> torch.Tensor:
    """(B, T', D) → (B, H, W, D) with H = W = √T' (row-major time)."""
    b, t, d = z.shape
    h = math.isqrt(t)
    if h * h != t:
        raise ValueError(f"latent length {t} is not a perfect square; choose "
                         f"crop_len = (H²)·prod(strides)")
    return z.reshape(b, h, h, d)


def unfold_latents(z: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) → (B, H·W, D), the inverse of ``fold_latents``."""
    b, h, w, d = z.shape
    return z.reshape(b, h * w, d)


class DACCodec(nn.Module):
    """Encoder + RVQ bottleneck + decoder with the codec contract of
    ``VQVAE``: ``encode``, ``quantize``, ``decode`` (of (B, T', D) or folded
    (B, H, W, D) latents), ``forward``, ``latent_shape(crop_len)``. The JAX
    checkpoint's ``encoder/params/…``, ``decoder/params/…`` and ``vq/…`` map
    onto ``encoder.…``, ``decoder.…`` and ``vq.…``. ``dtype`` is the
    encoder's and decoder's compute dtype (fp32 parameters either way)."""

    is_audio = True
    in_channels = 1

    def __init__(self, sample_rate: int = 16000, strides: Sequence[int] = (2, 4, 8, 8),
                 base_channels: int = 32, vq_embedding_dim: int = 8,
                 codebook_levels: int = 4, vq_num_embeddings: int = 512,
                 commitment_weight: float = 0.25, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.sample_rate = int(sample_rate)
        self.strides = tuple(int(s) for s in strides)
        self.hop = math.prod(self.strides)
        self.vq_embedding_dim = vq_embedding_dim
        self.codebook_levels = codebook_levels
        self.vq_num_embeddings = vq_num_embeddings
        self.commitment_weight = commitment_weight
        self.encoder = DACEncoder(self.strides, base_channels, vq_embedding_dim, dtype)
        self.decoder = DACDecoder(self.strides, base_channels, vq_embedding_dim, dtype)
        self.vq = RVQState(codebook_levels, vq_num_embeddings, vq_embedding_dim)

    def init(self, generator: torch.Generator) -> "DACCodec":
        """Seeded random init (``layers.init_params``); returns self."""
        return init_params(self, generator)

    def encode(self, x):
        return self.encoder(x[..., None] if x.ndim == 2 else x)

    def quantize(self, z, train: bool = False, generator=None, **draws):
        """Latents (B, T', D) or folded (B, H, W, D) → (z_q, indices (…, L),
        commit_loss, new_vq), the new RVQ state as tensors; ``draws`` are
        ``rvq_apply``'s injected ``kmeans_seeds``/``reseed_picks``."""
        shape = z.shape
        z_q, idx, loss, new_vq = rvq_apply(
            self.vq, z.reshape(-1, shape[-1]), train=train, generator=generator,
            commitment_weight=self.commitment_weight, **draws)
        return z_q.reshape(shape), idx.reshape(*shape[:-1], -1), loss, new_vq

    def decode(self, z):
        return self.decoder(unfold_latents(z) if z.ndim == 4 else z)

    def forward(self, x, train: bool = False, generator=None, **draws):
        """Full autoencode → (recon, commit_loss, indices, new_vq)."""
        z_q, idx, commit_loss, new_vq = self.quantize(self.encode(x), train=train,
                                                      generator=generator, **draws)
        return self.decode(z_q), commit_loss, idx, new_vq

    def latent_shape(self, crop_len: int) -> Tuple[int, int, int]:
        """Folded (H, W, D) latent shape for a waveform crop length."""
        t = int(crop_len) // self.hop
        h = math.isqrt(t)
        if h * h != t:
            raise ValueError(
                f"crop_len {crop_len} gives latent length {t}, not a perfect square; "
                f"use crop_len = H²·{self.hop} (e.g. {8 * 8 * self.hop} → 8×8)")
        return (h, h, self.vq_embedding_dim)
