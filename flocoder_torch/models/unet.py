"""Flow-matching velocity-field U-Net, PyTorch port of
``flocoder_tpu/models/unet.py``.

The public forward takes and returns NHWC like the JAX module; inside, the
modules run NCHW for cuDNN. Submodule names follow linen's auto-names (see
``layers.Scope``), so the JAX parameter tree maps onto the ``state_dict``
key for key.

Ported: ResnetBlock with FiLM, LinearAttention at every scale, softmax
Attention at the bottleneck (plain matmul + softmax), pixel-unshuffle
Downsample and nearest Upsample, the sinusoidal time embedding, the class
embedding with the null id −1 masked, ``dual_time`` (MeanFlow), and mask
conditioning (``mask_cond``): the input fusion (5×5 → 3×3 → 3×3 convs on the
stem concatenated with the mask), bypassed for the whole batch when every
mask value is 1 (a 0-dim ``torch.where``, so the forward never waits on the
card for it), and the mask resized into the first two down and up scales
with ``jax.image.resize``'s bilinear weights (antialiased when it shrinks;
``inpainting.resize_bilinear``). A missing mask is the all-ones mask. With
``ring_axis_size`` > 1 the bottleneck attention is the ring over the mesh's
model axis (``parallel/ring_attention.py``), the training twin of
``train_flow``'s ``flow.ring_attention`` with the same parameters.

``dtype`` is the compute dtype, as the JAX module's field. In bf16 the
parameters stay fp32, every Conv and Dense casts its input, kernel and bias
to it (``layers.Conv``, ``layers.Dense``), GroupNorm takes its statistics in
fp32 and gives ``dtype``, the attention logits and the linear attention's
context are accumulated in fp32 and then cast, the time embedding is
computed in ``dtype``, the exact GELU takes ``jax.nn.gelu``'s erfc form (so
that it rounds where the JAX module does), and the output is fp32. In fp32
the model computes in its parameters' dtype (a float64 copy in float64).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..inpainting import resize_bilinear
from ..parallel.ring_attention import ring_attention_replicated
from .layers import Dense, Scope, conv, group_norm

__all__ = ["Unet", "sinusoidal_embedding", "pixel_shuffle", "pixel_unshuffle"]


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of a (B,) time vector (divisor ``half - 1``, as
    in the JAX package)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU; below fp32 in ``jax.nn.gelu``'s form 0.5·x·erfc(−x·√½),
    each operation rounded to x's dtype."""
    if x.element_size() >= 4:
        return F.gelu(x)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` widened to fp32 when it is narrower (flax's
    ``preferred_element_type=float32`` accumulation)."""
    return t.float() if t.element_size() < 4 else t


def pixel_unshuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Space-to-depth on NHWC: (B, H, W, C) → (B, H/f, W/f, C·f²), channel
    order c·f² + i·f + j as in the JAX package."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Depth-to-space on NHWC: (B, H, W, C·f²) → (B, H·f, W·f, C)."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


class Block(nn.Module):
    """conv3×3 → GroupNorm → (FiLM scale/shift) → SiLU."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 4, dtype=None):
        super().__init__()
        self.Conv_0 = conv(dim_in, dim_out, 3, dtype=dtype)
        self.GroupNorm_0 = group_norm(groups, dim_out, 1e-5, dtype)

    def forward(self, x, scale_shift=None):
        x = self.GroupNorm_0(self.Conv_0(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """FiLM-conditioned residual block."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int,
                 groups: int = 4, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(time_dim, dim_out * 2, bias=True, dtype=dtype)
        self.Block_0 = Block(dim_in, dim_out, groups, dtype)
        self.Block_1 = Block(dim_out, dim_out, groups, dtype)
        self.Conv_0 = conv(dim_in, dim_out, 1, dtype=dtype) if dim_in != dim_out else None

    def forward(self, x, time_emb):
        emb = self.Dense_0(F.silu(time_emb))[:, :, None, None]
        scale, shift = emb.chunk(2, dim=1)
        h = self.Block_1(self.Block_0(x, (scale, shift)))
        return h + (self.Conv_0(x) if self.Conv_0 is not None else x)


def _split_heads(qkv: torch.Tensor, heads: int, dim_head: int):
    """(b, 3·heads·d, h, w) → q, k, v each (b, heads, d, n); the JAX
    channel order (3, heads, d)."""
    b = qkv.shape[0]
    qkv = qkv.reshape(b, 3, heads, dim_head, -1)
    return qkv[:, 0], qkv[:, 1], qkv[:, 2]


class Attention(nn.Module):
    """Full softmax attention over spatial tokens (bottleneck only), as a
    plain matmul + softmax; the logits and the softmax in fp32. With
    ``ring_axis_size`` > 1, the ring over the model axis."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dtype=None,
                 ring_axis_size: int = 1):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.ring_axis_size = ring_axis_size
        hidden = heads * dim_head
        self.Conv_0 = conv(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.Conv_1 = conv(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = _split_heads(self.Conv_0(x), self.heads, self.dim_head)
        if self.ring_axis_size > 1:       # (b, heads, d, n) → (b, n, heads, d) and back
            out = ring_attention_replicated(*(t.permute(0, 3, 1, 2) for t in (q, k, v)),
                                            self.ring_axis_size)
            return self.Conv_1(out.permute(0, 2, 3, 1).reshape(b, -1, h, w))
        q = q * (self.dim_head ** -0.5)
        sim = torch.einsum("bhdn,bhdm->bhnm", _acc(q), _acc(k))
        sim = sim - sim.amax(dim=-1, keepdim=True)
        attn = sim.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bhdm->bhdn", attn, v)
        return self.Conv_1(out.reshape(b, -1, h, w))


class LinearAttention(nn.Module):
    """O(N) kernel-feature attention used at every scale: q softmaxed over
    the feature dim, k over tokens, context = K Vᵀ (accumulated in fp32,
    then cast), out = contextᵀ Q."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dtype=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.Conv_0 = conv(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.Conv_1 = conv(hidden, dim, 1, dtype=dtype)
        self.GroupNorm_0 = group_norm(1, dim, 1e-5, dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = _split_heads(self.Conv_0(x), self.heads, self.dim_head)
        q = q.softmax(dim=2) * (self.dim_head ** -0.5)   # over d
        k = k.softmax(dim=3)                              # over tokens
        context = torch.einsum("bhdn,bhen->bhde", _acc(k), _acc(v)).to(v.dtype)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.GroupNorm_0(self.Conv_1(out.reshape(b, -1, h, w)))


class PreNormResidual(nn.Module):
    """x + fn(GroupNorm_1(x)). ``fn`` is owned by the parent, as in the JAX
    module tree, so it is not registered here."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.GroupNorm_0 = group_norm(1, dim, 1e-5, dtype)

    def forward(self, x, fn):
        return x + fn(self.GroupNorm_0(x))


class Downsample(nn.Module):
    """Pixel-unshuffle + 1×1 conv."""

    def __init__(self, dim_in: int, dim_out: int, dtype=None):
        super().__init__()
        self.Conv_0 = conv(dim_in * 4, dim_out, 1, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(F.pixel_unshuffle(x, 2))


class Upsample(nn.Module):
    """Nearest 2× upsample + conv3×3."""

    def __init__(self, dim_in: int, dim_out: int, dtype=None):
        super().__init__()
        self.Conv_0 = conv(dim_in, dim_out, 3, dtype=dtype)

    def forward(self, x):
        return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))


class Unet(nn.Module):
    """Velocity field v(x, t, cond). ``cond`` is a dict
    ``{'class_cond': (B,) int or None, 'mask_cond': (B, H, W, Cm) or None}``;
    a class id < 0 is the CFG null token and contributes nothing; the mask
    is read only with ``mask_cond``. NHWC in and out; ``dtype`` the compute
    dtype (fp32 parameters, fp32 output)."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 3, resnet_block_groups: int = 4,
                 n_classes: int = 0, mask_cond: bool = False,
                 mask_channels: int = 1, dual_time: bool = False,
                 ring_axis_size: int = 1, dtype=torch.float32):
        super().__init__()
        self.dim, self.n_classes, self.dual_time = dim, n_classes, dual_time
        self.mask_cond, self.mask_channels = mask_cond, mask_channels
        self.dtype = dtype
        dt = None if dtype == torch.float32 else dtype     # fp32: the parameters' dtype
        groups = resnet_block_groups
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 8
        s = Scope(self)
        s.conv(channels, dim, 1, name="init_conv", dtype=dt)
        if mask_cond:      # the input fusion: Conv_0, Conv_1, Conv_2
            self.fusion = [s.conv(dim + mask_channels, 2 * dim, 5, dtype=dt),
                           s.conv(2 * dim, 2 * dim, 3, dtype=dt),
                           s.conv(2 * dim, dim, 3, dtype=dt)]
        self.time_mlp = [s.dense(dim, time_dim, dtype=dt), s.dense(time_dim, time_dim, dtype=dt)]
        self.horizon_mlp = ([s.dense(dim, time_dim, dtype=dt),
                             s.dense(time_dim, time_dim, dtype=dt)] if dual_time else None)
        if n_classes > 0:
            self.class_emb = [s.add("Embed", nn.Embedding(n_classes, time_dim)),
                              s.dense(time_dim, time_dim, dtype=dt),
                              s.dense(time_dim, time_dim, dtype=dt)]

        # Creation order mirrors the JAX forward, which fixes every name.
        self.downs = []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            r1 = s.add("ResnetBlock", ResnetBlock(dim_in, dim_in, time_dim, groups, dt))
            r2 = s.add("ResnetBlock", ResnetBlock(dim_in, dim_in, time_dim, groups, dt))
            pre = s.add("PreNormResidual", PreNormResidual(dim_in, dt))
            attn = s.add("LinearAttention", LinearAttention(dim_in, dtype=dt))
            mconv = (s.conv(dim_in + mask_channels, dim_in, 3, dtype=dt)
                     if mask_cond and ind < 2 else None)
            down = (s.add("Downsample", Downsample(dim_in, dim_out, dt)) if not is_last
                    else s.conv(dim_in, dim_out, 3, dtype=dt))
            self.downs.append((r1, r2, pre, attn, mconv, down))
        mid = dims[-1]
        self.mid = (s.add("ResnetBlock", ResnetBlock(mid, mid, time_dim, groups, dt)),
                    s.add("PreNormResidual", PreNormResidual(mid, dt)),
                    s.add("Attention", Attention(mid, dtype=dt,
                                                 ring_axis_size=ring_axis_size)),
                    s.add("ResnetBlock", ResnetBlock(mid, mid, time_dim, groups, dt)))
        self.ups = []
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            r1 = s.add("ResnetBlock", ResnetBlock(dim_out + dim_in, dim_out, time_dim,
                                                  groups, dt))
            r2 = s.add("ResnetBlock", ResnetBlock(dim_out + dim_in, dim_out, time_dim,
                                                  groups, dt))
            pre = s.add("PreNormResidual", PreNormResidual(dim_out, dt))
            attn = s.add("LinearAttention", LinearAttention(dim_out, dtype=dt))
            mconv = (s.conv(dim_out + mask_channels, dim_out, 3, dtype=dt)
                     if mask_cond and ind < 2 else None)
            up = (s.add("Upsample", Upsample(dim_out, dim_in, dt)) if not is_last
                  else s.conv(dim_out, dim_in, 3, dtype=dt))
            self.ups.append((r1, r2, pre, attn, mconv, up))
        self.final_res = [s.add("ResnetBlock",
                                ResnetBlock(dim * 2, dim, time_dim, groups, dt))]
        s.conv(dim, channels, 1, name="final_conv", dtype=dt)

    @staticmethod
    def _mlp(layers, x):
        return layers[1](_gelu(layers[0](x)))

    @staticmethod
    def _mask_in(x: torch.Tensor, mask: torch.Tensor, mconv) -> torch.Tensor:
        """x + silu(conv([x, mask resized to x's scale])), NCHW."""
        m = resize_bilinear(mask, x.shape[2:4]).permute(0, 3, 1, 2)
        return x + F.silu(mconv(torch.cat([x, m], dim=1)))

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                cond: Optional[dict] = None) -> torch.Tensor:
        class_cond = cond.get("class_cond") if cond else None
        mask = cond.get("mask_cond") if cond and self.mask_cond else None
        dtype = self.init_conv.weight.dtype if self.dtype == torch.float32 else self.dtype
        if self.mask_cond and mask is None:
            # the all-ones mask, which the input fusion bypasses
            mask = torch.ones(*x.shape[:3], self.mask_channels, dtype=dtype,
                              device=x.device)
        x = self.init_conv(x.to(dtype).permute(0, 3, 1, 2).contiguous())
        if self.mask_cond:
            mask = mask.to(dtype)
            c0, c1, c2 = self.fusion
            fused = torch.cat([x, mask.permute(0, 3, 1, 2)], dim=1)
            fused = c2(F.silu(c1(F.silu(c0(fused)))))
            x = torch.where((mask == 1.0).all(), x, fused)
        r = x

        tv = torch.as_tensor(time, dtype=dtype, device=x.device)
        t = self._mlp(self.time_mlp, sinusoidal_embedding(tv, self.dim))
        if self.dual_time:
            horizon = cond.get("time_horizon") if cond else None
            delta = (torch.as_tensor(horizon, dtype=dtype, device=x.device) - tv
                     if horizon is not None else torch.zeros_like(tv))
            t = t + self._mlp(self.horizon_mlp,
                              sinusoidal_embedding(delta, self.dim))
        if self.n_classes > 0 and class_cond is not None:
            embed, d0, d1 = self.class_emb
            ce = d1(_gelu(d0(embed(class_cond.clamp(0, self.n_classes - 1)))))
            t = t + ce * (class_cond >= 0).to(dtype)[:, None]

        hs = []
        for r1, r2, pre, attn, mconv, down in self.downs:
            x = r1(x, t)
            hs.append(x)
            x = pre(r2(x, t), attn)
            hs.append(x)
            if mconv is not None:
                x = self._mask_in(x, mask, mconv)
            x = down(x)

        m1, pre, attn, m2 = self.mid
        x = m2(pre(m1(x, t), attn), t)

        for r1, r2, pre, attn, mconv, up in self.ups:
            x = r1(torch.cat([x, hs.pop()], dim=1), t)
            x = r2(torch.cat([x, hs.pop()], dim=1), t)
            x = pre(x, attn)
            if mconv is not None:
                x = self._mask_in(x, mask, mconv)
            x = up(x)

        x = self.final_res[0](torch.cat([x, r], dim=1), t)
        out = self.final_conv(x)
        return out.permute(0, 2, 3, 1).float()
