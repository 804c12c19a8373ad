"""Hourglass Diffusion Transformer (HDiT) velocity field, PyTorch port of
``flocoder_tpu/models/hdit.py``.

An hourglass of transformer levels over patch tokens, NHWC ``(B, H, W,
width)``: TokenMerge (space-to-depth + matmul) between levels going down,
TokenSplit (matmul + depth-to-space) with a learnable-lerp skip going up;
per level, self-attention blocks (neighborhood attention or global, axial
2-D RoPE, RMS-normalised q and k) and GEGLU feed-forward blocks (dense or a
single-device mixture of experts, ``parallel/moe.py``); a mapping MLP turns
(time, class, MeanFlow horizon) into the conditioning vector that every
block's AdaRMSNorm reads. Every residual branch ends in a zero-initialised
projection, so the model is the zero velocity field at init; a class id < 0
is the CFG null token and contributes nothing.

Neighborhood attention calls ``ops.neighborhood_attention.na2d``: on the
card K1 forward and K2 backward (``NA2DFunction``), on the CPU their plain
twins. The global branch is a plain matmul + softmax with fp32 logits and
the row maximum subtracted, as in the JAX module, or with
``ring_axis_size`` > 1 the ring over the mesh's model axis
(``parallel/ring_attention.py``: the training twin of ``train_flow``'s
``flow.ring_attention``; the parameters are the same either way).

``dtype`` is a module field as in flax: every Dense casts its input and its
fp32 weight to it, RMS statistics and the MoE router stay in fp32, and the
output is fp32. Submodules and parameters carry the JAX module's names
(``down_0_attn_1.AdaRMSNorm_0.cond_scale``, ``mid_ff_0.up_kernel``, …), so
the flax tree maps onto the ``state_dict`` through
``training.checkpoint.UNET_PREFIXES``.

``forward(..., return_aux=True)`` also returns the MoE blocks' auxiliary
losses and dropped fractions (flax's ``sow("moe_losses")``), which
``train_flow`` folds into the objective. Not ported yet (ROADMAP.md item
13c): the stacked, pipelined mid level (``pp_stages``) and expert
parallelism.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..ops.neighborhood_attention import na2d
from ..parallel.ring_attention import ring_attention_replicated
from ..parallel.moe import (geglu, load_balance_loss, moe_capacity,
                            moe_geglu_apply, moe_routing)
from .layers import Dense
from .unet import sinusoidal_embedding

__all__ = ["HDiT", "LevelSpec", "MappingSpec", "GlobalAttentionSpec",
           "NeighborhoodAttentionSpec", "RMSNorm", "AdaRMSNorm",
           "SelfAttentionBlock", "FeedForwardBlock", "MoEFeedForwardBlock",
           "TokenMerge", "TokenSplit", "MappingMLP", "hdit_from_config"]


@dataclasses.dataclass(frozen=True)
class GlobalAttentionSpec:
    d_head: int = 64


@dataclasses.dataclass(frozen=True)
class NeighborhoodAttentionSpec:
    d_head: int = 64
    kernel_size: int = 7


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    depth: int
    width: int
    d_ff: int
    self_attn: Any = GlobalAttentionSpec()
    dropout: float = 0.0          # accepted, as in JAX; HDiT runs dropout-free
    moe_experts: int = 0          # > 0: MoE GEGLU blocks with this many experts
    moe_top_k: int = 2
    moe_capacity: float = 1.25


@dataclasses.dataclass(frozen=True)
class MappingSpec:
    depth: int = 2
    width: int = 256
    d_ff: int = 768
    dropout: float = 0.0


def _rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation over the trailing axis, accumulated in fp32."""
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with a learnable scale (ones-init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _rms_norm(x) * self.scale.to(x.dtype)


class AdaRMSNorm(nn.Module):
    """RMSNorm whose scale is 1 + a zero-init projection of the
    conditioning vector."""

    def __init__(self, dim: int, cond_dim: int, dtype=torch.float32):
        super().__init__()
        self.cond_scale = Dense(cond_dim, dim, dtype=dtype, zero_init=True)

    def forward(self, x, cond):
        scale = 1.0 + self.cond_scale(cond).to(x.dtype)
        return _rms_norm(x) * scale[:, None, None, :]


def _axial_rope(q: torch.Tensor, k: torch.Tensor, hw: Tuple[int, int],
                base: float = 10000.0):
    """Axial 2-D RoPE on per-head tensors ``(B, H, W, heads, d)``: the first
    half of d rotates with the row, the second with the column; within each
    half the pairs are (x[:half], x[half:]), not interleaved."""
    H, W = hw
    dq = q.shape[-1] // 2
    half = dq // 2
    dev = q.device
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=dev) / half)
    ah = (torch.arange(H, dtype=torch.float32, device=dev)[:, None]
          * freqs)[:, None, None, :]                             # (H, 1, 1, half)
    aw = (torch.arange(W, dtype=torch.float32, device=dev)[:, None]
          * freqs)[None, :, None, :]                             # (1, W, 1, half)

    def rot(x, ang):
        x1, x2 = x[..., :half], x[..., half:]
        c, s = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    def apply(x):
        return torch.cat([rot(x[..., :dq], ah), rot(x[..., dq:], aw)], dim=-1)

    return apply(q), apply(k)


class SelfAttentionBlock(nn.Module):
    """Pre-AdaRMSNorm residual attention: qk RMSNorm, axial RoPE,
    neighborhood (NA2D) or global attention (the ring over the model axis
    with ``ring_axis_size`` > 1), zero-init output."""

    def __init__(self, spec, width: int, cond_dim: int, dtype=torch.float32,
                 ring_axis_size: int = 1):
        super().__init__()
        self.ring_axis_size = ring_axis_size
        if spec.d_head % 4:
            raise ValueError(f"d_head must be divisible by 4 for axial RoPE, "
                             f"got {spec.d_head}")
        self.spec = spec
        self.heads = max(width // spec.d_head, 1)
        hidden = self.heads * spec.d_head
        self.AdaRMSNorm_0 = AdaRMSNorm(width, cond_dim, dtype)
        self.qkv = Dense(width, hidden * 3, dtype=dtype)
        self.q_scale = nn.Parameter(torch.ones(spec.d_head))
        self.k_scale = nn.Parameter(torch.ones(spec.d_head))
        self.out = Dense(hidden, width, dtype=dtype, zero_init=True)

    def forward(self, x, cond):
        B, H, W, _ = x.shape
        d, heads = self.spec.d_head, self.heads
        hidden = heads * d
        skip = x
        qkv = self.qkv(self.AdaRMSNorm_0(x, cond)).reshape(B, H, W, 3, heads, d)
        q, k, v = qkv.unbind(3)
        q = _rms_norm(q) * self.q_scale.to(q.dtype)
        k = _rms_norm(k) * self.k_scale.to(k.dtype)
        q, k = _axial_rope(q, k, (H, W))
        scale = d ** -0.5
        if isinstance(self.spec, NeighborhoodAttentionSpec):
            # the kernels take contiguous NHWC tensors of one dtype
            out = na2d(*(t.reshape(B, H, W, hidden).contiguous() for t in (q, k, v)),
                       kernel_size=self.spec.kernel_size, heads=heads, scale=scale)
        elif self.ring_axis_size > 1:
            out = ring_attention_replicated(
                *(t.reshape(B, H * W, heads, d) for t in (q, k, v)),
                self.ring_axis_size, scale)
            out = out.reshape(B, H, W, hidden)
        else:
            qf = (q * scale).reshape(B, H * W, heads, d)
            sim = torch.einsum("bnhd,bmhd->bhnm", qf.float(),
                               k.reshape(B, H * W, heads, d).float())
            sim = sim - sim.amax(dim=-1, keepdim=True).detach()
            attn = sim.softmax(dim=-1).to(v.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v.reshape(B, H * W, heads, d))
            out = out.reshape(B, H, W, hidden)
        return skip + self.out(out)


class FeedForwardBlock(nn.Module):
    """Pre-AdaRMSNorm residual GEGLU MLP (exact-erf GELU), zero-init down
    projection."""

    def __init__(self, width: int, d_ff: int, cond_dim: int, dtype=torch.float32):
        super().__init__()
        self.AdaRMSNorm_0 = AdaRMSNorm(width, cond_dim, dtype)
        self.up = Dense(width, d_ff * 2, dtype=dtype)
        self.down = Dense(d_ff, width, dtype=dtype, zero_init=True)

    def forward(self, x, cond):
        return x + self.down(geglu(self.up(self.AdaRMSNorm_0(x, cond))))


class MoEFeedForwardBlock(nn.Module):
    """The mixture-of-experts twin of ``FeedForwardBlock``: an fp32 router,
    top-k routing with capacity truncation, per-expert GEGLU
    (``parallel/moe.py``). ``up_kernel`` (E, d, 2·d_ff) and ``down_kernel``
    (E, d_ff, d, zero-init) are raw parameters in flax layout. Returns the
    output, the auxiliary loss (load balance + router z) and the fraction
    of assignments dropped at capacity."""

    def __init__(self, width: int, d_ff: int, n_experts: int, cond_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25, dtype=torch.float32):
        super().__init__()
        self.n_experts, self.top_k, self.capacity_factor = n_experts, top_k, capacity_factor
        self.AdaRMSNorm_0 = AdaRMSNorm(width, cond_dim, dtype)
        self.router = Dense(width, n_experts, dtype=torch.float32)
        self.up_kernel = nn.Parameter(torch.empty(n_experts, width, d_ff * 2))
        self.down_kernel = nn.Parameter(torch.zeros(n_experts, d_ff, width))

    @torch.no_grad()
    def init_special_(self, generator):
        """lecun normal over each expert's fan-in d; down_kernel zero."""
        w = torch.randn(self.up_kernel.shape, generator=generator, device=generator.device)
        self.up_kernel.copy_(w * math.sqrt(1.0 / self.up_kernel.shape[1]))
        self.down_kernel.zero_()

    def forward(self, x, cond):
        B, H, W, d = x.shape
        flat = self.AdaRMSNorm_0(x, cond).reshape(B * H * W, d)
        logits = self.router(flat.float())
        routing = moe_routing(logits, self.top_k,
                              moe_capacity(flat.shape[0], self.n_experts, self.top_k,
                                           self.capacity_factor))
        out = moe_geglu_apply(flat, routing, self.up_kernel, self.down_kernel)
        return (x + out.reshape(B, H, W, d).to(x.dtype),
                load_balance_loss(routing.stats, self.n_experts),
                routing.stats["dropped_frac"])


class TokenMerge(nn.Module):
    """Space-to-depth patch merge: (B, H, W, C) → (B, H/p, W/p, out)."""

    def __init__(self, in_width: int, out_width: int, patch: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.patch = patch
        self.proj = Dense(patch * patch * in_width, out_width, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(b, h // p, w // p, p * p * c))


class TokenSplit(nn.Module):
    """Depth-to-space patch split: (B, H, W, C) → (B, H·p, W·p, out),
    blended with the skip by a learnable lerp ``skip + fac·(up − skip)``
    (fac init 0.5)."""

    def __init__(self, in_width: int, out_width: int, patch: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.patch, self.out_width = patch, out_width
        self.proj = Dense(in_width, out_width * patch * patch, dtype=dtype)
        self.fac = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x, skip):
        b, h, w, _ = x.shape
        p = self.patch
        x = self.proj(x).reshape(b, h, w, p, p, self.out_width).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h * p, w * p, self.out_width)
        return skip + self.fac.to(x.dtype) * (x - skip)


class MappingMLP(nn.Module):
    """Residual GEGLU blocks over the fused (time ⊕ class ⊕ horizon)
    embedding, final RMSNorm."""

    def __init__(self, spec: MappingSpec, dtype=torch.float32):
        super().__init__()
        self.depth = spec.depth
        for i in range(spec.depth):
            self.add_module(f"norm_{i}", RMSNorm(spec.width))
            self.add_module(f"up_{i}", Dense(spec.width, spec.d_ff * 2, dtype=dtype))
            self.add_module(f"down_{i}", Dense(spec.d_ff, spec.width, dtype=dtype,
                                               zero_init=True))
        self.norm_out = RMSNorm(spec.width)

    def forward(self, e):
        for i in range(self.depth):
            h = getattr(self, f"up_{i}")(getattr(self, f"norm_{i}")(e))
            e = e + getattr(self, f"down_{i}")(geglu(h))
        return self.norm_out(e)


class HDiT(nn.Module):
    """Hourglass DiT velocity field v(x, t, cond), or u(x, r, t) with
    ``dual_time`` (MeanFlow). ``levels`` run outermost to innermost:
    levels[:-1] each give a down and an up stage, levels[-1] is the middle.
    The spatial size must be divisible by patch_size · 2^(len(levels) − 1).
    NHWC in and out."""

    def __init__(self, levels: Tuple[LevelSpec, ...], mapping: MappingSpec = MappingSpec(),
                 channels: int = 4, patch_size: int = 4, n_classes: int = 0,
                 dual_time: bool = False, dtype=torch.float32, pp_stages: int = 0,
                 ring_axis_size: int = 1):
        super().__init__()
        if pp_stages:
            raise NotImplementedError("HDiT's stacked, pipelined mid level "
                                      "(hdit_pp_stages > 0) is not ported yet (ROADMAP.md "
                                      "item 13c)")
        self.levels, self.mapping_spec = tuple(levels), mapping
        self.channels, self.patch_size = channels, patch_size
        self.n_classes, self.dual_time, self.dtype = n_classes, dual_time, dtype
        mw = mapping.width
        self.time_in = Dense(mw // 4, mw, bias=True, dtype=dtype)
        if dual_time:
            self.horizon_in = Dense(mw // 4, mw, bias=True, dtype=dtype)
        if n_classes > 0:
            self.class_emb = nn.Embedding(n_classes, mw)
        self.mapping = MappingMLP(mapping, dtype)
        self.patch_in = TokenMerge(channels, self.levels[0].width, patch_size, dtype)

        def level(spec, tag):
            for j in range(spec.depth):
                self.add_module(f"{tag}_attn_{j}", SelfAttentionBlock(
                    spec.self_attn, spec.width, mw, dtype, ring_axis_size))
                self.add_module(f"{tag}_ff_{j}", MoEFeedForwardBlock(
                    spec.width, spec.d_ff, spec.moe_experts, mw, spec.moe_top_k,
                    spec.moe_capacity, dtype) if spec.moe_experts else
                    FeedForwardBlock(spec.width, spec.d_ff, mw, dtype))

        for i, spec in enumerate(self.levels[:-1]):
            level(spec, f"down_{i}")
            self.add_module(f"merge_{i}", TokenMerge(spec.width, self.levels[i + 1].width,
                                                     2, dtype))
        level(self.levels[-1], "mid")
        for i, spec in enumerate(self.levels[:-1]):
            self.add_module(f"split_{i}", TokenSplit(self.levels[i + 1].width, spec.width,
                                                     2, dtype))
            level(spec, f"up_{i}")
        self.norm_out = RMSNorm(self.levels[0].width)
        self.patch_out = Dense(self.levels[0].width, channels * patch_size ** 2,
                               dtype=dtype, zero_init=True)

    def _run_level(self, x, spec, tag, cond_vec, aux):
        for j in range(spec.depth):
            x = getattr(self, f"{tag}_attn_{j}")(x, cond_vec)
            x = getattr(self, f"{tag}_ff_{j}")(x, cond_vec)
            if spec.moe_experts:
                x, loss, dropped = x
                aux.append((loss, dropped))
        return x

    def forward(self, x: torch.Tensor, time: torch.Tensor, cond: Optional[dict] = None,
                return_aux: bool = False):
        """``cond``: ``{'class_cond': (B,) int or None, 'mask_cond': None,
        'time_horizon': (B,) with dual_time}``. Returns the fp32 velocity;
        with ``return_aux`` also ``{'moe_aux': (n,), 'moe_dropped': (n,)}``
        over the n MoE blocks (empty without MoE levels)."""
        dtype = self.dtype
        class_cond = cond.get("class_cond") if cond else None
        if cond and cond.get("mask_cond") is not None:
            raise ValueError("HDiT has no mask-conditioning path; use arch=unet "
                             "for inpainting")
        mw = self.mapping_spec.width
        t = torch.as_tensor(time, device=x.device).to(dtype)
        e = self.time_in(sinusoidal_embedding(t, mw // 4))
        if self.dual_time:
            horizon = cond.get("time_horizon") if cond else None
            delta = (torch.as_tensor(horizon, device=x.device).to(dtype) - t
                     if horizon is not None else torch.zeros_like(t))
            e = e + self.horizon_in(sinusoidal_embedding(delta, mw // 4))
        if self.n_classes > 0 and class_cond is not None:
            ce = self.class_emb(class_cond.clamp(0, self.n_classes - 1)).to(dtype)
            e = e + ce * (class_cond >= 0).to(dtype)[:, None]
        cond_vec = self.mapping(e)

        x = x.to(dtype)
        need = self.patch_size * (1 << (len(self.levels) - 1))
        if x.shape[1] % need or x.shape[2] % need:
            raise ValueError(
                f"HDiT with patch_size={self.patch_size} and {len(self.levels)} levels "
                f"needs spatial dims divisible by {need}; got {x.shape[1]}×{x.shape[2]}"
                " — lower hdit_patch_size or drop a level")
        x = self.patch_in(x)
        aux, skips = [], []
        for i, spec in enumerate(self.levels[:-1]):
            x = self._run_level(x, spec, f"down_{i}", cond_vec, aux)
            skips.append(x)
            x = getattr(self, f"merge_{i}")(x)
        x = self._run_level(x, self.levels[-1], "mid", cond_vec, aux)
        for i, spec in reversed(list(enumerate(self.levels[:-1]))):
            x = getattr(self, f"split_{i}")(x, skips.pop())
            x = self._run_level(x, spec, f"up_{i}", cond_vec, aux)

        x = self.patch_out(self.norm_out(x))
        b, h, w, _ = x.shape
        p, c = self.patch_size, self.channels
        x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, c)
        v = x.float()
        if not return_aux:
            return v
        stack = lambda i: (torch.stack([a[i] for a in aux]) if aux  # noqa: E731
                           else x.new_zeros(0, dtype=torch.float32))
        return v, {"moe_aux": stack(0), "moe_dropped": stack(1)}


def hdit_from_config(config, channels: int, n_classes: int, dtype=torch.float32,
                     dual_time: bool = False, ring_axis_size: int = 1) -> HDiT:
    """An HDiT from the flat flow-section keys (``ldcfg`` precedence), with
    the JAX function's defaults: two levels (2, 256, 768) and (4, 512,
    1536), global attention with d_head 64, patch 4. ``hdit_attns`` entries
    are 'global' or 'na[:k]'; ``hdit_moe_experts`` (per level, 0 = dense)
    turns a level's feed-forward blocks into MoE blocks; ``ring_axis_size``
    > 1 makes the global levels' attention the ring."""
    from ..config import ldcfg

    depths = [int(d) for d in ldcfg(config, "hdit_depths", [2, 4])]
    widths = [int(w) for w in ldcfg(config, "hdit_widths", [256, 512])]
    d_ffs = [int(f) for f in ldcfg(config, "hdit_d_ffs", [3 * w for w in widths])]
    d_head = int(ldcfg(config, "hdit_d_head", 64))
    attns = [str(a) for a in ldcfg(config, "hdit_attns", ["global"] * len(depths))]
    moes = [int(m) for m in ldcfg(config, "hdit_moe_experts", [0] * len(depths))]
    moe_top_k = int(ldcfg(config, "hdit_moe_top_k", 2))
    moe_cap = float(ldcfg(config, "hdit_moe_capacity", 1.25))
    if not len(depths) == len(widths) == len(d_ffs) == len(attns) == len(moes):
        raise SystemExit("hdit_depths/hdit_widths/hdit_d_ffs/hdit_attns/"
                         "hdit_moe_experts must have equal lengths")
    levels = []
    for depth, width, d_ff, attn, moe in zip(depths, widths, d_ffs, attns, moes):
        if attn.startswith("na"):
            k = int(attn.split(":", 1)[1]) if ":" in attn else 7
            spec = NeighborhoodAttentionSpec(d_head=d_head, kernel_size=k)
        else:
            spec = GlobalAttentionSpec(d_head=d_head)
        levels.append(LevelSpec(depth=depth, width=width, d_ff=d_ff, self_attn=spec,
                                moe_experts=moe, moe_top_k=moe_top_k,
                                moe_capacity=moe_cap))
    mapping = MappingSpec(depth=int(ldcfg(config, "hdit_mapping_depth", 2)),
                          width=int(ldcfg(config, "hdit_mapping_width", 256)),
                          d_ff=int(ldcfg(config, "hdit_mapping_d_ff", 768)))
    return HDiT(levels=tuple(levels), mapping=mapping, channels=channels,
                patch_size=int(ldcfg(config, "hdit_patch_size", 4)),
                n_classes=n_classes, dual_time=dual_time, dtype=dtype,
                pp_stages=int(ldcfg(config, "hdit_pp_stages", 0)),
                ring_axis_size=ring_axis_size)
