"""Shared pieces of the port's models: linen-style submodule naming, flax's
compute-dtype layers and a seeded parameter init.

Submodules are registered under the names flax linen gives the JAX
package's modules (``Conv_0``, ``GroupNorm_1``, ``ResnetBlock_3``, ...), so a
torch ``state_dict`` key is the JAX parameter path with ``.`` for ``/``, and
the weight bridge (``training/checkpoint.py``) needs no table of names.

``Conv``, ``Dense`` and ``GroupNorm`` follow flax's ``dtype=`` semantics
where a ``compute_dtype`` other than the parameters' is set: the parameters
stay fp32; Conv and Dense cast the input, the weight and the bias to the
compute dtype and add the bias after the product is rounded; GroupNorm takes
its statistics and normalises in fp32 and gives the compute dtype. With no
compute dtype (None) or the parameters' own they are the plain torch
layers, in whatever dtype the parameters are (a float64 copy computes in
float64).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Scope", "Conv", "Dense", "GroupNorm", "SiLU", "silu", "leaky_relu", "weak",
           "conv", "group_norm", "init_params"]


class Scope:
    """Registers submodules on ``owner`` under linen's auto-names: the class
    kind plus a per-kind counter in creation order. Explicitly named modules
    do not advance a counter (as in linen)."""

    def __init__(self, owner: nn.Module):
        self.owner = owner
        self.counts: dict = {}

    def add(self, kind: str, module: nn.Module, name: str = None) -> nn.Module:
        if name is None:
            i = self.counts.get(kind, 0)
            self.counts[kind] = i + 1
            name = f"{kind}_{i}"
        self.owner.add_module(name, module)
        return module

    def conv(self, cin: int, cout: int, kernel: int, stride: int = 1,
             bias: bool = True, name: str = None, dtype=None) -> nn.Conv2d:
        return self.add("Conv", conv(cin, cout, kernel, stride, bias, dtype), name)

    def gn(self, groups: int, channels: int, eps: float) -> nn.GroupNorm:
        return self.add("GroupNorm", group_norm(groups, channels, eps))

    def dense(self, cin: int, cout: int, bias: bool = True, dtype=None) -> nn.Linear:
        return self.add("Dense", Dense(cin, cout, bias=bias, dtype=dtype))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (None: the parameters'
    dtype), with flax's casts and the bias added after rounding."""

    compute_dtype = None

    def forward(self, x):
        return self.conv_with(x, self.weight)

    def conv_with(self, x, weight):
        """``x`` convolved with ``weight`` (in this conv's layout, e.g. a
        spectrally normalised copy of its own) plus this conv's bias, in the
        compute dtype."""
        dt = self.compute_dtype
        if dt is None or dt == weight.dtype:
            return self._conv_forward(x, weight, self.bias)
        y = self._conv_forward(x.to(dt), weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` whose statistics and normalisation run in fp32 and
    whose output is ``compute_dtype`` (None: the input's dtype), as flax's
    ``GroupNorm(dtype=...)``."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None or dt == x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(dt)


class Dense(nn.Linear):
    """flax ``nn.Dense`` with a compute dtype: the input, the fp32 weight
    and the bias are cast to ``compute_dtype`` (None: the weight's dtype),
    and the bias is added after the product is rounded to it, as flax does.
    ``zero_init`` marks the projections the JAX module initialises to
    zero."""

    def __init__(self, cin: int, cout: int, bias: bool = False,
                 dtype=torch.float32, zero_init: bool = False):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype, self.zero_init = dtype, zero_init

    def init_special_(self, generator):
        if self.zero_init:
            self.weight.data.zero_()

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        if dt == self.weight.dtype:
            return F.linear(x.to(dt), self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def weak(c: float, like: torch.Tensor) -> float:
    """The Python scalar ``c`` as JAX uses it beside an array: rounded to
    the array's dtype first (a weak type). ``x * weak(c, x)`` then rounds
    the product once, as XLA does; torch alone would multiply by ``c`` in
    fp32."""
    return float(torch.tensor(c, dtype=like.dtype))


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope · x)`` with the slope
    rounded to x's dtype (``weak``); in fp32 and wider ``F.leaky_relu``."""
    if x.dtype in (torch.float32, torch.float64):
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * weak(slope, x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x · (1 / (1 + exp(-x)))``. In bf16 every operation
    rounds to bf16, as XLA computes it there (``F.silu`` rounds once and
    differs in about a third of the values); in fp32 and wider ``F.silu``."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


class SiLU(nn.Module):
    """``silu`` as a module."""

    def forward(self, x):
        return silu(x)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = True, dtype=None) -> Conv:
    """A flax ``nn.Conv`` as used by the JAX package: 1×1 kernels unpadded,
    3×3 and 5×5 padded to 'same' size (``padding=1``/``2``); ``dtype`` the
    compute dtype (None: the parameters')."""
    c = Conv(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=bias)
    c.compute_dtype = dtype
    return c


def group_norm(groups: int, channels: int, eps: float, dtype=None) -> GroupNorm:
    g = GroupNorm(groups, channels, eps=eps)
    g.compute_dtype = dtype
    return g


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init with flax's defaults: conv and dense kernels
    N(0, 1/fan_in) (lecun normal), biases 0, GroupNorm scale 1 and bias 0,
    embeddings N(0, 1). Afterwards every submodule that defines
    ``init_special_(generator)`` applies its own (zero-init gates and
    projections, as the JAX modules declare them). Draws on the generator's
    device and copies into the parameters; returns ``module``."""
    dev = generator.device
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator, device=dev)
            m.weight.copy_(w * math.sqrt(1.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                       device=dev))
    for m in module.modules():
        special = getattr(m, "init_special_", None)
        if special is not None:
            special(generator)
    return module
