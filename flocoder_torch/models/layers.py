"""Shared pieces of the port's models: linen-style submodule naming and a
seeded parameter init.

Submodules are registered under the names flax linen gives the JAX
package's modules (``Conv_0``, ``GroupNorm_1``, ``ResnetBlock_3``, ...), so a
torch ``state_dict`` key is the JAX parameter path with ``.`` for ``/``, and
the weight bridge (``training/checkpoint.py``) needs no table of names.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Scope", "conv", "group_norm", "init_params"]


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
             bias: bool = True, name: str = None) -> nn.Conv2d:
        return self.add("Conv", conv(cin, cout, kernel, stride, bias), name)

    def gn(self, groups: int, channels: int, eps: float) -> nn.GroupNorm:
        return self.add("GroupNorm", group_norm(groups, channels, eps))

    def dense(self, cin: int, cout: int, bias: bool = True) -> nn.Linear:
        return self.add("Dense", nn.Linear(cin, cout, bias=bias))


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """A flax ``nn.Conv`` as used by the JAX package: 1×1 kernels unpadded,
    3×3 and 5×5 padded to 'same' size (``padding=1``/``2``)."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=bias)


def group_norm(groups: int, channels: int, eps: float) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=eps)


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
        if isinstance(m, (nn.Conv2d, nn.Linear)):
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
