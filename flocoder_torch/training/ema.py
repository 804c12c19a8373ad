"""EMA of a model's parameters, PyTorch port of
``flocoder_tpu/training/ema.py``: the shadow is a copy of the module on the
same device, updated after each optimizer step with one multiply-add per
tensor and no transfer."""
from __future__ import annotations

import copy

import torch
from torch import nn

__all__ = ["ema_init", "ema_update"]


def ema_init(model: nn.Module) -> nn.Module:
    """A frozen copy of ``model``."""
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    return ema


def _local(t: torch.Tensor) -> torch.Tensor:
    """An FSDP2 shard's local tensor (``to_local``); a tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float = 0.999) -> nn.Module:
    """shadow ← decay·shadow + (1 − decay)·params, in place; an FSDP-sharded
    model and its sharded EMA (the same placement) update shard by shard."""
    shadow = [_local(s) for s in ema.parameters()]
    params = [_local(p).to(s.dtype) for s, p in zip(shadow, model.parameters())]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, torch._foreach_mul(params, 1.0 - decay))
    return ema
