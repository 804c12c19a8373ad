"""The velocity field a flow config asks for: the U-Net or, with
``flow.arch=hdit``, the Hourglass DiT. ``train_flow``, ``generate_samples``
and ``evaluate_model`` build their model here, so an HDiT checkpoint trains,
serves and evaluates alike. ``ring_twin`` gives ``train_flow``'s
``flow.ring_attention`` its training model: the same parameters, with the
global attention sites run as the ring over the mesh's model axis (the JAX
script's ``model.clone(ring_axis=..., ring_axis_size=...)``)."""
from __future__ import annotations

import copy

import torch
from torch import nn

from .hdit import hdit_from_config
from .unet import Unet

__all__ = ["build_flow_model", "flow_arch", "ring_twin"]


def ring_twin(model: nn.Module, ring_axis_size: int) -> nn.Module:
    """A twin of ``model`` that shares its parameters and buffers (the same
    tensors: a step on either moves both) and whose attention sites with a
    ``ring_axis_size`` run the ring over ``ring_axis_size`` model ranks.
    The serving model stays ring-free."""
    shared = {id(t): t for t in (*model.parameters(), *model.buffers())}
    twin = copy.deepcopy(model, shared)
    for m in twin.modules():
        if hasattr(m, "ring_axis_size"):
            m.ring_axis_size = ring_axis_size
    return twin


def flow_arch(config) -> str:
    """``flow.arch`` (``unet`` or ``hdit``), lower case."""
    from ..config import ldcfg
    return str(ldcfg(config, "arch", "unet")).lower()


def build_flow_model(config, channels: int, n_classes: int, dual_time: bool = False,
                     dtype=torch.float32, dim: int = 16,
                     mask_cond: bool = False) -> nn.Module:
    """The flow model of ``config`` for latents of ``channels`` channels.
    ``dim`` is the U-Net's base width (the scripts pass the latent height,
    as the JAX scripts do); ``mask_cond`` builds the U-Net's inpainting
    mask conditioning (a mask of ``channels`` channels). Both compute in
    ``dtype``; HDiT has no mask path. Parameters are fp32 on the CPU; the
    caller moves the model and initialises it."""
    from ..config import ldcfg
    arch = flow_arch(config)
    if arch == "hdit":
        if mask_cond:
            raise SystemExit("flow.arch=hdit has no mask-conditioning path; use "
                             "arch=unet for inpainting datasets")
        return hdit_from_config(config, channels=channels, n_classes=n_classes,
                                dtype=dtype, dual_time=dual_time)
    if arch != "unet":
        raise ValueError(f"unknown flow.arch {arch!r} (unet or hdit)")
    return Unet(dim=dim, channels=channels,
                dim_mults=tuple(ldcfg(config, "dim_mults", [1, 2, 4, 8])),
                n_classes=n_classes, dual_time=dual_time, mask_cond=mask_cond,
                mask_channels=channels, dtype=dtype)
