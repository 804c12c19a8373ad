"""Sampling orchestration, PyTorch port of the serving half of
``flocoder_tpu/evaluation.py``: ``decode_latents``, ``sampler`` and
``make_e2e_sampler``, on one device.

The JAX package fuses generate + decode into one cached XLA executable and
can shard it over a mesh; PyTorch runs eagerly, so here the model, the
codec and the generator simply live on one device. ``evaluate_model`` and
the sharded serving branch are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .metrics import g2rgb
from .sampling import generate_latents

__all__ = ["decode_latents", "sampler", "make_e2e_sampler"]


@torch.inference_mode()
def decode_latents(codec, latents: torch.Tensor, is_midi: bool = False,
                   keep_gray: bool = False, chunk_size: int = 128):
    """Chunked decode with MIDI g2rgb post-processing."""
    outs = []
    for i in range(0, latents.shape[0], chunk_size):
        dec = codec.decode(latents[i:i + chunk_size])
        outs.append(g2rgb(dec, keep_gray=keep_gray) if is_midi else dec)
    return torch.cat(outs, dim=0)


@torch.inference_mode()
def sampler(model_apply: Callable, codec, generator: torch.Generator,
            method: str = "rk4", batch_size: int = 256, n_steps: int = 100,
            cond: Optional[dict] = None, n_classes: int = 0,
            latent_shape=(16, 16, 4), cfg_strength: float = 3.0,
            is_midi: bool = False, keep_gray: bool = False, source=None,
            init_image=None, init_latents=None, init_strength: float = 0.0,
            t_scale: float = 999.0):
    """Generate latents with ``model_apply(x, t, cond)`` and decode them.
    Everything runs on ``generator.device``. ``latent_shape`` is (H, W, C)
    NHWC. With ``n_classes > 0`` and no class condition, samples get the
    10-column class grid. Returns ``(pred_latents, decoded_pred, nfe)``."""
    device = generator.device
    if init_latents is None and init_image is not None:
        if isinstance(init_image, str):
            from PIL import Image
            img = Image.open(init_image).convert("RGB")
            init_image = torch.from_numpy(
                np.asarray(img, np.float32) / 255.0)[None]
        init_latents = codec.encode(init_image.to(device))
    if init_latents is not None and init_latents.shape[0] == 1 and batch_size > 1:
        init_latents = init_latents.expand(batch_size, -1, -1, -1)
    if init_latents is not None:
        init_latents = init_latents[:batch_size]
    if source is not None:
        source = source[:batch_size]

    cond = dict(cond) if cond else {}
    if cond.get("class_cond") is None and n_classes > 0:
        # class grid: 10 columns each a single class
        cols = torch.randint(0, n_classes, (10,), generator=generator,
                             device=device)
        cond["class_cond"] = cols.repeat(-(-batch_size // 10))[:batch_size]
    elif cond.get("class_cond") is not None:
        cond["class_cond"] = cond["class_cond"][:batch_size]
    if not cond or all(v is None for v in cond.values()):
        cond = None

    shape = (batch_size,) + tuple(latent_shape)
    pred_latents, nfe = generate_latents(
        model_apply, shape, generator, method=method, n_steps=n_steps,
        cond=cond, cfg_strength=cfg_strength, source=source,
        init_latents=init_latents, init_strength=init_strength,
        t_scale=t_scale)
    decoded = decode_latents(codec, pred_latents, is_midi=is_midi,
                             keep_gray=keep_gray)
    return pred_latents, decoded, nfe


def make_e2e_sampler(model_apply: Callable, codec, latent_shape,
                     batch_size: int, method: str = "rk4", n_steps: int = 50,
                     cfg_strength: float = 3.0, n_classes: int = 0,
                     t_scale: float = 999.0, warp_s: float = 0.5):
    """The end-to-end serving function
    ``f(generator, class_cond) -> (latents, images)``: the whole ODE
    integration, then the codec decode."""

    @torch.inference_mode()
    def f(generator: torch.Generator, class_cond=None):
        cond = ({"class_cond": class_cond, "mask_cond": None}
                if n_classes > 0 else None)
        latents, _ = generate_latents(
            model_apply, (batch_size,) + tuple(latent_shape), generator,
            method=method, n_steps=n_steps, cond=cond,
            cfg_strength=cfg_strength, t_scale=t_scale, warp_s=warp_s)
        return latents, codec.decode(latents)

    return f
