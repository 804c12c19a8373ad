"""Metrics, PyTorch port of ``flocoder_tpu/metrics.py``. This slice ports
only ``g2rgb``, the MIDI recipes' decode post-processing; the losses and
sample metrics are not ported yet (ROADMAP.md)."""
from __future__ import annotations

import torch

__all__ = ["g2rgb"]


def g2rgb(gf_img: torch.Tensor, keep_gray: bool = False) -> torch.Tensor:
    """Grayscale float → quantized RGB piano roll. NHWC; a 3-channel input
    passes through."""
    if gf_img.shape[-1] == 3:
        return gf_img
    gf = gf_img[..., 0]
    if keep_gray:
        return (gf > 0.5).float()[..., None].expand(*gf.shape, 3)
    return torch.stack([(gf >= 0.75).float(),
                        ((gf - 0.5).abs() < 0.25).float(),
                        torch.zeros_like(gf)], dim=-1)
