"""Device choice for the port's entry points: the CUDA card unless the
caller asks for the CPU. There is no silent fallback to the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when a CUDA device is asked for and
    none is available; pass ``device='cpu'`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; flocoder_torch runs "
                           "on the card unless asked for the CPU "
                           "(device='cpu', or +device=cpu on the command line)")
    return dev
