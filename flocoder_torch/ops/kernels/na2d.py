"""Python side of K1, the hand-written Hopper NA2D forward kernel
(``flocoder_torch/csrc/na2d_fwd.cu``; replaces the Pallas TPU kernel
``flocoder_tpu/ops/pallas/na2d.py:_na2d_kernel``).

``na2d_fwd`` (an ``NA2DForward``) validates its inputs, builds the kernel at
first use, allocates the output and launches on PyTorch's current stream.
Its plain twin is ``flocoder_torch.ops.neighborhood_attention.na2d_banded``;
the dispatcher there sends CPU tensors to the twin and CUDA tensors here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import BUILD_DIR, build_library

__all__ = ["NA2DForward", "na2d_fwd", "pick_tile", "smem_bytes"]

_SOURCE = "na2d_fwd.cu"
_TEAM = 8                # threads per query in the kernel
_MAX_QUERIES = 64        # queries per block: 64 * 8 = 512 threads
# Two blocks per SM: 2 * (budget + 1 KB reserved per block) <= 228 KB.
_SMEM_BUDGETS = (113 * 1024, 227 * 1024)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(tile_h: int, tile_w: int, H: int, W: int, dh: int,
               ks: int) -> int:
    """Shared memory of one block: the fp32 K and V halo, rows padded to
    dh + 8 floats (the kernel's layout)."""
    kh, kw = min(tile_h + ks - 1, H), min(tile_w + ks - 1, W)
    return 2 * kh * kw * (dh + _TEAM) * 4


def pick_tile(H: int, W: int, dh: int, ks: int) -> tuple:
    """Query tile (tile_h, tile_w) of one block. Minimises the K/V halo
    pixels staged over the whole map (each one a read of 2*dh values from
    device memory), counting a padded query of a ragged tile as ks^2 staged
    pixels; ties go to the larger, then the wider tile. Prefers tiles whose
    halo lets two blocks share an SM, else takes the largest that fits one."""
    for budget in _SMEM_BUDGETS:
        best = None
        for th in range(1, min(H, _MAX_QUERIES) + 1):
            for tw in range(1, min(W, _MAX_QUERIES // th) + 1):
                if smem_bytes(th, tw, H, W, dh, ks) > budget:
                    continue
                n_tiles = math.ceil(H / th) * math.ceil(W / tw)
                staged = n_tiles * min(th + ks - 1, H) * min(tw + ks - 1, W)
                padded = n_tiles * th * tw - H * W
                key = (staged + padded * ks * ks, -th * tw, -tw)
                if best is None or key < best[0]:
                    best = (key, (th, tw))
        if best is not None:
            return best[1]
    raise ValueError(f"na2d kernel: a {ks}x{ks} window at dh={dh} does not "
                     "fit in shared memory")


class NA2DForward:
    """Launches K1. ``launches`` counts kernel launches (nothing else adds
    to it), so a run can show that it went through the kernel."""

    def __init__(self, build_dir: str = BUILD_DIR):
        self.build_dir = build_dir
        self.launches = 0
        self._fn = None

    def build(self):
        """Compile (if needed) and load the kernel library; returns its C
        entry point. Raises RuntimeError when it cannot be built."""
        if self._fn is None:
            lib = ctypes.CDLL(build_library(_SOURCE, self.build_dir))
            fn = lib.na2d_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kernel_size: int = 7, heads: int = 8,
                 scale: Optional[float] = None) -> torch.Tensor:
        _check(q, k, v, heads)
        B, H, W, C = q.shape
        dh = C // heads
        ks = min(kernel_size, H, W)
        if ks < 1:
            raise ValueError(f"na2d kernel: kernel_size must be >= 1, got {kernel_size}")
        if scale is None:
            scale = dh ** -0.5
        tile_h, tile_w = pick_tile(H, W, dh, ks)
        fn = self.build()
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            self.launches += 1
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _DTYPES[q.dtype], B, H, W, heads, dh, ks, tile_h, tile_w,
                     float(scale), stream)
        if err != 0:
            raise RuntimeError(f"na2d kernel launch failed: cudaError {err} "
                               f"(shape {tuple(q.shape)}, heads {heads}, "
                               f"tile {tile_h}x{tile_w})")
        return out


def _check(q, k, v, heads: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"na2d kernel: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("na2d kernel: q, k, v are on different devices")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"na2d kernel: {name} has dtype {t.dtype}; q, k, v "
                            "must all be float32 or all bfloat16")
        if t.dim() != 4 or tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"na2d kernel: {name} has shape {tuple(t.shape)}; "
                             "q, k, v must share one NHWC (B, H, W, C) shape")
        if not t.is_contiguous():
            raise ValueError(f"na2d kernel: {name} is not contiguous")
    C = q.shape[-1]
    if heads < 1 or C % heads:
        raise ValueError(f"na2d kernel: C={C} is not divisible by heads={heads}")
    dh = C // heads
    if dh % _TEAM or dh > 16 * _TEAM:
        raise ValueError(f"na2d kernel: head dim {dh} must be a multiple of "
                         f"{_TEAM} and at most {16 * _TEAM}")
    if min(q.shape) < 1:
        raise ValueError(f"na2d kernel: empty input {tuple(q.shape)}")


na2d_fwd = NA2DForward()
