"""Python side of the hand-written Hopper NA2D kernels:

- K1, the forward (``flocoder_torch/csrc/na2d_fwd.cu``; replaces the Pallas
  TPU kernel ``flocoder_tpu/ops/pallas/na2d.py:_na2d_kernel``), launched by
  ``na2d_fwd`` (an ``NA2DForward``);
- K2, the backward (``flocoder_torch/csrc/na2d_bwd.cu``; replaces
  ``_na2d_bwd_kernel`` of the same file), launched by ``na2d_bwd`` (an
  ``NA2DBackward``).

Each wrapper validates its inputs, builds its kernel at first use, allocates
the outputs and launches on PyTorch's current stream. The plain twins are
``na2d_banded`` and ``na2d_bwd_banded`` in
``flocoder_torch.ops.neighborhood_attention``; the dispatcher there sends CPU
tensors to the twins and CUDA tensors here, through ``NA2DFunction``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .build import Kernel

__all__ = ["NA2DForward", "NA2DBackward", "na2d_fwd", "na2d_bwd", "pick_tile",
           "smem_bytes"]

_TEAM = 8                # threads per query in the kernels
_MAX_QUERIES = 64        # queries per block: 64 * 8 = 512 threads
# Two blocks per SM: 2 * (budget + 1 KB reserved per block) <= 228 KB.
_SMEM_BUDGETS = (113 * 1024, 227 * 1024)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _halo(H: int, W: int, tile_h: int, tile_w: int, ks: int) -> tuple:
    return min(tile_h + ks - 1, H), min(tile_w + ks - 1, W)


def smem_bytes(tile_h: int, tile_w: int, H: int, W: int, dh: int,
               ks: int) -> int:
    """Shared memory of one block of K1 (and of K2's first pass): the fp32
    K and V halo of a query tile, rows padded to dh + 8 floats."""
    hh, hw = _halo(H, W, tile_h, tile_w, ks)
    return 2 * hh * hw * (dh + _TEAM) * 4


@functools.lru_cache(maxsize=None)
def pick_tile(H: int, W: int, dh: int, ks: int) -> tuple:
    """Query tile (tile_h, tile_w) of one block of K1 (and of K2's first
    pass; K2's second pass picks its own key tile in csrc/na2d_bwd.cu).
    Minimises the halo pixels staged over the whole map (each one a read of
    2*dh values from device memory), counting a padded entry of a ragged
    tile as ks^2 staged pixels; ties go to the larger, then the wider tile.
    Prefers tiles whose halo lets two blocks share an SM, else takes the
    largest that fits one. Cached: the search takes longer on the host than
    a launch takes on the card."""
    for budget in _SMEM_BUDGETS:
        best = None
        for th in range(1, min(H, _MAX_QUERIES) + 1):
            for tw in range(1, min(W, _MAX_QUERIES // th) + 1):
                if smem_bytes(th, tw, H, W, dh, ks) > budget:
                    continue
                n_tiles = math.ceil(H / th) * math.ceil(W / tw)
                staged = n_tiles * math.prod(_halo(H, W, th, tw, ks))
                padded = n_tiles * th * tw - H * W
                key = (staged + padded * ks * ks, -th * tw, -tw)
                if best is None or key < best[0]:
                    best = (key, (th, tw))
        if best is not None:
            return best[1]
    raise ValueError(f"na2d kernel: a {ks}x{ks} window at dh={dh} does not "
                     "fit in shared memory")


def _window(q: torch.Tensor, kernel_size: int, heads: int,
            scale: Optional[float]) -> tuple:
    B, H, W, C = q.shape
    dh = C // heads
    ks = min(kernel_size, H, W)
    if ks < 1:
        raise ValueError(f"na2d kernel: kernel_size must be >= 1, got {kernel_size}")
    return B, H, W, dh, ks, dh ** -0.5 if scale is None else scale


class NA2DForward(Kernel):
    """Launches K1: ``na2d_fwd(q, k, v, kernel_size, heads, scale) -> out``."""

    _source = "na2d_fwd.cu"
    _entry = "na2d_fwd"
    _argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kernel_size: int = 7, heads: int = 8,
                 scale: Optional[float] = None) -> torch.Tensor:
        _check(heads, q=q, k=k, v=v)
        B, H, W, dh, ks, scale = _window(q, kernel_size, heads, scale)
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


class NA2DBackward(Kernel):
    """Launches K2: ``na2d_bwd(q, k, v, o, g, kernel_size, heads, scale) ->
    (dq, dk, dv)``, with ``o`` K1's output for (q, k, v) and ``g`` the
    gradient of the loss with respect to it. One call is one launch of the
    kernel, which runs as two grid passes on the stream (dq over K1's query
    tiles, then dk and dv over key tiles that the C entry picks); the
    wrapper allocates their fp32 scratch (log-sum-exp and delta, one value
    per pixel and head)."""

    _source = "na2d_bwd.cu"
    _entry = "na2d_bwd"
    _argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, g: torch.Tensor, kernel_size: int = 7,
                 heads: int = 8, scale: Optional[float] = None) -> tuple:
        _check(heads, q=q, k=k, v=v, o=o, g=g)
        B, H, W, dh, ks, scale = _window(q, kernel_size, heads, scale)
        tile_h, tile_w = pick_tile(H, W, dh, ks)
        fn = self.build()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        lse, delta = (torch.empty(B, H, W, heads, device=q.device,
                                  dtype=torch.float32) for _ in range(2))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            self.launches += 1
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], B, H,
                     W, heads, dh, ks, tile_h, tile_w, float(scale), stream)
        if err != 0:
            raise RuntimeError(f"na2d backward kernel launch failed: cudaError "
                               f"{err} (shape {tuple(q.shape)}, heads {heads}, "
                               f"query tile {tile_h}x{tile_w})")
        return dq, dk, dv


def _check(heads: int, **tensors) -> None:
    q = tensors["q"]
    names = ", ".join(tensors)
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"na2d kernel: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"na2d kernel: {names} are on different devices")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"na2d kernel: {name} has dtype {t.dtype}; {names} "
                            "must all be float32 or all bfloat16")
        if t.dim() != 4 or tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"na2d kernel: {name} has shape {tuple(t.shape)}; "
                             f"{names} must share one NHWC (B, H, W, C) shape")
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
na2d_bwd = NA2DBackward()
