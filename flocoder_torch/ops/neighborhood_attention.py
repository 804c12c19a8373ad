"""2-D neighborhood (local-window) attention, PyTorch port of
``flocoder_tpu/ops/neighborhood_attention.py``.

- ``na2d_reference``: exact clamped-window semantics via gathers, the
  correctness oracle.
- ``na2d_banded``: the dense row-band formulation in plain torch, the plain
  twin of the CUDA kernel K1 and what CPU tensors run.
- ``na2d``: dispatch by device. A CPU tensor runs ``na2d_banded``; a CUDA
  tensor runs K1 (``ops/kernels/na2d.py``) or raises. There is no fallback
  from the kernel to the plain version.

Window semantics match NATTEN: every query attends to exactly k×k keys; at
borders the window slides inward (clamped), it does not shrink. NHWC
tensors, C = heads · head_dim.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels.na2d import na2d_fwd

__all__ = ["na2d", "na2d_reference", "na2d_banded", "window_starts"]


def window_starts(n: int, kernel_size: int, device=None) -> torch.Tensor:
    """Clamped window start index for each of n query positions."""
    pos = torch.arange(n, device=device)
    return torch.clamp(pos - kernel_size // 2, 0, n - kernel_size)


def na2d_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kernel_size: int = 7, heads: int = 8,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact neighborhood attention on NHWC tensors via gathers.
    q, k, v: (B, H, W, C) with C = heads * head_dim. Returns (B, H, W, C)."""
    B, H, W, C = q.shape
    ks = min(kernel_size, H, W)
    dh = C // heads
    if scale is None:
        scale = dh ** -0.5
    dev = q.device
    ar = torch.arange(ks, device=dev)
    rows = window_starts(H, ks, dev)[:, None] + ar[None, :]   # (H, ks)
    cols = window_starts(W, ks, dev)[:, None] + ar[None, :]   # (W, ks)

    def gather_windows(x):
        xw = x[:, rows]                  # (B, H, ks, W, C)
        xw = xw[:, :, :, cols]           # (B, H, ks, W, ks, C)
        xw = xw.movedim(2, 3)            # (B, H, W, ks, ks, C)
        return xw.reshape(B, H, W, ks * ks, heads, dh)

    kw, vw = gather_windows(k), gather_windows(v)
    qh = q.reshape(B, H, W, heads, dh) * scale
    logits = torch.einsum("bhwnd,bhwknd->bhwnk", qh.float(), kw.float())
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhwnk,bhwknd->bhwnd", attn, vw)
    return out.reshape(B, H, W, C)


def na2d_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kernel_size: int = 7, heads: int = 8,
                scale: Optional[float] = None,
                tile_h: int = 8) -> torch.Tensor:
    """Dense-banded neighborhood attention in plain torch: queries are
    grouped into row bands, each band attends densely to its
    (tile_h + ks − 1)-row key halo under the clamped-window mask, softmax
    in fp32 (the formulation of ``flocoder_tpu``'s ``na2d_banded``)."""
    B, H, W, C = q.shape
    ks = min(kernel_size, H, W)
    dh = C // heads
    if scale is None:
        scale = dh ** -0.5
    th = tile_h
    while H % th:
        th //= 2
    th = max(th, 1)
    nb = H // th
    KH = min(th + ks - 1, H)
    dev = q.device

    band_r0 = torch.arange(nb, device=dev) * th                          # (nb,)
    halo_start = torch.clamp(band_r0 - ks // 2, 0, H - KH)               # (nb,)
    halo_rows = halo_start[:, None] + torch.arange(KH, device=dev)[None]  # (nb, KH)

    qb = q.reshape(B, nb, th, W, heads, dh)
    kb = k[:, halo_rows].reshape(B, nb, KH, W, heads, dh)
    vb = v[:, halo_rows].reshape(B, nb, KH, W, heads, dh)

    scores = torch.einsum("bntwhd,bnkxhd->bnhtwkx", (qb * scale).float(),
                          kb.float())
    qi = band_r0[:, None] + torch.arange(th, device=dev)[None]           # (nb, th)
    rs = torch.clamp(qi - ks // 2, 0, H - ks)                            # (nb, th)
    wi = torch.arange(W, device=dev)
    cs = torch.clamp(wi - ks // 2, 0, W - ks)                            # (W,)
    row_ok = ((halo_rows[:, None, :] >= rs[:, :, None]) &
              (halo_rows[:, None, :] < rs[:, :, None] + ks))             # (nb, th, KH)
    col_ok = (wi[None, :] >= cs[:, None]) & (wi[None, :] < cs[:, None] + ks)  # (W, W)
    mask = row_ok[:, :, None, :, None] & col_ok[None, None, :, None, :]  # (nb,th,W,KH,W)
    scores = scores.masked_fill(~mask[None, :, None], float("-inf"))
    # softmax over the (KH, W) key axes jointly
    probs = torch.softmax(scores.flatten(-2), dim=-1).view_as(scores)
    out = torch.einsum("bnhtwkx,bnkxhd->bntwhd", probs.to(v.dtype), vb)
    return out.reshape(B, H, W, C)


def na2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         kernel_size: int = 7, heads: int = 8,
         scale: Optional[float] = None) -> torch.Tensor:
    """Neighborhood attention dispatched by device: CPU tensors run the
    plain ``na2d_banded``; any other device runs the CUDA kernel K1, which
    raises rather than falling back when it cannot run."""
    if q.device.type == "cpu":
        return na2d_banded(q, k, v, kernel_size=kernel_size, heads=heads,
                           scale=scale)
    return na2d_fwd(q, k, v, kernel_size=kernel_size, heads=heads,
                    scale=scale)
