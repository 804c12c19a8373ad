"""2-D neighborhood (local-window) attention, PyTorch port of
``flocoder_tpu/ops/neighborhood_attention.py``.

- ``na2d_reference``: exact clamped-window semantics via gathers, the
  correctness oracle.
- ``na2d_banded``: the dense row-band formulation in plain torch, the plain
  twin of the CUDA kernel K1 and what CPU tensors run (under torch
  autograd).
- ``na2d_bwd_banded``: the plain twin of K2, the backward: the same formulas
  in plain torch, not autograd. Tests and ``chip_smoke.py`` use it.
- ``NA2DFunction``: the autograd Function of the card, K1 forward and K2
  backward (``ops/kernels/na2d.py``).
- ``na2d``: dispatch by device. A CPU tensor runs ``na2d_banded``; any other
  tensor runs ``NA2DFunction``, whose kernels build and launch or raise.
  There is no fallback from a kernel to a plain version.

Window semantics match NATTEN: every query attends to exactly k×k keys; at
borders the window slides inward (clamped), it does not shrink. NHWC
tensors, C = heads · head_dim.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels.na2d import na2d_bwd, na2d_fwd

__all__ = ["na2d", "na2d_reference", "na2d_banded", "na2d_bwd_banded",
           "NA2DFunction", "window_starts"]


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


def _bands(H: int, ks: int, tile_h: int, dev) -> tuple:
    """Row bands of ``na2d_banded``: band height, number of bands, halo
    height, the (nb, KH) halo rows and the (nb, th) clamped window starts of
    the bands' query rows."""
    th = tile_h
    while H % th:
        th //= 2
    th = max(th, 1)
    nb = H // th
    KH = min(th + ks - 1, H)
    band_r0 = torch.arange(nb, device=dev) * th
    halo_start = torch.clamp(band_r0 - ks // 2, 0, H - KH)
    halo_rows = halo_start[:, None] + torch.arange(KH, device=dev)[None]
    qi = band_r0[:, None] + torch.arange(th, device=dev)[None]
    return th, nb, KH, halo_rows, torch.clamp(qi - ks // 2, 0, H - ks)


def _band_mask(halo_rows, rs, W: int, ks: int, dev) -> torch.Tensor:
    """(nb, th, W, KH, W) clamped-window mask of the row bands."""
    wi = torch.arange(W, device=dev)
    cs = torch.clamp(wi - ks // 2, 0, W - ks)
    row_ok = ((halo_rows[:, None, :] >= rs[:, :, None]) &
              (halo_rows[:, None, :] < rs[:, :, None] + ks))
    col_ok = (wi[None, :] >= cs[:, None]) & (wi[None, :] < cs[:, None] + ks)
    return row_ok[:, :, None, :, None] & col_ok[None, None, :, None, :]


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
    dev = q.device
    th, nb, KH, halo_rows, rs = _bands(H, ks, tile_h, dev)
    qb = q.reshape(B, nb, th, W, heads, dh)
    kb = k[:, halo_rows].reshape(B, nb, KH, W, heads, dh)
    vb = v[:, halo_rows].reshape(B, nb, KH, W, heads, dh)
    scores = torch.einsum("bntwhd,bnkxhd->bnhtwkx", (qb * scale).float(),
                          kb.float())
    mask = _band_mask(halo_rows, rs, W, ks, dev)
    scores = scores.masked_fill(~mask[None, :, None], float("-inf"))
    # softmax over the (KH, W) key axes jointly
    probs = torch.softmax(scores.flatten(-2), dim=-1).view_as(scores)
    out = torch.einsum("bnhtwkx,bnkxhd->bntwhd", probs.to(v.dtype), vb)
    return out.reshape(B, H, W, C)


def na2d_bwd_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, g: torch.Tensor, kernel_size: int = 7,
                    heads: int = 8, scale: Optional[float] = None,
                    tile_h: int = 8) -> tuple:
    """The backward of ``na2d_banded`` by K2's formulas, in plain torch (no
    autograd): per row band P is recomputed, dP = g·Vᵀ, δ = g·o (o the
    forward output, = rowsum(P∘dP)), dS = P∘(dP − δ), dQ = dS·K·scale,
    dK = dSᵀ·(scale·Q), dV = Pᵀ·g; the bands' overlapping key halos are
    summed. fp32 throughout; returns (dq, dk, dv) in q's dtype."""
    B, H, W, C = q.shape
    ks = min(kernel_size, H, W)
    dh = C // heads
    if scale is None:
        scale = dh ** -0.5
    dev = q.device
    th, nb, KH, halo_rows, rs = _bands(H, ks, tile_h, dev)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    qb = qf.reshape(B, nb, th, W, heads, dh) * scale
    gb = gf.reshape(B, nb, th, W, heads, dh)
    kb = kf[:, halo_rows].reshape(B, nb, KH, W, heads, dh)
    vb = vf[:, halo_rows].reshape(B, nb, KH, W, heads, dh)
    mask = _band_mask(halo_rows, rs, W, ks, dev)[None, :, None]
    scores = torch.einsum("bntwhd,bnkxhd->bnhtwkx", qb, kb)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores.flatten(-2), dim=-1).view_as(scores)
    dp = torch.einsum("bntwhd,bnkxhd->bnhtwkx", gb, vb)
    delta = (gf * o.float()).reshape(B, nb, th, W, heads, dh).sum(-1)
    ds = probs * (dp - delta.permute(0, 1, 4, 2, 3)[..., None, None])
    dq = torch.einsum("bnhtwkx,bnkxhd->bntwhd", ds, kb) * scale
    dk_band = torch.einsum("bnhtwkx,bntwhd->bnkxhd", ds, qb)
    dv_band = torch.einsum("bnhtwkx,bntwhd->bnkxhd", probs, gb)
    rows = halo_rows.reshape(-1)

    def halo_sum(band):
        out = torch.zeros(B, H, W, heads, dh, device=dev)
        return out.index_add_(1, rows, band.reshape(B, nb * KH, W, heads, dh))

    return tuple(t.reshape(B, H, W, C).to(q.dtype)
                 for t in (dq, halo_sum(dk_band), halo_sum(dv_band)))


class NA2DFunction(torch.autograd.Function):
    """Neighborhood attention on the card with its gradient: forward K1,
    backward K2 (the kernels' wrappers in ``ops/kernels/na2d.py``). Saves
    q, k, v and K1's output, from which K2 takes δ = g·o."""

    @staticmethod
    def forward(ctx, q, k, v, kernel_size: int, heads: int,
                scale: Optional[float]):
        out = na2d_fwd(q, k, v, kernel_size=kernel_size, heads=heads,
                       scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.window = (kernel_size, heads, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        kernel_size, heads, scale = ctx.window
        dq, dk, dv = na2d_bwd(q, k, v, out, g.contiguous(),
                              kernel_size=kernel_size, heads=heads,
                              scale=scale)
        return dq, dk, dv, None, None, None


def na2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         kernel_size: int = 7, heads: int = 8,
         scale: Optional[float] = None) -> torch.Tensor:
    """Neighborhood attention dispatched by device: CPU tensors run the
    plain ``na2d_banded`` under torch autograd; any other device runs
    ``NA2DFunction`` (K1 forward, K2 backward), which raises rather than
    falling back when a kernel cannot run."""
    if q.device.type == "cpu":
        return na2d_banded(q, k, v, kernel_size=kernel_size, heads=heads,
                           scale=scale)
    return NA2DFunction.apply(q, k, v, kernel_size, heads, scale)
