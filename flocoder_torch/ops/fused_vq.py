"""The codec's compression tail fused with the residual-VQ (RVQ) search, the
port of ``flocoder_tpu/ops/pallas/fused_vq.py`` and of the debug tail in
``benchmarks/fused_probe.py``.

- ``fused_compress_vq`` (K4), ``fused_compress_tail_vq`` (K3) and
  ``compress_tail_debug`` (K5) dispatch by device: a CPU tensor runs the
  plain twin, any other runs the hand-written kernel
  (``ops/kernels/fused_vq.py``; K3's bf16 case for bf16 ``h``), which
  launches or raises. There is no fallback from a kernel to a twin.
- K3 takes ``h`` in fp32 or bf16, as the TPU kernel does: bf16 is widened
  to fp32 before the tail, and ``z_q`` comes back in ``h``'s dtype.
- The twins, ``*_plain``, are plain torch ops in fp32 with the TPU kernels'
  arithmetic: distances ``r2 + c2 - 2·(r @ cᵀ)``, the first minimum (a
  NaN token picks nothing: index 0, nothing added), the pick subtracted
  from the residual, and ``z_q`` the
  exact sum of the picked codes (no rotation trick: this is the inference
  path). GroupNorm takes two passes (mean, then mean squared deviation), as
  the kernels do; the TPU kernels take E[y²] − m².
- fp64 references for the checks, the port's own copy of
  ``fused_probe.py``'s oracles: ``compress_tail_oracle`` and
  ``rvq_pick_gaps``; ``check_picks`` applies the criterion that picks equal
  a reference's or are ε-optimal under the fp64 distances, and
  ``check_quantized`` adds z_q where the picks agree. ``random_vq_inputs``
  and ``random_tail_inputs`` make seeded inputs for those checks.

Layouts are the TPU functions' except for the convolution weights: ``h`` is
NHWC (B, H, W, Din), while ``w1`` and ``conv_w`` are the port's OIHW conv
weights, (D, Din, 1, 1) and (D, D, 3, 3), where JAX takes (Din, D) and HWIO.
``fused_compress_vq``'s ``w`` is (Din, D), as in JAX. Indices are int32, as
JAX's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels import fused_vq as _kernels

__all__ = ["fused_compress_vq", "fused_compress_tail_vq", "compress_tail_debug",
           "rvq_search_plain", "fused_compress_vq_plain",
           "fused_compress_tail_vq_plain", "compress_tail_debug_plain",
           "compress_tail_oracle", "rvq_pick_gaps", "check_picks", "check_quantized",
           "random_vq_inputs", "random_tail_inputs"]


def rvq_search_plain(x: torch.Tensor, codebooks: torch.Tensor) -> tuple:
    """Greedy RVQ of tokens ``x`` (N, D) over ``codebooks`` (L, K, D):
    ``(z_q (N, D), idx (N, L) int32)``. Each level picks the first code
    whose distance is the row's minimum, as the TPU kernels' one-hot does;
    a row with a NaN distance (a NaN token) has no such code, so that level
    adds nothing to z_q and records index 0."""
    residual = x
    z_q = torch.zeros_like(x)
    picks = []
    for cb in codebooks:
        K = cb.shape[0]
        d = ((residual * residual).sum(1, keepdim=True) + (cb * cb).sum(1)[None]
             - 2.0 * (residual @ cb.T))
        lane = torch.arange(K, device=d.device)
        first = torch.where(d <= d.amin(1, keepdim=True), lane, K).amin(1)
        found = first < K
        q = torch.where(found[:, None], cb[first.clamp(max=K - 1)], 0.0)
        z_q = z_q + q
        residual = residual - q
        picks.append(torch.where(found, first, 0))
    return z_q, torch.stack(picks, 1).to(torch.int32)


def fused_compress_vq_plain(z, w, b, codebooks) -> tuple:
    """K4's twin: ``z`` (N, Din) · ``w`` (Din, D) + ``b``, then the RVQ
    search."""
    return rvq_search_plain(z @ w + b, codebooks)


def compress_tail_debug_plain(h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                              groups: int, eps: float = 1e-5) -> tuple:
    """K5's twin: 1×1 conv → GroupNorm (per image, biased variance) → SiLU
    → 3×3 conv with padding 1. Returns ``(y1, y2, out)``, each (B·H·W, D)
    in row-major (b, y, x) order."""
    B, H, W, Din = h.shape
    D = w1.shape[0]
    y1 = h.reshape(B, H * W, Din) @ w1.reshape(D, Din).T + b1
    y = y1.reshape(B, H * W, groups, D // groups)
    m = y.mean(dim=(1, 3), keepdim=True)
    v = ((y - m) ** 2).mean(dim=(1, 3), keepdim=True)
    yn = ((y - m) * (1.0 / torch.sqrt(v + eps))).reshape(B, H * W, D)
    y2 = F.silu(yn * gn_scale + gn_bias)
    out = F.conv2d(y2.reshape(B, H, W, D).permute(0, 3, 1, 2), conv_w, conv_b,
                   padding=1).permute(0, 2, 3, 1)
    return y1.reshape(-1, D), y2.reshape(-1, D), out.reshape(-1, D)


def fused_compress_tail_vq_plain(h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                                 codebooks, groups: int, eps: float = 1e-5) -> tuple:
    """K3's twin: K5's tail on ``h`` widened to at least fp32, then the RVQ
    search. Returns ``(z_q (B, H, W, D) in h's dtype, idx (B, H, W, L)
    int32)``."""
    B, H, W, _ = h.shape
    wide = h.to(torch.promote_types(h.dtype, torch.float32))
    out = compress_tail_debug_plain(wide, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                                    groups, eps)[2]
    z_q, idx = rvq_search_plain(out, codebooks)
    return z_q.reshape(B, H, W, -1).to(h.dtype), idx.reshape(B, H, W, -1)


def fused_compress_vq(z, w, b, codebooks) -> tuple:
    """``z`` (N, Din), ``w`` (Din, D), ``b`` (D,), ``codebooks`` (L, K, D)
    → ``(z_q (N, D), idx (N, L) int32)``: on the CPU the twin, on the card
    K4."""
    if z.device.type == "cpu":
        return fused_compress_vq_plain(z, w, b, codebooks)
    return _kernels.fused_compress_vq(z, w, b, codebooks)


def fused_compress_tail_vq(h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                           codebooks, groups: int, eps: float = 1e-5) -> tuple:
    """The codec's whole compression tail and the RVQ search: ``h`` (B, H,
    W, Din) → ``(z_q (B, H, W, D) in h's dtype, idx (B, H, W, L) int32)``;
    on the CPU the twin, on the card K3 (a cluster of blocks per image; ``h``
    contiguous NHWC or an NHWC view of NCHW memory; bf16 ``h`` launches K3's
    bf16 case)."""
    if h.device.type == "cpu":
        return fused_compress_tail_vq_plain(h, w1, b1, gn_scale, gn_bias, conv_w,
                                            conv_b, codebooks, groups, eps)
    kernel = (_kernels.fused_compress_tail_vq_bf16 if h.dtype == torch.bfloat16
              else _kernels.fused_compress_tail_vq)
    return kernel(h, w1, b1, gn_scale, gn_bias, conv_w, conv_b, codebooks, groups, eps)


def compress_tail_debug(h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                        groups: int, eps: float = 1e-5) -> tuple:
    """K3's tail without the search, its intermediates ``(y1, y2, out)``,
    each (B·H·W, D): on the CPU the twin, on the card K5."""
    if h.device.type == "cpu":
        return compress_tail_debug_plain(h, w1, b1, gn_scale, gn_bias, conv_w,
                                         conv_b, groups, eps)
    return _kernels.compress_tail_debug(h, w1, b1, gn_scale, gn_bias, conv_w,
                                        conv_b, groups, eps)


def compress_tail_oracle(h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                         groups: int, eps: float = 1e-5) -> tuple:
    """The tail's ``(y1, y2, out)`` in float64, on the inputs' device."""
    return compress_tail_debug_plain(*(t.double() for t in (
        h, w1, b1, gn_scale, gn_bias, conv_w, conv_b)), groups, eps)


def rvq_pick_gaps(x: torch.Tensor, codebooks: torch.Tensor,
                  picks: torch.Tensor) -> torch.Tensor:
    """Follows ``picks`` (N, L) through the RVQ levels in float64 from
    tokens ``x`` (N, D) and returns each pick's relative distance gap to the
    best code of its level, (d_pick − d_min) / (|d_min| + 1e-9), (N, L)."""
    resid = x.double()
    picks = picks.reshape(resid.shape[0], -1).long()
    gaps = []
    for lvl, cb in enumerate(codebooks.double()):
        d = ((resid[:, None, :] - cb[None]) ** 2).sum(-1)
        d_min = d.min(1).values
        i = picks[:, lvl]
        gaps.append((d.gather(1, i[:, None])[:, 0] - d_min) / (d_min.abs() + 1e-9))
        resid = resid - cb[i]
    return torch.stack(gaps, 1)


def check_picks(idx: torch.Tensor, ref_idx: torch.Tensor, gaps: torch.Tensor,
                tol: float = 1e-5) -> dict:
    """The pick criterion: each token's L picks equal the reference's, or
    every one of them is ε-optimal (``gaps`` of ``idx``'s picks, from
    ``rvq_pick_gaps``, below ``tol``). Returns ``{'tokens', 'differ',
    'max_gap' (over the differing tokens), 'ok'}``."""
    L = gaps.shape[1]
    differ = (idx.reshape(-1, L).cpu() != ref_idx.reshape(-1, L).cpu()).any(1)
    worst = float(gaps.cpu()[differ].max()) if bool(differ.any()) else 0.0
    return {"tokens": int(differ.numel()), "differ": int(differ.sum()),
            "max_gap": worst, "ok": worst < tol}


def check_quantized(zq, idx, zq_ref, idx_ref, x64, codebooks, rel: float = 1e-5) -> dict:
    """``check_picks`` of ``idx`` against ``idx_ref`` under the fp64
    distances from ``x64`` (the tokens before the search), and ``zq``
    against ``zq_ref`` within ``rel``·max(1, max|ref|) where the picks
    agree. Takes any leading shape; returns ``check_picks``'s dict with
    ``max_abs_err``, ``tol`` and ``ok`` of both criteria."""
    L, D = idx.shape[-1], zq.shape[-1]
    zq, zq_ref = zq.reshape(-1, D), zq_ref.reshape(-1, D)
    idx, idx_ref = idx.reshape(-1, L), idx_ref.reshape(-1, L)
    res = check_picks(idx, idx_ref, rvq_pick_gaps(x64, codebooks, idx))
    agree = (idx == idx_ref).all(-1)
    err = (zq - zq_ref)[agree].abs().max().item() if bool(agree.any()) else 0.0
    tol = rel * max(1.0, zq_ref.abs().max().item())
    return dict(res, max_abs_err=err, tol=tol,
                ok=res["ok"] and math.isfinite(err) and err <= tol)


def random_vq_inputs(g: torch.Generator, N: int, Din: int, D: int, L: int,
                     K: int) -> tuple:
    """Seeded inputs of K4 on ``g``'s device: z (N, Din), w (Din, D), b (D,)
    and codebooks (L, K, D) scaled to the spread of z·w + b, so that the
    picks spread over the codes."""
    r = lambda *s: torch.randn(*s, device=g.device, generator=g)  # noqa: E731
    z, w, b = r(N, Din), r(Din, D) * Din ** -0.5, r(D) * 0.1
    return z, w, b, r(L, K, D) * (z @ w + b).std()


def random_tail_inputs(g: torch.Generator, B: int, H: int, W: int, Din: int, D: int,
                       L: int, K: int, groups: int, nchw: bool = True) -> tuple:
    """Seeded inputs of K3 and K5 on ``g``'s device: ``(h, tail, codebooks)``
    with h (B, H, W, Din) an NHWC view of NCHW memory (what the codec hands
    over) or contiguous NHWC, ``tail`` the six weights (OIHW convolutions)
    in the order the functions above take them, and codebooks (L, K, D)
    scaled to the spread of the tail's output."""
    r = lambda *s, scale=1.0: torch.randn(*s, device=g.device, generator=g) * scale  # noqa: E731
    h = r(B, Din, H, W).permute(0, 2, 3, 1) if nchw else r(B, H, W, Din)
    tail = (r(D, Din, 1, 1, scale=Din ** -0.5), r(D, scale=0.1), 1 + r(D, scale=0.1),
            r(D, scale=0.1), r(D, D, 3, 3, scale=(9 * D) ** -0.5), r(D, scale=0.1))
    spread = compress_tail_debug_plain(h, *tail, groups)[2].std().item()
    return h, tail, r(L, K, D, scale=spread)
