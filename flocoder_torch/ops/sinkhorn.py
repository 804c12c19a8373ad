"""Sinkhorn divergence, PyTorch port of ``flocoder_tpu/ops/sinkhorn.py``.

The debiased divergence ``S(a,b) = OT_eps(a,b) − (OT_eps(a,a) + OT_eps(b,b))/2``
between uniform point clouds, with geomloss's conventions: cost
C(x,y) = ‖x−y‖²/2 (p=2), eps = blur², and ε-annealing from the cost's
diameter down to blur² over the iterations. Dense log-domain iterations in
fp32; inputs are flattened to (N, D).
"""
from __future__ import annotations

import math

import torch

from .ot import pairwise_sqdist

__all__ = ["sinkhorn_divergence", "sinkhorn_loss", "sinkhorn_loss_chunked"]


def _eps_schedule(C_max: torch.Tensor, eps_target: float, n_iters: int) -> torch.Tensor:
    """Geometric descent from the cost diameter by halves, held at blur²."""
    steps = torch.arange(n_iters, device=C_max.device)
    eps0 = C_max.clamp(min=eps_target)
    return (eps0 * 0.5 ** steps).clamp(min=eps_target)


def _log_weights(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), -math.log(n), dtype=like.dtype, device=like.device)


def _sym_potential(C: torch.Tensor, eps_target: float, n_iters: int) -> torch.Tensor:
    """Potential of the symmetric problem OT_eps(a,a): annealed fixed-point
    iteration with averaging."""
    n = C.shape[0]
    log_w = _log_weights(n, C)
    f = torch.zeros(n, dtype=C.dtype, device=C.device)
    for eps in _eps_schedule(C.max(), eps_target, n_iters):
        f_new = -eps * torch.logsumexp((f[None, :] - C) / eps + log_w[None, :], dim=1)
        f = 0.5 * (f + f_new)
    return f


def _ot_cost(x: torch.Tensor, y: torch.Tensor, eps_target: float,
             n_iters: int) -> torch.Tensor:
    """Entropic OT dual cost between uniform clouds x (N,D) and y (M,D)."""
    C = pairwise_sqdist(x, y) / 2.0
    n, m = C.shape
    log_mu, log_nu = _log_weights(n, C), _log_weights(m, C)
    f = torch.zeros(n, dtype=C.dtype, device=C.device)
    g = torch.zeros(m, dtype=C.dtype, device=C.device)
    for eps in _eps_schedule(C.max(), eps_target, n_iters):
        f = -eps * torch.logsumexp((g[None, :] - C) / eps + log_nu[None, :], dim=1)
        g = -eps * torch.logsumexp((f[:, None] - C) / eps + log_mu[:, None], dim=0)
    return (log_mu.exp() * f).sum() + (log_nu.exp() * g).sum()


@torch.no_grad()
def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, blur: float = 0.05,
                        n_iters: int = 100) -> torch.Tensor:
    """Debiased Sinkhorn divergence, p=2, clamped at 0."""
    x = x.reshape(x.shape[0], -1).float()
    y = y.reshape(y.shape[0], -1).float()
    eps = blur ** 2
    oxy = _ot_cost(x, y, eps, n_iters)
    fx = _sym_potential(pairwise_sqdist(x, x) / 2.0, eps, n_iters)
    fy = _sym_potential(pairwise_sqdist(y, y) / 2.0, eps, n_iters)
    return (oxy - 0.5 * (2.0 * fx.mean() + 2.0 * fy.mean())).clamp(min=0.0)


def sinkhorn_loss(x, y, blur: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """The reference's name for ``sinkhorn_divergence``."""
    return sinkhorn_divergence(x, y, blur=blur, n_iters=n_iters)


def sinkhorn_loss_chunked(x, y, blur: float = 0.05, chunk_size: int = 512,
                          n_iters: int = 100) -> torch.Tensor:
    """Mean of the divergences of aligned chunks of ``chunk_size`` points
    (a trailing partial chunk is dropped, as in the JAX package)."""
    n = min(x.shape[0], y.shape[0])
    if n <= chunk_size:
        return sinkhorn_divergence(x[:n], y[:n], blur=blur, n_iters=n_iters)
    vals = [sinkhorn_divergence(x[i:i + chunk_size], y[i:i + chunk_size],
                                blur=blur, n_iters=n_iters)
            for i in range(0, n - chunk_size + 1, chunk_size)]
    return torch.stack(vals).mean()
