"""Residual vector quantization (RVQ), PyTorch port of
``flocoder_tpu/ops/rvq.py``.

- ``RVQState``: the codebooks and their EMA statistics, held as buffers of a
  module so that a codec checkpoint carries them (``vq/codebooks``, ...).
- ``rvq_apply``: per level, the nearest code by one matmul + argmin (ties
  take the first minimum), rotation-trick gradients, the commitment loss;
  in training, k-means initialisation on the first batch, the
  Laplace-smoothed EMA fold and dead-code reseeding. It returns the new
  state as tensors and leaves ``state`` as it is; ``RVQState.assign_`` takes
  them over.

Randomness comes from an explicit ``torch.Generator``: the k-means seed rows
and the dead-code reseed picks (``K`` batch rows per level each). Both can
also be passed in (``kmeans_seeds``, ``reseed_picks``, (L, K) row indices),
so that a test gives this module and the JAX package the same draws.
Whether the codebooks are initialised is read on the host once per call.

Under a data-parallel mesh (``mesh``, ``parallel/mesh.py``; the JAX
``axis_name``) each rank quantizes its own rows, and the replicated state
stays bitwise the same on every rank: the per-level counts and sums are
summed over the batch ranks, and the k-means centres and the dead-code
reseed candidates, both drawn from a rank's own rows, are batch rank 0's
(the JAX ``psum`` and ``_bcast0``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_shard_count, broadcast0_, psum_

__all__ = ["RVQState", "rvq_init", "rvq_apply", "rvq_encode", "rvq_lookup",
           "orthogonal_reg_loss"]


class RVQState(nn.Module):
    """Codebooks (L, K, D), EMA counts (L, K) and sums (L, K, D), and the
    k-means flag, as buffers."""

    def __init__(self, levels: int, codebook_size: int, dim: int):
        super().__init__()
        self.register_buffer("codebooks", torch.zeros(levels, codebook_size, dim))
        self.register_buffer("ema_counts", torch.zeros(levels, codebook_size))
        self.register_buffer("ema_sums", torch.zeros(levels, codebook_size, dim))
        self.register_buffer("initted", torch.zeros((), dtype=torch.bool))

    def init_special_(self, generator: torch.Generator):
        """N(0, 0.02²) codebooks, zero statistics, not initialised."""
        self.codebooks.copy_(torch.randn(self.codebooks.shape, generator=generator,
                                         device=generator.device) * 0.02)
        self.ema_counts.zero_()
        self.ema_sums.zero_()
        self.initted.fill_(False)

    def tensors(self) -> dict:
        return {"codebooks": self.codebooks, "ema_counts": self.ema_counts,
                "ema_sums": self.ema_sums, "initted": self.initted}

    @torch.no_grad()
    def assign_(self, new: dict) -> None:
        """Take over a state returned by ``rvq_apply`` (in place)."""
        for name, t in new.items():
            getattr(self, name).copy_(t)


@torch.no_grad()
def rvq_init(generator: torch.Generator, levels: int, codebook_size: int,
             dim: int) -> RVQState:
    """A fresh state on the generator's device (``RVQState.init_special_``)."""
    state = RVQState(levels, codebook_size, dim).to(generator.device)
    state.init_special_(generator)
    return state


def _sq_dists(z: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(N,D) x (K,D) → (N,K) squared distances via one matmul."""
    return (z * z).sum(1, keepdim=True) + (cb * cb).sum(1)[None] - 2.0 * z @ cb.T


def _kmeans(z: torch.Tensor, seeds: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Lloyd iterations from the batch rows ``seeds`` (K,)."""
    k = seeds.shape[0]
    centers = z[seeds]
    for _ in range(iters):
        onehot = F.one_hot(_sq_dists(z, centers).argmin(1), k).to(z.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ z) / counts[:, None].clamp(min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers


def _rotation_trick(z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward equals q; backward rotates the gradient from q onto z by the
    (detached) Householder pair mapping ẑ to q̂, scaled by |q|/|z|."""
    eps = 1e-6
    z_norm = z.norm(dim=-1, keepdim=True)
    q_norm = q.norm(dim=-1, keepdim=True)
    e = z / z_norm.clamp(min=eps)
    q_hat = q / q_norm.clamp(min=eps)
    r = e + q_hat
    r = (r / r.norm(dim=-1, keepdim=True).clamp(min=eps)).detach()
    scale = (q_norm / z_norm.clamp(min=eps)).detach()
    rot = (z - 2.0 * r * (r * z).sum(-1, keepdim=True)
           + 2.0 * q_hat.detach() * (e.detach() * z).sum(-1, keepdim=True))
    return scale * rot


def orthogonal_reg_loss(codebooks: torch.Tensor) -> torch.Tensor:
    """‖ĈĈᵀ − I‖²/K² on L2-normalised codes, averaged over levels."""
    L, K, D = codebooks.shape
    cb = codebooks / codebooks.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    gram = torch.einsum("lkd,ljd->lkj", cb, cb)
    eye = torch.eye(K, device=codebooks.device, dtype=gram.dtype)[None]
    return (((gram - eye) ** 2).sum(dim=(1, 2)) / (K * K)).mean()


def _draw(generator, given, level: int, K: int, N: int, device) -> torch.Tensor:
    if given is not None:
        return torch.as_tensor(given[level], device=device, dtype=torch.long)
    return torch.randint(0, N, (K,), generator=generator,
                         device=generator.device).to(device)


def rvq_apply(state: RVQState, z: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None, decay: float = 0.95,
              commitment_weight: float = 0.5, dead_threshold: float = 2.0,
              rotation_trick: bool = True, orthogonal_reg_weight: float = 0.0,
              kmeans_seeds=None, reseed_picks=None, mesh=None) -> tuple:
    """Quantize flat tokens ``z`` (N, D). Returns ``(z_q, indices (N, L),
    commit_loss, new_state)``; ``new_state`` is a dict of the state's
    tensors. With ``train`` and a ``generator`` (or both injected draws),
    the codebooks are k-means-initialised on the first batch, folded by EMA
    and reseeded where dead; otherwise the state passes through. ``mesh``:
    ``z`` is this rank's rows, and the update reduces over the batch ranks
    (every rank must call)."""
    L, K, D = state.codebooks.shape
    N = z.shape[0]
    zf = z.float()
    mesh = mesh if batch_shard_count(mesh) > 1 else None
    update = train and (generator is not None or
                        (kmeans_seeds is not None and reseed_picks is not None))
    codebooks = state.codebooks
    if update and not bool(state.initted):
        with torch.no_grad():
            residual, centers = zf.detach(), []
            for lvl in range(L):
                c = _kmeans(residual, _draw(generator, kmeans_seeds, lvl, K, N,
                                            z.device))
                residual = residual - c[_sq_dists(residual, c).argmin(1)]
                centers.append(c)
            # k-means ran on this rank's rows: every rank takes rank 0's
            codebooks = broadcast0_(torch.stack(centers), mesh)

    residual = zf
    z_q = torch.zeros_like(zf)
    indices = []
    commit_loss = zf.new_zeros(())
    new_counts, new_sums, new_cbs = [], [], []
    for lvl in range(L):
        cb = codebooks[lvl]
        with torch.no_grad():
            idx = _sq_dists(residual.detach(), cb).argmin(1)
        q_raw = cb[idx].detach()
        z_q = z_q + (_rotation_trick(residual, q_raw) if rotation_trick
                     else residual + (q_raw - residual).detach())
        indices.append(idx)
        commit_loss = commit_loss + commitment_weight * ((residual - q_raw) ** 2).mean()
        if update:
            with torch.no_grad():
                res = residual.detach()
                counts = torch.zeros(K, device=z.device).index_add_(
                    0, idx, torch.ones(N, device=z.device))
                sums = F.one_hot(idx, K).float().T @ res
                psum_([counts, sums], mesh)
                ema_c = state.ema_counts[lvl] * decay + counts * (1 - decay)
                ema_s = state.ema_sums[lvl] * decay + sums * (1 - decay)
                # Laplace-smoothed EMA codebook
                n_total = ema_c.sum()
                smoothed = (ema_c + 1e-5) / (n_total + K * 1e-5) * n_total
                cb_new = ema_s / smoothed[:, None].clamp(min=1e-5)
                # dead codes take random batch residuals
                pick = _draw(generator, reseed_picks, lvl, K, N, z.device)
                dead = ema_c < dead_threshold
                # the candidates are this rank's rows: rank 0's on every rank
                cb_new = torch.where(dead[:, None], broadcast0_(res[pick], mesh), cb_new)
                ema_c = torch.where(dead, torch.full_like(ema_c, dead_threshold + 1.0),
                                    ema_c)
                ema_s = torch.where(dead[:, None], cb_new * (dead_threshold + 1.0), ema_s)
            new_counts.append(ema_c)
            new_sums.append(ema_s)
            new_cbs.append(cb_new)
        residual = residual - q_raw

    if orthogonal_reg_weight:
        commit_loss = commit_loss + orthogonal_reg_weight * orthogonal_reg_loss(codebooks)
    if update:
        new_state = {"codebooks": torch.stack(new_cbs),
                     "ema_counts": torch.stack(new_counts),
                     "ema_sums": torch.stack(new_sums),
                     "initted": torch.ones((), dtype=torch.bool, device=z.device)}
    else:
        new_state = state.tensors()
    return z_q.to(z.dtype), torch.stack(indices, 1), commit_loss, new_state


def rvq_encode(state: RVQState, z: torch.Tensor) -> torch.Tensor:
    """Tokens → per-level indices (N, L), no state change."""
    return rvq_apply(state, z, train=False)[1]


def rvq_lookup(state: RVQState, indices: torch.Tensor) -> torch.Tensor:
    """Per-level indices (N, L) → the sum of the selected codes (N, D)."""
    out = torch.zeros(indices.shape[0], state.codebooks.shape[2],
                      device=indices.device, dtype=state.codebooks.dtype)
    for lvl in range(state.codebooks.shape[0]):
        out = out + state.codebooks[lvl][indices[:, lvl]]
    return out
