"""Minibatch optimal-transport pairing, PyTorch port of
``flocoder_tpu/ops/ot.py``.

Every method returns an int64 permutation ``idx`` such that
``target[idx]`` pairs with ``source``:

- ``greedy``: row by row, each row takes its nearest unused column (the
  reference's row order). B dependent argmins, queued without a host wait.
- ``parallel`` (the default): propose-accept rounds. Every unassigned row
  proposes its nearest unused column, every column accepts its nearest
  proposer. The JAX package runs the rounds in a ``lax.while_loop``; here a
  host loop (``parallel_assign``) runs them in chunks of
  ``rounds_per_check`` between host checks of ``row_done.all()``. Once
  every row is done a round changes nothing (no row proposes), so the
  chunked loop gives the same permutation as a round-by-round one. The
  cap of B rounds and the fallback for rows left unassigned are the
  reference's. On the H100 at B=256 a round costs about five times a host
  check (PERF.md), so the default checks every 2 rounds.
- ``blocked``: the parallel method within aligned blocks of rows and
  columns, all blocks batched.
- ``sinkhorn``: log-domain Sinkhorn plan, then greedy extraction by
  largest plan entry.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["pairwise_sqdist", "compute_ot_pairing", "compute_ot_pairing_blocked",
           "compute_ot_pairing_greedy", "compute_ot_pairing_parallel",
           "compute_ot_pairing_sinkhorn", "parallel_assign"]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between the rows of ``a`` (N, ...) and
    ``b`` (M, ...) as ‖a‖² + ‖b‖² − 2·a·bᵀ, clamped at 0."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    return (a2 + b2.T - 2.0 * (a @ b.T)).clamp(min=0.0)


def _greedy_assign(scores: torch.Tensor, minimize: bool) -> torch.Tensor:
    """Row i takes the best column that no earlier row took."""
    B = scores.shape[0]
    if not minimize:
        scores = -scores
    indices = torch.zeros(B, dtype=torch.long, device=scores.device)
    used = torch.zeros(B, dtype=torch.bool, device=scores.device)
    inf = torch.tensor(math.inf, dtype=scores.dtype, device=scores.device)
    for i in range(B):
        j = torch.where(used, inf, scores[i]).argmin()
        indices[i] = j
        used[j] = True
    return indices


def compute_ot_pairing_greedy(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Greedy nearest-unused-target pairing in row order."""
    return _greedy_assign(pairwise_sqdist(source, target), minimize=True)


def parallel_assign(d: torch.Tensor, rounds_per_check: int = 2,
                    max_rounds: Optional[int] = None) -> tuple:
    """Propose-accept assignment on distances ``d`` (G, B, B), G problems
    at once. Returns ``(indices (G, B) int64, rounds)``: ``rounds`` is a
    device scalar, the number of rounds in which some column accepted (the
    JAX loop's round count). The host reads ``row_done`` once every
    ``rounds_per_check`` rounds. At most ``max_rounds`` (default B) rounds
    run, as in the JAX loop."""
    G, B, _ = d.shape
    cap = B if max_rounds is None else max_rounds
    dev = d.device
    inf = torch.tensor(math.inf, dtype=d.dtype, device=dev)
    cols = torch.arange(B, device=dev).expand(G, B)
    indices = torch.zeros(G, B + 1, dtype=torch.long, device=dev)
    row_done = torch.zeros(G, B + 1, dtype=torch.bool, device=dev)
    col_used = torch.zeros(G, B, dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.long, device=dev)
    n = 0
    while n < cap:
        for _ in range(min(rounds_per_check, cap - n)):
            # 1. every unassigned row proposes its nearest unused column
            masked = torch.where(col_used[:, None, :], inf, d)
            best_col = masked.argmin(2)
            best_val = torch.where(row_done[:, :B], inf, masked.amin(2))
            # 2. every column accepts its nearest proposer
            prop = torch.where(best_col[:, :, None] == cols[:, None, :],
                               best_val[:, :, None], inf)
            win_val = prop.amin(1)
            win_row = prop.argmin(1)
            has = torch.isfinite(win_val)
            # 3. commit; columns without a proposer write to the spare slot B
            slot = torch.where(has, win_row, B)
            indices.scatter_(1, slot, cols)
            row_done.scatter_(1, slot, True)
            col_used |= has
            rounds += has.any()
        n += min(rounds_per_check, cap - n)
        if bool(row_done[:, :B].all()):
            break
    indices, row_done = indices[:, :B], row_done[:, :B]
    # rows left by the round cap: the k-th unassigned row takes the k-th
    # unused column, so the result is always a permutation
    free_cols = torch.sort(torch.where(col_used, B + cols, cols), dim=1).values
    rank = torch.cumsum((~row_done).long(), dim=1) - 1
    fallback = free_cols.gather(1, rank.clamp(0, B - 1)) % B
    return torch.where(row_done, indices, fallback), rounds


def compute_ot_pairing_parallel(source: torch.Tensor, target: torch.Tensor,
                                return_rounds: bool = False):
    """Propose-accept pairing ('global greedy': mutually nearest pairs
    first). With ``return_rounds`` also returns the round count."""
    idx, rounds = parallel_assign(pairwise_sqdist(source, target)[None])
    return (idx[0], rounds) if return_rounds else idx[0]


def compute_ot_pairing_blocked(source: torch.Tensor, target: torch.Tensor,
                               block: int = 256, return_rounds: bool = False):
    """Row i pairs only within its aligned block of ``block`` rows and
    columns; the B/block problems run batched. ``block >= B`` is the
    full-batch parallel method; ``block`` must divide B."""
    B = source.shape[0]
    if block >= B:
        return compute_ot_pairing_parallel(source, target, return_rounds)
    if B % block:
        raise ValueError(f"ot block {block} must divide batch {B}")
    g = B // block
    src = source.reshape(g, block, -1)
    tgt = target.reshape(g, block, -1)
    d = ((src * src).sum(2, keepdim=True) + (tgt * tgt).sum(2)[:, None, :]
         - 2.0 * torch.bmm(src, tgt.transpose(1, 2))).clamp(min=0.0)
    idx, rounds = parallel_assign(d)
    offs = torch.arange(g, device=idx.device)[:, None] * block
    idx = (idx + offs).reshape(B)
    return (idx, rounds) if return_rounds else idx


def compute_ot_pairing_sinkhorn(source: torch.Tensor, target: torch.Tensor,
                                reg: float = 0.1, n_iters: int = 100) -> torch.Tensor:
    """Log-domain Sinkhorn plan on distances normalised by their maximum,
    then greedy extraction by largest plan entry."""
    B = source.shape[0]
    M = pairwise_sqdist(source, target)
    M = M / M.max().clamp(min=1e-12)
    log_w = torch.full((B,), -math.log(B), dtype=M.dtype, device=M.device)
    Mr = -M / reg
    f = torch.zeros(B, dtype=M.dtype, device=M.device)
    g = torch.zeros_like(f)
    for _ in range(n_iters):
        f = reg * (log_w - torch.logsumexp(Mr + g[None, :] / reg, dim=1))
        g = reg * (log_w - torch.logsumexp(Mr + f[:, None] / reg, dim=0))
    return _greedy_assign(Mr + f[:, None] / reg + g[None, :] / reg, minimize=False)


def compute_ot_pairing(source: torch.Tensor, target: torch.Tensor,
                       method: str = "parallel", block: Optional[int] = None) -> torch.Tensor:
    """``method`` ∈ {'parallel', 'greedy', 'sinkhorn'}; ``block`` (parallel
    only) pairs within aligned sub-batches of that size."""
    if method == "sinkhorn":
        return compute_ot_pairing_sinkhorn(source, target)
    if method == "greedy":
        return compute_ot_pairing_greedy(source, target)
    if method != "parallel":
        raise ValueError(f"unknown OT method {method!r}")
    if block is not None:
        return compute_ot_pairing_blocked(source, target, block)
    return compute_ot_pairing_parallel(source, target)
