"""Mixture-of-Experts routing and single-device GEGLU expert compute,
PyTorch port of ``flocoder_tpu/parallel/moe.py``.

The JAX module builds (T, E, C) one-hot dispatch and combine tensors and
contracts them with einsums, a layout that suits the TPU's matrix unit. At
HDiT's outer level on 16×16 latents with patch 2 (T = 256·8·8 = 16,384
tokens, E = 8, C = 5,120) the dispatch tensor alone would take 2.7 GB in
fp32. Here the same function is computed by index: each (token, k)
assignment gets a slot ``expert·C + rank`` in a (E·C, d) buffer, tokens are
copied into their slots, the experts run as two batched matmuls over the
(E, C, ·) buffer, and each token gathers its k outputs back, weighted by
its gates. Empty slots hold zeros, as the one-hot contraction gives them.

Priority and ties follow the JAX module exactly: k-major, then token order
(every token's first choice is queued before any token's second), and a
tie between experts goes to the lower index (``lax.top_k``'s rule; here a
stable descending sort).

Not ported yet (ROADMAP.md): expert parallelism, ``moe_geglu_replicated``
and its custom backward.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["MoERouting", "moe_capacity", "moe_routing", "moe_geglu_apply",
           "load_balance_loss", "geglu"]


def geglu(h: torch.Tensor) -> torch.Tensor:
    """GEGLU of the two halves of ``h``'s last axis: gelu(a)·b with the
    exact-erf GELU in ``jax.nn.gelu``'s form, 0.5·a·erfc(−a·√½), √½ in
    ``h``'s dtype, each operation rounded to that dtype as JAX rounds it."""
    a, b = h.chunk(2, dim=-1)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=h.dtype, device=h.device)
    return 0.5 * a * torch.erfc(-a * sqrt_half) * b


class MoERouting(NamedTuple):
    """The routing of T tokens to E experts of capacity C, top K.

    ``slot`` (T, K) int64: ``expert·C + rank`` of each assignment (rank may
    reach past C where ``keep`` is false); ``keep`` (T, K) bool: the
    assignment fits its expert's capacity; ``gates`` (T, K) fp32: the
    normalised gate weights, zero where dropped (the combine weights);
    ``stats``: ``density``, ``prob_mean``, ``dropped_frac`` and ``logits``
    for the auxiliary losses, as in the JAX module."""
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    n_experts: int
    capacity: int
    stats: dict


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    """Static per-expert token capacity: ceil(T·K/E · factor), ≥ 1."""
    return max(int(math.ceil(n_tokens * top_k / n_experts * capacity_factor)), 1)


def moe_routing(logits: torch.Tensor, top_k: int, capacity: int) -> MoERouting:
    """Top-k routing with capacity truncation. ``logits``: (T, E) router
    outputs, computed in fp32."""
    T, E = logits.shape
    K = min(top_k, E)
    logits = logits.float()
    probs = logits.softmax(dim=-1)
    # the k largest, ties to the lowest index: a stable descending sort
    order = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :K]                                        # (T, K)
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # rank of each assignment in its expert's queue, k-major priority
    onehot = F.one_hot(gate_idx.t().reshape(-1), E)                # (K·T, E)
    rank = ((onehot.cumsum(0) - 1) * onehot).sum(-1).reshape(K, T).t()
    keep = rank < capacity
    slot = gate_idx * capacity + rank
    stats = {"density": F.one_hot(gate_idx[:, 0], E).float().mean(0),
             "prob_mean": probs.mean(0),
             "dropped_frac": 1.0 - keep.float().mean(),
             "logits": logits}
    return MoERouting(slot, keep, gate_vals * keep, E, capacity, stats)


def load_balance_loss(stats: dict, n_experts: int,
                      z_weight: float = 1e-3) -> torch.Tensor:
    """Switch-Transformer auxiliary loss: E·Σ_e density_e·prob_mean_e (1 at
    uniform routing) plus ``z_weight`` times the router z-loss
    mean(logsumexp(logits)²)."""
    lb = n_experts * (stats["density"] * stats["prob_mean"]).sum()
    z = (torch.logsumexp(stats["logits"], dim=-1) ** 2).mean()
    return lb + z_weight * z


def moe_geglu_apply(flat: torch.Tensor, routing: MoERouting,
                    w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Single-device expert compute. ``flat`` (T, d) tokens, ``w_up`` (E, d,
    2·d_ff), ``w_down`` (E, d_ff, d) in flax layout, cast to ``flat``'s
    dtype. GEGLU per expert (exact-erf GELU), as the dense block. Returns
    (T, d)."""
    T, d = flat.shape
    E, C = routing.n_experts, routing.capacity
    dt = flat.dtype
    K = routing.slot.shape[1]
    # every assignment copies its token into its slot; a dropped one into a
    # spare row E·C, cut off after (no data-dependent shape, no host sync)
    dest = torch.where(routing.keep, routing.slot, E * C).reshape(-1)
    x_e = flat.new_zeros(E * C + 1, d).index_put((dest,), flat.repeat_interleave(K, 0))
    h = torch.bmm(x_e[:-1].view(E, C, d), w_up.to(dt))
    y_e = torch.bmm(geglu(h), w_down.to(dt)).reshape(E * C, d)
    # a dropped assignment reads slot 0 with weight 0
    y = y_e[torch.where(routing.keep, routing.slot, 0)]                 # (T, K, d)
    return (y * routing.gates.to(dt)[..., None]).sum(1)
