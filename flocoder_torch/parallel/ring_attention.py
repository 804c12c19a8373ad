"""Ring (sequence-parallel) attention over the mesh's 'model' axis, PyTorch
port of ``flocoder_tpu/parallel/ring_attention.py``.

The S ranks of a model group (``parallel/mesh.py:model_group``) each hold
one n/S chunk of the tokens; K and V rotate around the ring one hop a step
(``mesh.ring_permute_``, the JAX ``ppermute`` j → j+1), and the exact
softmax comes back from an online (flash-style) running maximum and
denominator. Scores and accumulators are fp32 whatever the inputs' dtype;
K and V travel in theirs, and the output is cast to q's.

- ``ring_attention_local``: the ring over this rank's chunks (no autograd),
  with the per-query log-sum-exp on request.
- ``ring_attention_replicated``: q, k and v whole on every model rank (as
  the attention sites of the U-Net, HDiT and the codec make them); each
  rank runs its chunk and the outputs are all-gathered. Its backward is
  the JAX ``_rar_bwd`` step for step: dQ accumulates against the rotating
  K and V, the dK and dV partials travel with their chunks and arrive home
  complete after S hops, the probabilities come from the saved
  log-sum-exp with D = rowsum(dO∘O), and the three gradients are
  all-gathered, so they are whole on every rank. No K, V, dK or dV is
  gathered inside the loop; the O(n²) work splits S ways both ways.
- ``make_ring_self_attention``: the sequence-sharded form, each rank
  passing its own chunks.

The block products are plain einsums, as in the JAX package (no Pallas
kernel there). The ring defines no forward-mode derivative: the JAX
``custom_vjp`` cannot be pushed forward by ``jax.jvp`` either, so MeanFlow
and the curvature penalty do not combine with it. ``HOPS`` counts each
call's hops: S a forward, S a backward (the JAX scan's, whose last forward
hop brings K and V home).
"""
from __future__ import annotations

from typing import Optional

import torch

from .mesh import model_all_gather, model_group, model_rank, ring_permute_

__all__ = ["ring_attention_local", "ring_attention_replicated",
           "make_ring_self_attention", "HOPS", "reset_hops"]

HOPS = {"forward": 0, "backward": 0}


def reset_hops() -> None:
    HOPS["forward"] = HOPS["backward"] = 0


def _plain_attention(q, k, v, scale: Optional[float] = None):
    """Full softmax attention on (b, n, h, d) in fp32, cast to q's dtype:
    the S = 1 ring."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bnhd,bmhd->bhnm", q.float() * scale, k.float())
    sim = sim - sim.amax(dim=-1, keepdim=True).detach()
    out = torch.einsum("bhnm,bmhd->bnhd", sim.softmax(dim=-1), v.float())
    return out.to(q.dtype)


def _chunk(x, rank: int, axis_size: int):
    """Model rank ``rank``'s token chunk of a whole (b, n, h, d) tensor."""
    c = x.shape[1] // axis_size
    return x[:, rank * c:(rank + 1) * c]


def _ring_group(axis_size: int, group):
    group = model_group() if group is None else group
    size = 1 if group is None else torch.distributed.get_world_size(group)
    if size != axis_size:
        raise ValueError(f"a ring of {axis_size} over a model axis of {size} ranks")
    return group


def ring_attention_local(q, k, v, axis_size: int, scale: Optional[float] = None,
                         return_lse: bool = False, group=None):
    """Exact softmax attention where q, k, v are this rank's chunks ``(b,
    n_local, heads, d)`` of a sequence split over the model group (v's d
    may differ). Returns the local output, or with ``return_lse`` also the
    fp32 log-sum-exp ``(b, heads, n_local)``. No autograd."""
    group = _ring_group(axis_size, group)
    b, n, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    with torch.no_grad():
        qf = q.float() * scale
        k_blk, v_blk = k.clone(), v.clone()
        m = q.new_full((b, h, n), float("-inf"), dtype=torch.float32)
        l = q.new_zeros((b, h, n), dtype=torch.float32)
        acc = q.new_zeros((b, h, n, v.shape[-1]), dtype=torch.float32)
        for _ in range(axis_size):
            sim = torch.einsum("bnhd,bmhd->bhnm", qf, k_blk.float())
            new_m = torch.maximum(m, sim.amax(dim=-1))
            corr = torch.exp(m - new_m)             # rescale the old statistics
            p = torch.exp(sim - new_m[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhnm,bmhd->bhnd", p, v_blk.float())
            m = new_m
            ring_permute_([k_blk, v_blk], group)
            HOPS["forward"] += 1
        out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def _ring_backward(q_loc, k_loc, v_loc, out_loc, lse_loc, g_loc, axis_size: int,
                   scale: float, group):
    """The ring backward over this rank's chunks: (dq, dk, dv) of its own
    chunks in fp32, dk and dv complete after the S hops."""
    qf = q_loc.float() * scale
    g = g_loc.float()
    D = torch.einsum("bnhd,bnhd->bhn", g, out_loc.float())   # rowsum(dO ∘ O)
    k_blk, v_blk = k_loc.clone(), v_loc.clone()
    dk_blk = torch.zeros(k_loc.shape, dtype=torch.float32, device=k_loc.device)
    dv_blk = torch.zeros(v_loc.shape, dtype=torch.float32, device=v_loc.device)
    dq = torch.zeros(q_loc.shape, dtype=torch.float32, device=q_loc.device)
    for _ in range(axis_size):
        kf = k_blk.float()
        sim = torch.einsum("bnhd,bmhd->bhnm", qf, kf)
        p = torch.exp(sim - lse_loc[..., None])    # the exact probabilities
        dv_blk += torch.einsum("bhnm,bnhd->bmhd", p, g)
        dp = torch.einsum("bnhd,bmhd->bhnm", g, v_blk.float())
        ds = p * (dp - D[..., None])
        dq += torch.einsum("bhnm,bmhd->bnhd", ds, kf)
        dk_blk += torch.einsum("bhnm,bnhd->bmhd", ds, qf)
        ring_permute_([k_blk, v_blk, dk_blk, dv_blk], group)
        HOPS["backward"] += 1
    return dq * scale, dk_blk, dv_blk


class _RingReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis_size, scale, group):
        r = model_rank(group)
        out_loc, lse = ring_attention_local(
            _chunk(q, r, axis_size), _chunk(k, r, axis_size), _chunk(v, r, axis_size),
            axis_size, scale, return_lse=True, group=group)
        ctx.save_for_backward(q, k, v, out_loc, lse)
        ctx.ring = (axis_size, scale, group)
        return model_all_gather(out_loc, 1, group)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out_loc, lse = ctx.saved_tensors
        axis_size, scale, group = ctx.ring
        r = model_rank(group)
        dq, dk, dv = _ring_backward(
            _chunk(q, r, axis_size), _chunk(k, r, axis_size), _chunk(v, r, axis_size),
            out_loc, lse, _chunk(g, r, axis_size), axis_size, scale, group)
        # whole on every rank: the replicated-gradient contract
        return (model_all_gather(dq, 1, group).to(q.dtype),
                model_all_gather(dk, 1, group).to(k.dtype),
                model_all_gather(dv, 1, group).to(v.dtype), None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_NO_JVP)


class _RingSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis_size, scale, group):
        out, lse = ring_attention_local(q, k, v, axis_size, scale, return_lse=True,
                                        group=group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (axis_size, scale, group)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis_size, scale, group = ctx.ring
        dq, dk, dv = _ring_backward(q, k, v, out, lse, g, axis_size, scale, group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_NO_JVP)


_NO_JVP = ("ring attention defines no forward-mode derivative (the JAX package's "
           "custom_vjp ring cannot be pushed forward by jax.jvp either)")


def _no_transforms() -> None:
    # torch.func's jvp would reach the Function without its jvp rule
    if torch._C._are_functorch_transforms_active():
        raise NotImplementedError(_NO_JVP)


def ring_attention_replicated(q, k, v, axis_size: int, scale: Optional[float] = None,
                              group=None):
    """Sequence-parallel attention for ``(b, n, heads, d)`` q, k, v whole
    (and alike) on every rank of the model group (default: the axis
    ``make_mesh`` formed); the output and the gradients are whole on every
    rank. Plain attention at ``axis_size`` 1; ``axis_size`` must divide n
    and equal the group's size."""
    _no_transforms()
    if q.shape[1] % axis_size:
        raise ValueError(f"ring attention over {axis_size} ranks needs a token count "
                         f"divisible by it, got {q.shape[1]}")
    if axis_size == 1:
        return _plain_attention(q, k, v, scale)
    group = _ring_group(axis_size, group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingReplicated.apply(q, k, v, axis_size, scale, group)


def make_ring_self_attention(mesh=None):
    """``fn(q, k, v) -> out`` over this rank's token chunks ``(b, n_local,
    heads, d)`` of a sequence split over ``mesh``'s model axis (default:
    the one ``make_mesh`` formed), differentiable by the ring backward:
    the JAX ``shard_map`` over the token axis, each rank holding its block."""
    group = model_group(mesh)
    axis_size = 1 if group is None else torch.distributed.get_world_size(group)

    def fn(q, k, v):
        _no_transforms()
        if axis_size == 1:
            return _plain_attention(q, k, v)
        return _RingSharded.apply(q, k, v, axis_size, q.shape[-1] ** -0.5, group)

    return fn
