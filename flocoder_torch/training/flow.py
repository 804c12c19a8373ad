"""Flow-matching training steps, PyTorch port of
``flocoder_tpu/training/flow.py``.

- The step draws its noise, times and CFG noise from an explicit
  ``torch.Generator`` on the model's device, or takes them through
  ``draws`` (``{'noise', 't_uniform', 'cfg_noise'}``, plus ``'r_uniform'``
  and ``'sel_uniform'`` for MeanFlow): tests pass the arrays ``jax.random``
  drew with the JAX package's key split. ``t_uniform`` is the raw U(0,1)
  draw; the step maps it to ``eps + (1 − eps)·u`` and warps it.
- The CFG-dropout gate is one draw per optimizer step for the whole batch
  (a 0-d bool tensor, so the step never waits on the card for it).
- Minibatch OT pairs each source with a permuted target, and the class
  label is permuted with its target, as the JAX package documents.
- ``grad_accum`` splits the batch into leading microbatch slices, each
  with its own draws and its own OT pairing, and backpropagates each
  slice's loss divided by ``grad_accum``: the update sees the mean of the
  microbatch gradients.
- The JAX package's ``steps_per_call`` (K steps scanned in one dispatch)
  has no counterpart: every step here is its own call.
- ``curvature_weight`` and MeanFlow take their forward-mode derivative
  with ``torch.func.jvp``; the parameters' gradients flow back through it.
- ``model_apply(model, x, t, cond)`` (default ``model(x, t, cond)``) may
  return ``(v, model_aux)``, the JAX step's contract for a model-internal
  auxiliary loss (HDiT's MoE load balance): it is added to the objective
  and reported as ``loss_model_aux``, in the curvature branch too.
- The optimizer is ``ClippedAdam`` (optax's clip-by-global-norm then
  Adam), its learning rate set from the schedule before each step.
- Inpainting: with a ``MaskEncoder`` in the state and ``mask_pixels`` in
  the batch, the mask encoder turns the pixel masks into the latent mask,
  the source is ``source + mask·(noise − source)`` (the flow noise), the
  mask conditions the U-Net, and the identity loss pulls the encoder's
  all-ones and all-zeros outputs to 1 and 0. The mask encoder has its own
  optimizer group, as optax's ``multi_transform`` of the JAX package: clip
  at 0.5, then Adam at 0.1× the schedule. ``otf_aug`` adds the curriculum:
  (p_ones, p_zeros) from the step counter, computed on the host in float32
  as the JAX step computes them on the device, and an exact count of items
  chosen by rank threshold over a random permutation (``draws['otf_perm']``,
  injectable like the other draws); ones become unconditional (mask 1,
  source ``blank_latents``), zeros identity (mask 0, source the target).
- Data parallelism (``mesh``, ``parallel/mesh.py``): each rank takes its
  own rows and its own draws (its generator seeded with ``rank_seed``, the
  JAX key folded with the shard index; draws stay injectable), the CFG
  gate is batch rank 0's on every rank, OT pairs within the rank's rows,
  and the gradients and losses are averaged over the batch ranks before
  the clipped Adam update and the EMA, which then run replicated: the
  documented function of the JAX shard_map step. On a mesh with a model
  axis the model ranks of a batch coordinate are replicas: they take the
  same rows and draws (``rank_seed`` is keyed on the batch rank), pair
  them alike, and average over the batch group only, since the ring's
  gradients (``parallel/ring_attention.py``, reached through
  ``model_apply``) are whole on every model rank already; the replicas
  stay equal bit for bit.
- FSDP (``fsdp=True`` with ``shard_flow_state``): the model and its EMA
  are FSDP2 modules (``parallel/mesh.py:shard_state``), and the step
  computes the one-device function on the global batch: every rank
  gathers the batch, draws the global noise, times and gate from a
  generator seeded alike on every rank, pairs the whole batch by OT, and
  runs the model on its own rows; FSDP2 averages the sharded gradients,
  the replicated ones (and the mask encoder's) are averaged here, and Adam
  and the EMA update the shards. Forward-mode derivatives (curvature,
  MeanFlow) do not pass FSDP2's hooks and are refused with it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops.ot import compute_ot_pairing, compute_ot_pairing_blocked
from ..parallel.mesh import (batch_rank, batch_shard_count, broadcast0_, gather_rows,
                             pmean_, shard_state)
from ..sampling import warp_time
from .ema import ema_init, ema_update
from .vqgan import ClippedAdam, _is_dtensor

__all__ = ["FlowState", "create_flow_state", "make_flow_optimizer",
           "make_mask_optimizer", "make_flow_grads_fn", "make_flow_train_step",
           "make_flow_eval_step", "meanflow_target", "draw_flow_inputs", "otf_counts",
           "shard_flow_state"]


def meanflow_target(model: Callable, x_r, r, t_h, v_star, cond: Optional[dict],
                    t_scale: float = 999.0) -> tuple:
    """MeanFlow regression pair ``(u, u_tgt)``: the average velocity
    u(x_r, r, t) and ``v_star + (t − r)·du/dr``, the total derivative along
    the path taken by one jvp with tangents ``(v_star, 1)``. The caller
    detaches ``u_tgt``."""
    cond_h = dict(cond) if cond else {}
    cond_h["time_horizon"] = t_h * t_scale
    u, du_dr = torch.func.jvp(lambda xx, rr: model(xx, rr * t_scale, cond_h),
                              (x_r, r), (v_star, torch.ones_like(r)))
    return u, v_star + (t_h - r)[:, None, None, None] * du_dr


def make_flow_optimizer(model: nn.Module, learning_rate,
                        grad_clip: float = 1.0) -> ClippedAdam:
    """Clip by global norm at ``grad_clip``, then Adam at ``learning_rate``
    (a float or a ``schedule(step)``)."""
    return ClippedAdam(model.parameters(), learning_rate, grad_clip)


def make_mask_optimizer(mask_encoder: nn.Module, learning_rate,
                        grad_clip: float = 0.5, lr_scale: float = 0.1) -> ClippedAdam:
    """The mask encoder's group: clip by its own global norm at
    ``grad_clip``, then Adam at ``lr_scale`` times the learning rate."""
    lr = ((lambda count: learning_rate(count) * lr_scale) if callable(learning_rate)
          else learning_rate * lr_scale)
    return ClippedAdam(mask_encoder.parameters(), lr, grad_clip)


@dataclass
class FlowState:
    """The velocity field, its optimizer and EMA, the step counter and,
    for inpainting, the mask encoder with its optimizer group and EMA."""
    model: nn.Module
    opt: ClippedAdam
    ema: nn.Module
    step: int = 0
    mask_encoder: Optional[nn.Module] = None
    mask_opt: Optional[ClippedAdam] = None
    ema_mask_encoder: Optional[nn.Module] = None


def create_flow_state(model: nn.Module, learning_rate, grad_clip: float = 1.0,
                      mask_encoder: Optional[nn.Module] = None) -> FlowState:
    state = FlowState(model=model, opt=make_flow_optimizer(model, learning_rate,
                                                           grad_clip=grad_clip),
                      ema=ema_init(model))
    if mask_encoder is not None:
        state.mask_encoder = mask_encoder
        state.mask_opt = make_mask_optimizer(mask_encoder, learning_rate)
        state.ema_mask_encoder = ema_init(mask_encoder)
    return state


def shard_flow_state(state: FlowState, mesh, min_size: int = 2 ** 14) -> dict:
    """FSDP-shard a fresh state in place (``parallel/mesh.py:shard_state``,
    the JAX ``shard_state``): the model and its EMA by the same placement,
    and the model's optimizer rebuilt on the sharded parameters (its
    moments then live in the shards). The mask encoder stays replicated.
    Returns the placement by parameter name; on the degenerate mesh
    (``None``) the state stays whole and the result is ``None``."""
    if mesh is None:
        return None
    if state.opt.adam.state:
        raise ValueError("shard_flow_state takes a state before its first step")
    dims = shard_state(mesh, state.model, min_size)
    shard_state(mesh, state.ema, min_size)
    opt = state.opt
    state.opt = ClippedAdam(state.model.parameters(), opt.schedule or opt.lr,
                            opt.grad_clip, opt.betas)
    return dims


def otf_counts(otf_aug: dict, step: int, batch: int) -> tuple:
    """The OTF curriculum's exact counts ``(n_ones, n_zeros)`` at optimizer
    step ``step``: epoch = step // steps_per_epoch + 1; up to
    ``curriculum_epochs`` p_ones falls from 1 and p_zeros is 0, up to
    ``extend_epochs`` they ramp to 0.3 and 0.02, then they hold ``p_ones``
    and ``p_zeros``; each count is floor(p·batch). float32 throughout, as
    the JAX step computes it on the device."""
    f = np.float32
    ce, ee = f(otf_aug.get("curriculum_epochs", 0)), f(otf_aug.get("extend_epochs", 0))
    p1f, p0f = f(otf_aug.get("p_ones", 0.0)), f(otf_aug.get("p_zeros", 0.0))
    spe = max(int(otf_aug.get("steps_per_epoch", 1)), 1)
    ep = f(step // spe + 1)
    prog = np.clip((ep - ce) / max(ee - ce, f(1.0)), f(0.0), f(1.0))
    if ep <= ce:
        p_ones, p_zeros = (ce - (ep - f(1.0))) / max(ce, f(1.0)), f(0.0)
    elif ep <= ee:
        p_ones, p_zeros = f(0.1) + f(0.2) * prog, f(0.02) * prog
    else:
        p_ones, p_zeros = p1f, p0f
    return int(np.floor(f(p_ones) * f(batch))), int(np.floor(f(p_zeros) * f(batch)))


def _interp(source, target, t):
    te = t[:, None, None, None]
    return (1 - te) * source + te * target


def draw_flow_inputs(generator: torch.Generator, shape, meanflow: bool = False,
                     dtype=torch.float32, otf: bool = False) -> dict:
    """One (micro)batch's random inputs, drawn on ``generator``'s device;
    with ``otf`` also the OTF selection's permutation ``otf_perm``."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    draws = {"noise": torch.randn(tuple(shape), **kw),
             "t_uniform": torch.rand(shape[0], **kw),
             "cfg_noise": torch.randn(tuple(shape), **kw)}
    if meanflow:
        draws["r_uniform"] = torch.rand(shape[0], **kw)
        draws["sel_uniform"] = torch.rand(shape[0], **kw)
    if otf:
        draws["otf_perm"] = torch.randperm(shape[0], generator=generator,
                                           device=generator.device)
    return draws


def make_flow_grads_fn(eps: float = 1e-3, warp_s: float = 0.5, t_scale: float = 999.0,
                       use_ot: bool = True, encode_fn: Optional[Callable] = None,
                       ot_method: str = "parallel", ot_block: Optional[int] = None,
                       paired_source: bool = False, curvature_weight: float = 0.0,
                       meanflow: bool = False, meanflow_ratio: float = 0.25,
                       meanflow_adaptive_p: float = 0.5, mask_identity_weight: float = 1.0,
                       blank_latents: Optional[torch.Tensor] = None,
                       otf_aug: Optional[dict] = None,
                       model_apply: Optional[Callable] = None) -> Callable:
    """The per-(micro)batch loss core:
    ``grads_fn(model, batch, drop, draws=None, generator=None,
    loss_scale=1.0, mask_encoder=None, step=0) -> aux``. It backpropagates
    ``loss·loss_scale`` into the model's (and the mask encoder's) ``.grad``
    and returns the detached losses. ``batch``: ``{'target': (B,H,W,C),
    'class_cond': (B,) or absent, 'source' (paired_source, inpainting),
    'mask_pixels' (inpainting, with ``mask_encoder``)}``, or ``'pixels'``
    with ``encode_fn``. ``step`` is the optimizer step the OTF curriculum
    reads. ``rows``: the draws, the gate and the OT pairing cover the whole
    batch, and the model's loss only these rows (the FSDP step's share)."""
    if model_apply is None:
        model_apply = lambda m, x, t, c: m(x, t, c)  # noqa: E731

    def grads_fn(model: nn.Module, batch: dict, drop, draws: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 loss_scale: float = 1.0, mask_encoder: Optional[nn.Module] = None,
                 step: int = 0, rows: Optional[slice] = None) -> dict:
        if encode_fn is not None and "pixels" in batch:
            with torch.no_grad():
                target = encode_fn(batch["pixels"])
        else:
            target = batch["target"]
        class_cond = batch.get("class_cond")
        B = target.shape[0]
        inpainting = mask_encoder is not None and "mask_pixels" in batch
        if draws is None:
            draws = draw_flow_inputs(generator, target.shape, meanflow, target.dtype,
                                     otf=inpainting and otf_aug is not None)
        t = warp_time(draws["t_uniform"] * (1 - eps) + eps, s=warp_s)

        mask = None
        if inpainting:
            mask_pixels = batch["mask_pixels"].to(target.dtype)
            src = batch["source"]
            if otf_aug is not None:
                n1, n0 = otf_counts(otf_aug, step, B)
                rank = draws["otf_perm"]
                sel1 = (rank < n1)[:, None, None, None]
                sel0 = ((rank >= n1) & (rank < n1 + n0))[:, None, None, None]
                mask_pixels = torch.where(sel1, 1.0, mask_pixels)
                mask_pixels = torch.where(sel0, 0.0, mask_pixels)
                if blank_latents is not None:
                    src = torch.where(sel1, blank_latents.to(src.dtype), src)
                src = torch.where(sel0, target, src)
            mask = mask_encoder(mask_pixels)
            source = src + mask * (draws["noise"] - src)
            source = torch.where(drop, draws["cfg_noise"], source)
            mask = torch.where(drop, torch.ones_like(mask), mask)
        elif paired_source:
            source = batch["source"].to(target.dtype)
        else:
            source = torch.where(drop, draws["cfg_noise"], draws["noise"])
        if class_cond is not None:
            class_cond = torch.where(drop, -torch.ones_like(class_cond), class_cond)
        aux = {}
        if use_ot and not paired_source:
            if ot_method == "parallel":
                idx, aux["ot_rounds"] = compute_ot_pairing_blocked(
                    source.detach(), target.detach(), block=ot_block or B,
                    return_rounds=True)
            else:
                idx = compute_ot_pairing(source.detach(), target.detach(),
                                         method=ot_method, block=ot_block)
            target = target[idx]
            if class_cond is not None:
                class_cond = class_cond[idx]
        if rows is not None:
            source, target, t = source[rows], target[rows], t[rows]
            class_cond = class_cond[rows] if class_cond is not None else None
            mask = mask[rows] if mask is not None else None
            draws = {k: v[rows] if k in ("r_uniform", "sel_uniform") else v
                     for k, v in draws.items()}
        v_star = target - source
        cond = {"class_cond": class_cond, "mask_cond": mask}

        if meanflow:
            r = t * draws["r_uniform"]
            r = torch.where(draws["sel_uniform"] < meanflow_ratio, r, t)
            u, u_tgt = meanflow_target(lambda x_, t_, c_: model_apply(model, x_, t_, c_),
                                       _interp(source, target, r), r, t,
                                       v_star, cond, t_scale)
            sq = ((u - u_tgt.detach()) ** 2).mean(dim=(1, 2, 3))
            if meanflow_adaptive_p:
                loss = ((sq.detach() + 1e-3) ** (-meanflow_adaptive_p) * sq).mean()
            else:
                loss = sq.mean()
            (loss * loss_scale).backward()
            aux.update(loss_flow=loss.detach(), loss=loss.detach(),
                       loss_meanflow_raw=sq.mean().detach())
            return aux

        x = _interp(source, target, t)
        model_aux = None
        if curvature_weight:
            v, dv_dt = torch.func.jvp(lambda xx, tt: model_apply(model, xx, tt * t_scale, cond),
                                      (x, t), (v_star, torch.ones_like(t)))
            if isinstance(v, tuple):            # the (v, model_aux) contract
                (v, model_aux), dv_dt = v, dv_dt[0]
        else:
            v = model_apply(model, x, t * t_scale, cond)
            if isinstance(v, tuple):
                v, model_aux = v
        loss = ((v - v_star) ** 2).mean()
        aux["loss_flow"] = loss.detach()
        if model_aux is not None:
            loss = loss + model_aux
            aux["loss_model_aux"] = model_aux.detach()
        if curvature_weight:
            curv = (dv_dt ** 2).mean()
            loss = loss + curvature_weight * curv
            aux["loss_curvature"] = curv.detach()
        if inpainting and mask_identity_weight:
            ones_in = torch.ones_like(batch["mask_pixels"], dtype=target.dtype)
            mask_loss = (((mask_encoder(ones_in) - 1.0) ** 2).mean()
                         + (mask_encoder(torch.zeros_like(ones_in)) ** 2).mean())
            loss = loss + mask_identity_weight * mask_loss
            aux["loss_mask"] = mask_loss.detach()
        aux["loss"] = loss.detach()
        (loss * loss_scale).backward()
        return aux

    return grads_fn


def _slice(batch: dict, i: int, n: int) -> dict:
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}


def make_flow_train_step(cfg_dropout: float = 0.1, eps: float = 1e-3,
                         warp_s: float = 0.5, t_scale: float = 999.0,
                         ema_decay: float = 0.999, use_ot: bool = True,
                         encode_fn: Optional[Callable] = None,
                         ot_method: str = "parallel", ot_block: Optional[int] = None,
                         paired_source: bool = False, curvature_weight: float = 0.0,
                         meanflow: bool = False, meanflow_ratio: float = 0.25,
                         meanflow_adaptive_p: float = 0.5, grad_accum: int = 1,
                         mask_identity_weight: float = 1.0,
                         blank_latents: Optional[torch.Tensor] = None,
                         otf_aug: Optional[dict] = None, mesh=None,
                         model_apply: Optional[Callable] = None, fsdp: bool = False):
    """``step(state, batch, generator, draws=None, drop=None) -> (state,
    aux)``, updating ``state`` in place: the gradients (over ``grad_accum``
    microbatches), the clipped Adam updates of the model's group and, when
    the state holds a mask encoder, of its group, and the EMAs. ``draws`` is
    a list of one dict per microbatch; ``drop`` overrides the gate. ``aux``
    holds device scalars: the losses (the microbatches' mean),
    ``grad_norm`` (the global norm over both groups before clipping) and,
    with the parallel OT method, ``ot_rounds``.

    ``mesh`` (``parallel/mesh.py``): ``batch`` is this rank's rows and the
    step is data-parallel (per-rank ``generator`` and ``draws``), or with
    ``fsdp`` (a state sharded by ``shard_flow_state``; a world of one rank
    too) the FSDP step, whose ``generator`` and ``draws`` are global and
    alike on every rank. Every rank must call. Without a mesh, ``fsdp`` is
    the one-device step."""
    if meanflow and curvature_weight:
        raise ValueError("meanflow mode does not combine with curvature_weight "
                         "or the inpainting mask path")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    fsdp = fsdp and mesh is not None    # on the degenerate mesh, the plain step
    if fsdp and (meanflow or curvature_weight):
        raise ValueError("flow.fsdp does not combine with flow.meanflow or "
                         "flow.curvature_weight: forward-mode derivatives do not "
                         "pass FSDP2's hooks")
    dp = mesh if (not fsdp and batch_shard_count(mesh) > 1) else None
    grads_fn = make_flow_grads_fn(
        eps=eps, warp_s=warp_s, t_scale=t_scale, use_ot=use_ot, encode_fn=encode_fn,
        ot_method=ot_method, ot_block=ot_block, paired_source=paired_source,
        curvature_weight=curvature_weight, meanflow=meanflow,
        meanflow_ratio=meanflow_ratio, meanflow_adaptive_p=meanflow_adaptive_p,
        mask_identity_weight=mask_identity_weight, blank_latents=blank_latents,
        otf_aug=otf_aug, model_apply=model_apply)

    def step(state: FlowState, batch: dict, generator: torch.Generator,
             draws=None, drop=None):
        if meanflow and state.mask_encoder is not None:
            raise ValueError("meanflow mode does not combine with curvature_weight "
                             "or the inpainting mask path")
        if drop is None:
            drop = torch.rand((), generator=generator,
                              device=generator.device) < cfg_dropout
            if dp is not None or fsdp:
                drop = broadcast0_(drop, mesh)      # one gate for the global batch
        if fsdp:
            batch = {k: gather_rows(v, mesh) for k, v in batch.items()}
        state.opt.zero_grad()
        if state.mask_opt is not None:
            state.mask_opt.zero_grad()
        lead = next(iter(batch.values())).shape[0]
        if lead % grad_accum:
            raise ValueError(f"batch size {lead} is not divisible by "
                             f"grad_accum={grad_accum}")
        n = lead // grad_accum
        rows = None
        if fsdp:
            shards = batch_shard_count(mesh)
            if n % shards:
                raise ValueError(f"microbatch {n} does not split over {shards} ranks")
            r, per = batch_rank(mesh), n // shards
            rows = slice(r * per, (r + 1) * per)
        auxs = [grads_fn(state.model, _slice(batch, i, n) if grad_accum > 1 else batch,
                         drop, draws[i] if draws is not None else None, generator,
                         1.0 / grad_accum, mask_encoder=state.mask_encoder,
                         step=state.step, rows=rows)
                for i in range(grad_accum)]
        aux = {k: sum(a[k] for a in auxs) / grad_accum for k in auxs[0]}
        sync = dp if dp is not None else (mesh if fsdp else None)
        if sync is not None:
            # FSDP2 averages the sharded gradients; the rest are averaged here
            pmean_([p.grad for p in state.model.parameters() if not _is_dtensor(p)]
                   + [p.grad for p in (state.mask_encoder.parameters()
                                       if state.mask_encoder is not None else ())], sync)
            aux = {k: v.detach().float().clone() for k, v in aux.items()}
            pmean_(list(aux.values()), sync)
        norm = state.opt.step(state.step)
        if state.mask_opt is not None:
            norm = torch.sqrt(norm ** 2 + state.mask_opt.step(state.step) ** 2)
            ema_update(state.ema_mask_encoder, state.mask_encoder, ema_decay)
        aux["grad_norm"] = norm
        ema_update(state.ema, state.model, ema_decay)
        state.step += 1
        return state, aux

    return step


def make_flow_eval_step(eps: float = 1e-3, warp_s: float = 0.5, t_scale: float = 999.0,
                        use_ot: bool = True, ot_method: str = "parallel",
                        paired_source: bool = False):
    """Validation loss on a batch, same path, no update:
    ``eval_fn(model, batch, generator, draws=None, mask_encoder=None) ->
    loss`` (a device scalar); ``draws`` holds ``'noise'`` and
    ``'t_uniform'``. With ``mask_encoder`` and ``mask_pixels`` in the batch,
    the source is the mask blend of the batch's source and the noise, and
    the mask conditions the model."""

    @torch.no_grad()
    def eval_fn(model: nn.Module, batch: dict, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None, mask_encoder: Optional[nn.Module] = None):
        target = batch["target"]
        class_cond = batch.get("class_cond")
        B = target.shape[0]
        if draws is None:
            kw = dict(generator=generator, dtype=target.dtype, device=generator.device)
            draws = {"noise": torch.randn(tuple(target.shape), **kw),
                     "t_uniform": torch.rand(B, **kw)}
        mask = None
        if mask_encoder is not None and "mask_pixels" in batch:
            mask = mask_encoder(batch["mask_pixels"].to(target.dtype))
            src = batch["source"]
            source = src + mask * (draws["noise"] - src)
        elif paired_source:
            source = batch["source"].to(target.dtype)
        else:
            source = draws["noise"]
        if use_ot and not paired_source:
            idx = compute_ot_pairing(source, target, method=ot_method)
            target = target[idx]
            if class_cond is not None:
                class_cond = class_cond[idx]
        t = warp_time(draws["t_uniform"] * (1 - eps) + eps, s=warp_s)
        v = model(_interp(source, target, t), t * t_scale,
                  {"class_cond": class_cond, "mask_cond": mask})
        return ((v - (target - source)) ** 2).mean()

    return eval_fn
