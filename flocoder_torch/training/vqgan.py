"""VQGAN codec training steps, PyTorch port of
``flocoder_tpu/training/vqgan.py``: the warmup step (reconstruction only),
the GAN step and the eval step.

- Optimizers are optax's ``chain(clip_by_global_norm(c), adam(lr))``:
  ``ClippedAdam`` scales the gradients by c / max(‖g‖, c) over all of its
  parameters (not ``clip_grad_norm_``, which adds 1e-6), then runs
  ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8, optax's update) on the
  fp32 parameters and optax's arithmetic on a bf16 one. The
  discriminator's learning rate is lr·1e-3. The RVQ codebooks are updated
  by EMA (``ops/rvq.py``), never by an optimizer.
- The steps take the codec, the discriminator and the perceptual net in
  the compute dtype they were built with: with ``codec.bf16`` all three
  compute in bf16 over fp32 parameters, as the JAX script builds them
  (``train_vqgan.py``); NATTEN's ``gamma`` is a bf16 parameter, the RVQ
  works in fp32, and the losses keep JAX's dtypes (``metrics.py``).
- The GAN step keeps the JAX order and runs the codec forward once: recon;
  discriminator step on ``recon.detach()`` (real batch then fake, power
  iterations advancing), its update; the generator loss against the updated
  discriminator with its statistics frozen; the backward into the codec
  only (the discriminator's parameters do not collect the generator's
  gradients).
- ``grad_accum`` splits the batch into leading microbatch slices. Each
  slice's loss, divided by ``grad_accum``, is backpropagated, and the RVQ
  state chains through the slices (each slice quantizes with the state the
  previous one left); then one optimizer step. In the GAN step every slice
  also takes its discriminator gradients, its power iterations advancing,
  and its generator loss sees the discriminator before this step's update
  (the JAX package's simultaneous update); at ``grad_accum=1`` the step is
  the alternating one above.
- ``deterministic=True`` turns dropout and NoiseInjection off (parity tests
  only). The steps pass their ``**draws`` (the RVQ's injected
  ``kmeans_seeds``/``reseed_picks``) to the codec.
- Data parallelism (``mesh``, ``parallel/mesh.py``; the JAX ``_mesh_wrap``):
  each rank steps on its own rows of the batch; the discriminator's and
  the codec's gradients, the discriminator's power-iteration vectors and
  the reported losses are averaged over the batch ranks before the
  updates, the RVQ statistics summed (``ops/rvq.py``), and the indices
  returned are the rank's own. ``grad_accum`` splits each rank's rows.
  Tensor parallelism is the model axis (ROADMAP.md item 13b-ii).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..metrics import (compute_vqgan_losses, get_total_vqgan_loss,
                       hinge_d_loss, lecam_loss)
from ..models.layers import weak
from ..models.discriminator import make_disc_apply
from ..parallel.mesh import batch_shard_count, pmean_, sharded_sq_norm

__all__ = ["ClippedAdam", "VQGANState", "create_vqgan_state",
           "make_vqgan_optimizers", "make_vqgan_warmup_step",
           "make_vqgan_gan_step", "make_vqgan_eval_step", "g_trainable"]


_WIDE = (torch.float32, torch.float64)     # the dtypes torch.optim.Adam steps


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2))``
    over ``params``, ``betas`` = (b1, b2) (optax's default (0.9, 0.999);
    the audio codec's optimizer takes (0.8, 0.99)). A parameter without a gradient takes a zero one, as optax
    gives every leaf a gradient. ``lr`` is a float or a host function
    ``schedule(count) -> float`` of the optimizer step, as optax's.

    fp32 (and float64) parameters step through ``torch.optim.Adam``
    (``self.adam``), whose arithmetic differs from optax's only in rounding
    order at fp32. A parameter in a narrower dtype (NATTEN's bf16 ``gamma``
    in a bf16 codec) follows optax op by op in its own dtype, as optax keeps
    such a leaf: its squared norm is rounded to that dtype before it joins
    the global norm, it is clipped as ``t / norm · c`` in that dtype, its
    moments are held in that dtype, every constant is rounded to it before
    it multiplies (JAX's weak types), and the bias corrections are formed in
    fp32 and then rounded. Its state sits in ``self.narrow_state`` under
    torch's keys (``step``, ``exp_avg``, ``exp_avg_sq``); ``state_of(p)``
    reads either."""

    eps = 1e-8

    def __init__(self, params, lr, grad_clip: float = 1.0, betas=(0.9, 0.999)):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.betas = tuple(betas)
        self.schedule = lr if callable(lr) else None
        self.lr = 0.0 if callable(lr) else lr
        self.narrow = [p for p in self.params if p.dtype not in _WIDE]
        self.narrow_state: dict = {}
        # FSDP2's sharded parameters (DTensors) take the per-tensor Adam:
        # torch's foreach kernels refuse a list mixing them with tensors
        self.sharded = any(_is_dtensor(p) for p in self.params)
        if self.sharded and self.narrow:
            raise ValueError("a sharded optimizer steps fp32 parameters only")
        self.adam = torch.optim.Adam([p for p in self.params if p.dtype in _WIDE],
                                     lr=self.lr, betas=self.betas, eps=self.eps,
                                     foreach=False if self.sharded else None)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)
        for p in self.narrow:
            p.grad = None

    def state_of(self, p) -> dict:
        """The Adam state (``step``, ``exp_avg``, ``exp_avg_sq``) of ``p``;
        empty before its first step."""
        return (self.adam.state if p.dtype in _WIDE else self.narrow_state).get(p, {})

    @torch.no_grad()
    def step(self, count: int = 0) -> torch.Tensor:
        """One update; ``count`` is the step the schedule reads. Returns the
        gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        wide = [p.grad for p in self.adam.param_groups[0]["params"]]
        if self.sharded:
            norm = _sharded_norm(wide)
            wide = [g.to_local() if _is_dtensor(g) else g for g in wide]
        else:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in wide]))
        if self.narrow:
            # optax's global norm: each leaf's sum of squares in its dtype
            norm = torch.sqrt(norm.square() + sum(
                (p.grad * p.grad).sum().to(norm.dtype) for p in self.narrow))
        torch._foreach_mul_(wide, self.grad_clip / norm.clamp(min=self.grad_clip))
        lr = self.lr if self.schedule is None else self.schedule(count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        for p in self.narrow:
            self._narrow_step(p, norm, lr)
        return norm

    def _narrow_step(self, p, norm, lr: float) -> None:
        """optax's clip and Adam on one leaf, in the leaf's own dtype."""
        (b1, b2), dt = self.betas, p.dtype
        st = self.narrow_state.setdefault(p, {})
        if not st:
            st.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                      exp_avg_sq=torch.zeros_like(p))
        g = p.grad
        g = torch.where(norm < self.grad_clip, g,
                        g / norm.to(dt) * weak(self.grad_clip, g))
        mu = g * weak(1 - b1, g) + st["exp_avg"] * weak(b1, g)
        nu = (g * g) * weak(1 - b2, g) + st["exp_avg_sq"] * weak(b2, g)
        st["step"] += 1
        n = int(st["step"])

        def corrected(m, b):        # 1 − bⁿ formed in fp32, then rounded to dt
            c = float(np.float32(1) - np.float32(b) ** np.float32(n))
            return m / torch.full((), c, dtype=dt, device=m.device)

        update = corrected(mu, b1) / (torch.sqrt(corrected(nu, b2)) + weak(self.eps, g))
        p.add_(update * weak(-lr, g))
        st["exp_avg"], st["exp_avg_sq"] = mu, nu


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _sharded_norm(grads: list) -> torch.Tensor:
    """The global norm of gradients some of which are FSDP2 shards: the
    shards' squares summed over their mesh (a collective), the replicated
    ones' added once."""
    sq = [torch.linalg.vector_norm(g) ** 2 for g in grads if not _is_dtensor(g)]
    shards = [g for g in grads if _is_dtensor(g)]
    total = torch.stack(sq).sum() if sq else None
    if shards:
        part = sharded_sq_norm(shards)
        total = part if total is None else total + part
    return torch.sqrt(total)


def g_trainable(codec: nn.Module) -> list:
    """The encoder's and decoder's parameters; the RVQ state is buffers."""
    return [*codec.encoder.parameters(), *codec.decoder.parameters()]


def make_vqgan_optimizers(codec: nn.Module, disc: Optional[nn.Module],
                          learning_rate: float, d_lr_scale: float = 1e-3,
                          grad_clip: float = 1.0) -> tuple:
    """Generator Adam at lr and discriminator Adam at lr·d_lr_scale, each
    after a global-norm clip."""
    opt_g = ClippedAdam(g_trainable(codec), learning_rate, grad_clip)
    opt_d = (ClippedAdam(disc.parameters(), learning_rate * d_lr_scale, grad_clip)
             if disc is not None else None)
    return opt_g, opt_d


@dataclass
class VQGANState:
    codec: nn.Module
    opt_g: ClippedAdam
    disc: Optional[nn.Module] = None
    opt_d: Optional[ClippedAdam] = None
    step: int = 0


def create_vqgan_state(codec, disc, learning_rate: float, **kw) -> VQGANState:
    opt_g, opt_d = make_vqgan_optimizers(codec, disc, learning_rate, **kw)
    return VQGANState(codec=codec, opt_g=opt_g, disc=disc, opt_d=opt_d)


def _check_accum(grad_accum: int) -> None:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")


def _dp(mesh):
    """The mesh when it splits the batch, else None."""
    return mesh if batch_shard_count(mesh) > 1 else None


def _pmean_grads(params, mesh) -> None:
    """Average the gradients of ``params`` over the batch ranks."""
    if mesh is not None:
        pmean_([p.grad for p in params], mesh)


def _pmean_aux(aux: dict, mesh) -> dict:
    if mesh is None:
        return aux
    aux = {k: v.detach().clone() for k, v in aux.items()}
    pmean_(list(aux.values()), mesh)
    return aux


def _micro(batch, grad_accum: int) -> list:
    if batch.shape[0] % grad_accum:
        raise ValueError(f"batch size {batch.shape[0]} is not divisible by "
                         f"grad_accum={grad_accum}")
    return list(batch.chunk(grad_accum)) if grad_accum > 1 else [batch]


def _mean_aux(auxs: list) -> dict:
    return {k: sum(a[k] for a in auxs) / len(auxs) for k in auxs[0]}


def _aux(losses: dict, total) -> dict:
    out = {k: v.detach() for k, v in losses.items()}
    out["total"] = total.detach()
    return out


def make_vqgan_warmup_step(config, perceptual_fn: Optional[Callable] = None,
                           mesh=None, grad_accum: int = 1,
                           deterministic: bool = False):
    """Reconstruction-only phase: ``step(state, batch, generator, **draws)
    -> (state, aux, indices)``; ``state`` is updated in place. With a
    ``mesh``, ``batch`` is this rank's rows."""
    _check_accum(grad_accum)
    mesh = _dp(mesh)

    def step(state: VQGANState, batch, generator, **draws):
        codec = state.codec
        state.opt_g.zero_grad()
        auxs, idxs = [], []
        for sub in _micro(batch, grad_accum):
            recon, commit, idx, new_vq = codec(sub, train=True, generator=generator,
                                               deterministic=deterministic, mesh=mesh,
                                               **draws)
            losses = compute_vqgan_losses(recon, sub, commit, config,
                                          perceptual_fn=perceptual_fn)
            total = get_total_vqgan_loss(losses, config)
            (total / grad_accum).backward()
            codec.vq.assign_(new_vq)
            auxs.append(_aux(losses, total))
            idxs.append(idx)
        _pmean_grads(state.opt_g.params, mesh)
        state.opt_g.step()
        state.step += 1
        return state, _pmean_aux(_mean_aux(auxs), mesh), torch.cat(idxs)

    return step


def make_vqgan_gan_step(config, perceptual_fn: Optional[Callable] = None,
                        lecam_weight: float = 0.0, mesh=None,
                        grad_accum: int = 1, deterministic: bool = False):
    """GAN phase, discriminator step then generator step on one codec
    forward: ``step(state, batch, generator) -> (state, aux, indices)``.
    ``codec.share_real_features=true`` reuses the discriminator step's real
    features as the feature-matching targets instead of a second real
    forward through the updated discriminator. ``mark(name)``, when given,
    is called after each part of the step ("codec_forward", "d_step",
    "g_loss_backward", "optimizers"), for a breakdown of its time. With a
    ``mesh``, ``batch`` is this rank's rows."""
    _check_accum(grad_accum)
    mesh = _dp(mesh)
    share_real_features = bool(config.codec.get("share_real_features", False))

    def sync_disc(disc, opt_d) -> None:
        """The discriminator's gradients and power-iteration vectors,
        averaged over the batch ranks (the vectors agree already: they
        follow the replicated weights alone)."""
        if mesh is not None:
            _pmean_grads(opt_d.params, mesh)
            pmean_([b for b in disc.buffers() if b.is_floating_point()], mesh)

    def step(state: VQGANState, batch, generator, mark=None, **draws):
        if grad_accum > 1:
            return accum_step(state, batch, generator, **draws)
        mark = mark or (lambda name: None)
        codec, disc = state.codec, state.disc
        state.opt_g.zero_grad()
        state.opt_d.zero_grad()
        recon, commit, idx, new_vq = codec(batch, train=True, generator=generator,
                                           deterministic=deterministic, mesh=mesh, **draws)
        mark("codec_forward")

        # discriminator step, power iterations advancing: real, then fake
        real_pred, real_features = disc(batch, update_stats=True)
        fake_pred, _ = disc(recon.detach(), update_stats=True)
        d_loss = hinge_d_loss(real_pred, fake_pred)
        if lecam_weight > 0:
            d_loss = d_loss + lecam_loss(real_pred, fake_pred, lecam_weight)
        d_loss.backward()
        sync_disc(disc, state.opt_d)
        state.opt_d.step()
        mark("d_step")

        # generator step against the updated discriminator, stats frozen
        disc.requires_grad_(False)
        losses = compute_vqgan_losses(
            recon, batch, commit, config, perceptual_fn=perceptual_fn,
            disc_apply=make_disc_apply(disc, update_stats=False),
            warmed_up=True, report_d_loss=False,
            real_features=([f.detach() for f in real_features]
                           if share_real_features else None))
        total = get_total_vqgan_loss(losses, config)
        total.backward()
        disc.requires_grad_(True)
        mark("g_loss_backward")
        _pmean_grads(state.opt_g.params, mesh)
        state.opt_g.step()
        codec.vq.assign_(new_vq)
        mark("optimizers")
        state.step += 1
        aux = _aux(losses, total)
        aux["d_loss"] = d_loss.detach()
        return state, _pmean_aux(aux, mesh), idx

    def accum_step(state: VQGANState, batch, generator, **draws):
        """Simultaneous update over microbatches: every slice's D and G
        gradients against the discriminator's weights before the update."""
        codec, disc = state.codec, state.disc
        state.opt_g.zero_grad()
        state.opt_d.zero_grad()
        auxs, idxs = [], []
        for sub in _micro(batch, grad_accum):
            recon, commit, idx, new_vq = codec(sub, train=True, generator=generator,
                                               deterministic=deterministic, mesh=mesh,
                                               **draws)
            real_pred, real_features = disc(sub, update_stats=True)
            fake_pred, _ = disc(recon.detach(), update_stats=True)
            d_loss = hinge_d_loss(real_pred, fake_pred)
            if lecam_weight > 0:
                d_loss = d_loss + lecam_loss(real_pred, fake_pred, lecam_weight)
            (d_loss / grad_accum).backward()
            disc.requires_grad_(False)
            losses = compute_vqgan_losses(
                recon, sub, commit, config, perceptual_fn=perceptual_fn,
                disc_apply=make_disc_apply(disc, update_stats=False),
                warmed_up=True, report_d_loss=False,
                real_features=([f.detach() for f in real_features]
                               if share_real_features else None))
            total = get_total_vqgan_loss(losses, config)
            (total / grad_accum).backward()
            disc.requires_grad_(True)
            codec.vq.assign_(new_vq)
            aux = _aux(losses, total)
            aux["d_loss"] = d_loss.detach()
            auxs.append(aux)
            idxs.append(idx)
        sync_disc(disc, state.opt_d)
        _pmean_grads(state.opt_g.params, mesh)
        state.opt_d.step()
        state.opt_g.step()
        state.step += 1
        return state, _pmean_aux(_mean_aux(auxs), mesh), torch.cat(idxs)

    return step


def make_vqgan_eval_step(config, perceptual_fn: Optional[Callable] = None):
    """Validation reconstruction and losses, deterministic:
    ``eval_fn(codec, batch) -> (recon, losses, indices)``."""

    @torch.no_grad()
    def eval_fn(codec, batch):
        recon, commit, idx, _ = codec(batch, train=False)
        losses = compute_vqgan_losses(recon, batch, commit, config,
                                      perceptual_fn=perceptual_fn)
        losses["total"] = get_total_vqgan_loss(losses, config)
        return recon, losses, idx

    return eval_fn
