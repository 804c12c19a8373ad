"""DAC audio codec training, PyTorch port of ``flocoder_tpu/training/audio.py``:
the reconstruction step, the GAN step and the eval step.

- Losses (``audio_codec_losses``): waveform L1, the multi-scale log-mel
  L1, the multi-scale STFT loss on the first two FFT sizes and the RVQ
  commitment, weighted by ``codec.lambda_{wave,mel,stft,vq}``.
- The codec's optimizer is optax's ``chain(clip_by_global_norm(1.0),
  adam(lr, b1=0.8, b2=0.99))`` (``make_audio_optimizer``); the
  discriminators' is ``make_vqgan_optimizers``' (Adam (0.9, 0.999) at
  lr·``d_lr_scale``, clipped to norm 1). The RVQ state is not trained by
  gradients: it takes the forward's new state (EMA).
- The GAN step keeps the JAX order on one codec forward: the
  discriminators' hinge loss over the ensemble on the batch and on
  ``recon.detach()``, their update; then the generator's loss through the
  just-updated discriminators (non-saturating hinge and feature matching,
  each averaged over the ensemble; the real features are the discriminator
  step's, detached), and the backward into the codec only.
- The RVQ's draws come from the step's ``generator``, or are injected
  (``kmeans_seeds``, ``reseed_picks``; ``ops/rvq.py``).
- With a data-parallel ``mesh`` (``parallel/mesh.py``) each rank steps on
  its own rows; the gradients and the reported losses are averaged over
  the batch ranks before the updates and the RVQ statistics summed, as in
  ``training/vqgan.py`` (the JAX ``_mesh_wrap``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..metrics import feature_matching_loss, hinge_d_loss
from ..ops.audio import multiscale_mel_loss, multiscale_stft_loss
from .vqgan import ClippedAdam, VQGANState, _dp, _pmean_aux, _pmean_grads, g_trainable

__all__ = ["make_audio_optimizer", "create_audio_state", "audio_codec_losses",
           "make_audio_train_step", "make_audio_gan_step", "make_audio_eval_step"]


def make_audio_optimizer(codec: nn.Module, learning_rate: float,
                         grad_clip: float = 1.0) -> ClippedAdam:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr, b1=0.8,
    b2=0.99))`` over the encoder's and decoder's parameters."""
    return ClippedAdam(g_trainable(codec), learning_rate, grad_clip, betas=(0.8, 0.99))


def create_audio_state(codec: nn.Module, disc: Optional[nn.Module], learning_rate: float,
                       d_lr_scale: float = 1.0, grad_clip: float = 1.0) -> VQGANState:
    """The codec with ``make_audio_optimizer`` and, with ``disc``, the
    discriminators with Adam at lr·``d_lr_scale`` (``make_vqgan_optimizers``'
    discriminator optimizer)."""
    opt_d = (ClippedAdam(disc.parameters(), learning_rate * d_lr_scale, grad_clip)
             if disc is not None else None)
    return VQGANState(codec=codec, opt_g=make_audio_optimizer(codec, learning_rate, grad_clip),
                      disc=disc, opt_d=opt_d)


def _codec_cfg(config):
    return config.codec if "codec" in config else {}


def _loss_cfg(config) -> dict:
    cc = _codec_cfg(config)
    return {"lambda_wave": float(cc.get("lambda_wave", 1.0)),
            "lambda_mel": float(cc.get("lambda_mel", 15.0)),
            "lambda_stft": float(cc.get("lambda_stft", 1.0)),
            "lambda_vq": float(cc.get("lambda_vq", 1.0)),
            "sample_rate": int(cc.get("sample_rate", 16000)),
            "fft_sizes": tuple(cc.get("fft_sizes", [512, 1024, 2048])),
            "n_mels": tuple(cc.get("n_mels", [40, 80, 160]))}


def audio_codec_losses(recon, target, commit_loss, cfg: dict) -> dict:
    """The DAC loss bundle on (B, T, 1) or (B, T) waveforms; ``cfg`` from
    ``_loss_cfg``."""
    x = target[..., 0] if target.ndim == 3 else target
    y = recon[..., 0] if recon.ndim == 3 else recon
    losses = {"wave_l1": (x - y).abs().mean(),
              "mel": multiscale_mel_loss(x, y, cfg["sample_rate"], fft_sizes=cfg["fft_sizes"],
                                         n_mels=cfg["n_mels"]),
              "stft": multiscale_stft_loss(x, y, fft_sizes=cfg["fft_sizes"][:2]),
              "vq": commit_loss}
    losses["total"] = (cfg["lambda_wave"] * losses["wave_l1"]
                       + cfg["lambda_mel"] * losses["mel"]
                       + cfg["lambda_stft"] * losses["stft"]
                       + cfg["lambda_vq"] * losses["vq"])
    return losses


def _detached(losses: dict) -> dict:
    return {k: v.detach() for k, v in losses.items()}


def make_audio_train_step(config, mesh=None):
    """Reconstruction phase: ``step(state, batch (B, T, 1), generator,
    **draws) -> (state, aux, indices)``; ``state`` is updated in place, its
    discriminators untouched. With a ``mesh``, ``batch`` is this rank's
    rows."""
    mesh = _dp(mesh)
    cfg = _loss_cfg(config)

    def step(state: VQGANState, batch, generator, **draws):
        codec = state.codec
        state.opt_g.zero_grad()
        recon, commit, idx, new_vq = codec(batch, train=True, generator=generator,
                                           mesh=mesh, **draws)
        losses = audio_codec_losses(recon, batch, commit, cfg)
        losses["total"].backward()
        _pmean_grads(state.opt_g.params, mesh)
        state.opt_g.step()
        codec.vq.assign_(new_vq)
        state.step += 1
        return state, _pmean_aux(_detached(losses), mesh), idx

    return step


def _mean(terms: list) -> torch.Tensor:
    return sum(terms) / len(terms)


def make_audio_gan_step(config, mesh=None):
    """Adversarial phase, the discriminator step then the generator step on
    one codec forward: ``step(state, batch, generator, mark=None, **draws)
    -> (state, aux, indices)``. ``mark(name)``, when given, is called after
    each part ("codec_forward", "d_step", "g_loss_backward",
    "optimizers"). With a ``mesh``, ``batch`` is this rank's rows."""
    mesh = _dp(mesh)
    cfg = _loss_cfg(config)
    cc = _codec_cfg(config)
    lambda_gen = float(cc.get("lambda_gen", 1.0))
    lambda_feat = float(cc.get("lambda_feat", 2.0))

    def step(state: VQGANState, batch, generator, mark=None, **draws):
        mark = mark or (lambda name: None)
        x = batch if batch.ndim == 3 else batch[..., None]
        codec, disc = state.codec, state.disc
        state.opt_g.zero_grad()
        state.opt_d.zero_grad()
        recon, commit, idx, new_vq = codec(x, train=True, generator=generator,
                                           mesh=mesh, **draws)
        mark("codec_forward")

        real_logits, real_feats = disc(x)
        fake_logits, _ = disc(recon.detach())
        d_loss = _mean([hinge_d_loss(r, f) for r, f in zip(real_logits, fake_logits)])
        d_loss.backward()
        _pmean_grads(state.opt_d.params, mesh)
        state.opt_d.step()
        mark("d_step")

        # the generator's loss through the just-updated discriminators
        disc.requires_grad_(False)
        losses = audio_codec_losses(recon, x, commit, cfg)
        fake_logits, fake_feats = disc(recon)
        losses["gen"] = _mean([-lg.mean() for lg in fake_logits])
        losses["feat"] = _mean([feature_matching_loss([f.detach() for f in rf], ff)
                                for rf, ff in zip(real_feats, fake_feats)])
        losses["total"] = (losses["total"] + lambda_gen * losses["gen"]
                           + lambda_feat * losses["feat"])
        losses["total"].backward()
        disc.requires_grad_(True)
        mark("g_loss_backward")
        _pmean_grads(state.opt_g.params, mesh)
        state.opt_g.step()
        codec.vq.assign_(new_vq)
        mark("optimizers")
        state.step += 1
        aux = _detached(losses)
        aux["d_loss"] = d_loss.detach()
        return state, _pmean_aux(aux, mesh), idx

    return step


def make_audio_eval_step(config):
    """``eval_fn(codec, batch) -> (recon, losses, indices)``, no state
    change."""
    cfg = _loss_cfg(config)

    @torch.no_grad()
    def eval_fn(codec, batch):
        recon, commit, idx, _ = codec(batch, train=False)
        return recon, audio_codec_losses(recon, batch, commit, cfg), idx

    return eval_fn
