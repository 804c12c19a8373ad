"""Losses and metrics, PyTorch port of ``flocoder_tpu/metrics.py``: the
codec-training losses (focal loss and piano-roll cross-entropy, the VGG
perceptual loss, the FFT spectral loss, hinge / LeCAM discriminator losses,
the generator loss with feature matching, ``compute_vqgan_losses`` and its
λ-weighted total), ``g2rgb``, the MIDI recipes' decode post-processing,
and the sample metrics of flow evaluation: ``to_uint8``,
``normalize_recon`` and ``compute_sample_metrics`` (FID on the rp2048
features of ``ops/fid.py``, the Sinkhorn divergence of ``ops/sinkhorn.py``,
MSEs and moments). Images are NHWC. A ``disc_apply`` maps images to
``(logits, features)`` (``models/discriminator.make_disc_apply``).

On bf16 operands (a codec, discriminator and perceptual net computing in
bf16) the losses keep JAX's dtypes: the hinge, generator, feature-matching,
LeCAM and perceptual terms stay bf16 (a bf16 ``mean`` accumulates in fp32
and rounds once, as ``jnp.mean`` does), a λ weight is rounded to the
term's dtype before it multiplies it (``layers.weak``), the MSE against
fp32 targets and the spectral loss are fp32.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .models.layers import weak
from .ops.fid import fid_score, fid_score_chunked
from .ops.sinkhorn import sinkhorn_loss, sinkhorn_loss_chunked

__all__ = ["focal_loss", "sigmoid_bce", "piano_roll_rgb_cross_entropy",
           "perceptual_loss", "spectral_loss", "hinge_d_loss",
           "feature_matching_loss", "discriminator_loss", "lecam_loss",
           "discriminator_loss_lecam", "generator_loss",
           "compute_vqgan_losses", "get_total_vqgan_loss", "g2rgb", "to_uint8",
           "normalize_recon", "compute_sample_metrics", "fid_score",
           "fid_score_chunked", "sinkhorn_loss", "sinkhorn_loss_chunked"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def sigmoid_bce(logits, labels):
    """Numerically stable sigmoid BCE on logits, elementwise."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def focal_loss(pred_logits, target_binary, alpha: float = 0.9,
               gamma: float = 2.0):
    """Binary focal loss on logits."""
    bce = sigmoid_bce(pred_logits, target_binary)
    p_t = torch.exp(-bce)
    alpha_t = alpha * target_binary + (1 - alpha) * (1 - target_binary)
    return (alpha_t * (1 - p_t) ** gamma * bce).mean()


def piano_roll_rgb_cross_entropy(pred, target, temperature: float = 0.25,
                                 onset_threshold: float = 0.3,
                                 sustain_threshold: float = 0.5):
    """Pixel-precision CE for piano-roll images: RGB channels are (onset,
    sustain, unused) with per-channel thresholds; gray uses sustain's."""
    if target.shape[-1] == 1:
        thresholds = [sustain_threshold]
    else:
        thresholds = [onset_threshold, sustain_threshold, 1.0]
    t = torch.tensor(thresholds, device=target.device, dtype=target.dtype)
    return focal_loss(pred / temperature, (target > t).to(pred.dtype))


def perceptual_loss(feature_fn: Callable, img1, img2):
    """Sum over feature maps of the MSE between ImageNet-normalised images'
    features (``models/perceptual.py``)."""
    mean = torch.tensor(_IMAGENET_MEAN, device=img1.device)
    std = torch.tensor(_IMAGENET_STD, device=img1.device)
    if img1.shape[-1] != 3:
        img1 = img1.repeat_interleave(3, dim=-1)[..., :3]
        img2 = img2.repeat_interleave(3, dim=-1)[..., :3]
    f1 = feature_fn((img1 - mean) / std)
    f2 = feature_fn((img2 - mean) / std)
    return sum(((a - b) ** 2).mean() for a, b in zip(f1, f2))


def spectral_loss(x, x_recon):
    """MSE between 2-D FFT magnitudes over the spatial axes."""
    def pwr(y):
        return torch.fft.fft2(y.float(), dim=(1, 2)).abs()
    return ((pwr(x) - pwr(x_recon)) ** 2).mean()


def hinge_d_loss(real_pred, fake_pred):
    return F.relu(1.0 - real_pred).mean() + F.relu(1.0 + fake_pred).mean()


def feature_matching_loss(real_features, fake_features):
    """L1 between discriminator feature maps; real features are constants."""
    loss = sum((ff - rf.detach()).abs().mean()
               for rf, ff in zip(real_features, fake_features))
    return loss / max(len(real_features), 1)


def discriminator_loss(disc_apply: Callable, real_images, fake_images):
    """Hinge D loss. Returns (d_loss, real_features)."""
    real_pred, real_features = disc_apply(real_images)
    fake_pred, _ = disc_apply(fake_images.detach())
    return hinge_d_loss(real_pred, fake_pred), real_features


def lecam_loss(d_real, d_fake, reg_weight: float = 0.001):
    reg = F.relu(1.0 + d_real).mean() + F.relu(1.0 - d_fake).mean()
    return weak(reg_weight, reg) * reg


def discriminator_loss_lecam(disc_apply: Callable, real_images, fake_images,
                             reg_weight: float = 0.001):
    """Hinge D loss plus LeCAM regularisation. Returns (d_loss,
    real_features)."""
    real_pred, real_features = disc_apply(real_images)
    fake_pred, _ = disc_apply(fake_images.detach())
    return (hinge_d_loss(real_pred, fake_pred) +
            lecam_loss(real_pred, fake_pred, reg_weight), real_features)


def generator_loss(disc_apply: Callable, fake_images, real_features=None):
    """Non-saturating hinge G loss plus optional feature matching."""
    fake_pred, fake_features = disc_apply(fake_images)
    g_loss = -fake_pred.mean()
    if real_features is not None:
        g_loss = g_loss + feature_matching_loss(real_features, fake_features)
    return g_loss


def compute_vqgan_losses(recon, target_imgs, vq_loss, config,
                         perceptual_fn: Optional[Callable] = None,
                         disc_apply: Optional[Callable] = None,
                         warmed_up: bool = False, report_d_loss: bool = True,
                         real_features=None) -> dict:
    """The codec's losses: mse, vq, perceptual (λ_perc > 0 and a feature
    function), ce (λ_ce > 0), and after warm-up with a discriminator the
    λ_gen-weighted generator loss (plus the monitoring hinge D loss unless
    ``report_d_loss`` is off). ``real_features`` supplies the
    feature-matching targets and skips the real forward."""
    cc = config.codec
    losses = {"mse": ((recon - target_imgs) ** 2).mean(), "vq": vq_loss}
    if float(cc.get("lambda_perc", 0)) > 0 and perceptual_fn is not None:
        losses["perceptual"] = perceptual_loss(perceptual_fn, recon, target_imgs)
    if float(cc.get("lambda_ce", 0)) > 0:
        losses["ce"] = piano_roll_rgb_cross_entropy(recon, target_imgs)
    if disc_apply is not None and warmed_up:
        if real_features is not None:
            pass  # targets supplied by the caller; no real forward
        elif report_d_loss:
            d_loss, real_features = discriminator_loss(disc_apply, target_imgs, recon)
            losses["d_loss"] = d_loss
        else:
            with torch.no_grad():   # the targets are constants either way
                _, real_features = disc_apply(target_imgs)
        g_loss = generator_loss(disc_apply, recon, real_features)
        losses["g_loss"] = weak(float(cc.get("lambda_gen", 0.05)), g_loss) * g_loss
    return losses


def get_total_vqgan_loss(losses: dict, config):
    """λ-weighted total."""
    cc = config.codec

    def term(name: str, key: str, default: float):
        lam, loss = float(cc.get(name, default)), losses.get(key, 0.0)
        return (weak(lam, loss) if torch.is_tensor(loss) else lam) * loss

    return (term("lambda_mse", "mse", 0.5) + term("lambda_vq", "vq", 0.25) +
            term("lambda_ce", "ce", 0.0) + term("lambda_perc", "perceptual", 0.0) +
            losses.get("g_loss", 0.0))


def g2rgb(gf_img: torch.Tensor, keep_gray: bool = False) -> torch.Tensor:
    """Grayscale float → quantized RGB piano roll. NHWC; a 3-channel input
    passes through."""
    if gf_img.shape[-1] == 3:
        return gf_img
    gf = gf_img[..., 0]
    if keep_gray:
        return (gf > 0.5).float()[..., None].expand(*gf.shape, 3)
    return torch.stack([(gf >= 0.75).float(),
                        ((gf - 0.5).abs() < 0.25).float(),
                        torch.zeros_like(gf)], dim=-1)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max to uint8 (truncating, as the JAX cast does)."""
    x = x.detach()
    x = x - x.amin(dim=(1, 2, 3), keepdim=True)
    mx = x.amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-5)
    return (x / mx * 255.0).clamp(0, 255).to(torch.uint8)


def normalize_recon(orig: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """Each recon image's channels rescaled to the original's range."""
    o_min, o_max = orig.amin(dim=(1, 2), keepdim=True), orig.amax(dim=(1, 2), keepdim=True)
    r_min, r_max = recon.amin(dim=(1, 2), keepdim=True), recon.amax(dim=(1, 2), keepdim=True)
    rescaled = (recon - r_min) / (r_max - r_min).clamp(min=1e-8) * (o_max - o_min) + o_min
    return torch.where(r_max > r_min, rescaled, recon)


@torch.no_grad()
def compute_sample_metrics(pred_latents, target_latents, decoded_pred, decoded_target,
                           feature_fn: Optional[Callable] = None) -> dict:
    """FID in pixel space (on per-image uint8 renders), the Sinkhorn
    divergence of latents and of pixels, MSEs and moments; a dict of device
    scalars under the JAX package's keys."""
    bs = min(pred_latents.shape[0], target_latents.shape[0])
    pl, tl = pred_latents[:bs], target_latents[:bs]
    decoded_pred = normalize_recon(decoded_target, decoded_pred)
    if feature_fn is None:
        from .ops.fid import default_feature_fn
        feature_fn = default_feature_fn(image_size=decoded_target.shape[1])
    return {
        "FID_px": fid_score(to_uint8(decoded_target), to_uint8(decoded_pred),
                            feature_fn=feature_fn),
        "sinkhorn": sinkhorn_loss(tl, pl),
        "sinkhorn_px": sinkhorn_loss(decoded_target, decoded_pred),
        "mse": ((pl - tl) ** 2).mean(),
        "mse_px": ((decoded_pred - decoded_target) ** 2).mean(),
        "pred_mean": pl.mean(), "targ_mean": tl.mean(),
        "pred_std": pl.std(unbiased=False), "targ_std": tl.std(unbiased=False),
        "pred_px_mean": decoded_pred.mean(),
        "targ_px_mean": decoded_target.mean(),
        "pred_px_std": decoded_pred.std(unbiased=False),
        "targ_px_std": decoded_target.std(unbiased=False),
    }
