"""Sampling and evaluation orchestration, PyTorch port of
``flocoder_tpu/evaluation.py``: ``decode_latents``, ``sampler``,
``make_e2e_sampler`` and ``evaluate_model``, on one device.

The JAX package fuses generate + decode into one cached XLA executable and
can shard it over a mesh; PyTorch runs eagerly, so here the model, the
codec and the generator simply live on one device. ``evaluate_model``
samples, decodes through the codec (K1 in the VQGAN decoder's NATTEN block
on the card), computes the sample metrics, tracks codebook usage and saves
grids; a ``mark(name)`` callback, when given, is called after each of its
parts. An inpainting evaluation passes the latent masks in
``cond['mask_cond']``, the mask-blended sources in ``source`` and the pixel
masks in ``mask_pixels``; their grids are saved beside the others.
``evaluate_model_audio`` is the DAC codec's twin: folded latents decoded to
waveforms, the latent Sinkhorn and a log-mel one (``sinkhorn_mel``), and
WAVs instead of grids. With ``use_wandb`` (the trainers' ``not no_wandb``)
both log as the JAX functions do to the open metrics log
(``utils/logging.py``): ``metrics/<tag><name>`` with ``epoch``, and
``evaluate_model`` also each grid (``demo/…``) and the codebook usage
(``codebook/…``).

Sharded serving (``mesh``, ``parallel/mesh.py``; the JAX shard_map
sampler): with more than one batch rank and a batch that divides, each
rank integrates and decodes its own rows from its own noise (the caller's
``generator`` is the rank's stream, the JAX ``fold_in`` of the shard
index), the condition rows its share of the global ones (a drawn class
grid is batch rank 0's), and the latents and images are gathered on every
rank in rank order; ``evaluate_model`` then computes its metrics on every
rank and writes its grids and logs on rank 0 only. A batch that does not
divide runs whole on every rank, as in the JAX package. Every rank must
call.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .data.audio_io import save_wav
from .metrics import compute_sample_metrics, g2rgb, sinkhorn_loss
from .ops.audio import mel_filterbank, stft
from .parallel.mesh import batch_shard_count, broadcast0_, gather_rows, is_writer, shard_batch
from .sampling import generate_latents
from .utils import logging as wblog
from .utils.codebook_analysis import analyze_codebooks
from .utils.viz import save_img_grid

__all__ = ["DECODE_CHUNK", "decode_latents", "sampler", "make_e2e_sampler",
           "evaluate_model", "evaluate_model_audio"]

DECODE_CHUNK = 128      # latents per decoder call


@torch.inference_mode()
def decode_latents(codec, latents: torch.Tensor, is_midi: bool = False,
                   keep_gray: bool = False, chunk_size: int = DECODE_CHUNK):
    """Chunked decode with MIDI g2rgb post-processing."""
    outs = []
    for i in range(0, latents.shape[0], chunk_size):
        dec = codec.decode(latents[i:i + chunk_size])
        outs.append(g2rgb(dec, keep_gray=keep_gray) if is_midi else dec)
    return torch.cat(outs, dim=0)


def _sample_latents(model_apply: Callable, codec, generator: torch.Generator,
                    method: str, batch_size: int, n_steps: int, cond: Optional[dict],
                    n_classes: int, latent_shape, cfg_strength: float, source,
                    init_image, init_latents, init_strength: float,
                    t_scale: float, mesh=None) -> tuple:
    """``sampler`` without the decode: ``(pred_latents, nfe)``; under a
    sharded ``mesh`` (``_split``) the latents are this rank's rows."""
    device = generator.device
    if init_latents is None and init_image is not None:
        if isinstance(init_image, str):
            from PIL import Image
            img = Image.open(init_image).convert("RGB")
            init_image = torch.from_numpy(
                np.asarray(img, np.float32) / 255.0)[None]
        init_latents = codec.encode(init_image.to(device))
    if init_latents is not None and init_latents.shape[0] == 1 and batch_size > 1:
        init_latents = init_latents.expand(batch_size, -1, -1, -1)
    if init_latents is not None:
        init_latents = init_latents[:batch_size]
    if source is not None:
        source = source[:batch_size]

    cond = dict(cond) if cond else {}
    if cond.get("class_cond") is None and n_classes > 0:
        # class grid: 10 columns each a single class
        cols = torch.randint(0, n_classes, (10,), generator=generator,
                             device=device)
        cond["class_cond"] = cols.repeat(-(-batch_size // 10))[:batch_size]
        if _split(batch_size, mesh):
            broadcast0_(cond["class_cond"], mesh)
    elif cond.get("class_cond") is not None:
        cond["class_cond"] = cond["class_cond"][:batch_size]
    if cond.get("mask_cond") is not None:
        cond["mask_cond"] = cond["mask_cond"][:batch_size]
    if not cond or all(v is None for v in cond.values()):
        cond = None

    if _split(batch_size, mesh):
        batch_size //= batch_shard_count(mesh)
        cond = shard_batch(mesh, cond) if cond is not None else None
        source, init_latents = shard_batch(mesh, [source, init_latents])
    shape = (batch_size,) + tuple(latent_shape)
    return generate_latents(
        model_apply, shape, generator, method=method, n_steps=n_steps,
        cond=cond, cfg_strength=cfg_strength, source=source,
        init_latents=init_latents, init_strength=init_strength,
        t_scale=t_scale)


def _split(batch_size: int, mesh) -> bool:
    """Whether a batch of ``batch_size`` is served sharded over ``mesh``."""
    n = batch_shard_count(mesh)
    return n > 1 and batch_size % n == 0


def _decode_rows(codec, latents, mesh, split: bool, **kw):
    """Decode this rank's rows (all of them unless ``split``), then gather
    the images of every rank."""
    out = decode_latents(codec, shard_batch(mesh, latents) if split else latents, **kw)
    return gather_rows(out, mesh) if split else out


@torch.inference_mode()
def sampler(model_apply: Callable, codec, generator: torch.Generator,
            method: str = "rk4", batch_size: int = 256, n_steps: int = 100,
            cond: Optional[dict] = None, n_classes: int = 0,
            latent_shape=(16, 16, 4), cfg_strength: float = 3.0,
            is_midi: bool = False, keep_gray: bool = False, source=None,
            init_image=None, init_latents=None, init_strength: float = 0.0,
            t_scale: float = 999.0, mesh=None):
    """Generate latents with ``model_apply(x, t, cond)`` and decode them.
    Everything runs on ``generator.device``. ``latent_shape`` is (H, W, C)
    NHWC. With ``n_classes > 0`` and no class condition, samples get the
    10-column class grid. ``mesh``: sharded serving (module docstring).
    Returns ``(pred_latents, decoded_pred, nfe)``."""
    pred_latents, nfe = _sample_latents(
        model_apply, codec, generator, method, batch_size, n_steps, cond,
        n_classes, latent_shape, cfg_strength, source, init_image, init_latents,
        init_strength, t_scale, mesh)
    decoded = decode_latents(codec, pred_latents, is_midi=is_midi,
                             keep_gray=keep_gray)
    if _split(batch_size, mesh):
        pred_latents, decoded = gather_rows(pred_latents, mesh), gather_rows(decoded, mesh)
    return pred_latents, decoded, nfe


@torch.inference_mode()
def evaluate_model(model_apply: Callable, codec, epoch: int, target_latents,
                   generator: torch.Generator, cond: Optional[dict] = None,
                   batch_size: int = 256, n_classes: int = 0, method: str = "rk4",
                   n_steps: int = 100, cfg_strength: float = 3.0,
                   is_midi: bool = False, keep_gray: bool = False, tag: str = "",
                   cb_tracker=None, codec_quantize: Optional[Callable] = None,
                   use_wandb: bool = True, output_dir: str = "./", source=None,
                   mask_pixels=None,
                   feature_fn=None, t_scale: float = 999.0,
                   mark: Optional[Callable] = None, mesh=None) -> dict:
    """Sample ``min(batch_size, len(target_latents))`` latents, decode them
    and the targets (in chunks of 128), compute ``compute_sample_metrics``,
    track the target and generated codes with ``codec_quantize`` into
    ``cb_tracker``, and save the grids ``{tag}{name}_{method}_{nfe}``
    (with ``source``, also the source latents and their decode; with a
    mask, ``mask_latents`` and ``mask_pixels``). Returns the metrics as
    floats plus ``FID_feature_backend``. ``mark`` is called with "sampler",
    "decode", "metrics" and "grids". ``mesh``: sharded sampling and
    decoding (module docstring); only rank 0 writes grids and logs."""
    from .ops.fid import default_feature_fn, feature_backend_name
    mark = mark or (lambda name: None)
    batch_size = min(batch_size, target_latents.shape[0])
    target_latents = target_latents[:batch_size]
    split = _split(batch_size, mesh)
    pred_latents, nfe = _sample_latents(
        model_apply, codec, generator, method, batch_size, n_steps, cond, n_classes,
        target_latents.shape[-3:], cfg_strength, source, None, None, 0.0, t_scale, mesh)
    mark("sampler")
    # a bf16 codec decodes to bf16 pixels; the metrics take them widened to
    # fp32 (exactly), where the JAX evaluation computes on the bf16 values
    decoded_pred = decode_latents(codec, pred_latents, is_midi=is_midi,
                                  keep_gray=keep_gray).float()
    if split:
        pred_latents = gather_rows(pred_latents, mesh)
        decoded_pred = gather_rows(decoded_pred, mesh)
    decoded_target = _decode_rows(codec, target_latents, mesh, split, is_midi=is_midi,
                                  keep_gray=keep_gray).float()
    mark("decode")
    writer = is_writer()
    use_wandb = use_wandb and writer
    if feature_fn is None:
        feature_fn = default_feature_fn(image_size=decoded_target.shape[1])
    metrics = compute_sample_metrics(pred_latents, target_latents, decoded_pred,
                                     decoded_target, feature_fn=feature_fn)
    out = {k: float(v) for k, v in metrics.items()}
    mark("metrics")

    if cb_tracker is not None and codec_quantize is not None:
        for name, lat in (("val", target_latents), ("gen", pred_latents)):
            idx = codec_quantize(lat)[1]
            cb_tracker.update_counts(name, idx.reshape(-1, idx.shape[-1]).cpu().numpy())
        if writer:
            analyze_codebooks(cb_tracker, None, epoch, use_wandb=use_wandb,
                              output_dir=output_dir)
    images = {"pred_latents": pred_latents, "target_latents": target_latents,
              "decoded_pred": decoded_pred, "decoded_target": decoded_target}
    if source is not None:
        images["source_latents"] = source[:batch_size]
        images["decoded_source"] = _decode_rows(codec, source[:batch_size], mesh, split,
                                                is_midi=is_midi, keep_gray=keep_gray)
    if cond and cond.get("mask_cond") is not None:
        images["mask_latents"] = cond["mask_cond"][:batch_size]
    if mask_pixels is not None:
        images["mask_pixels"] = mask_pixels[:batch_size].float()
    for key, val in images.items() if writer else ():
        save_img_grid(val.float().cpu().numpy(), epoch, nfe,
                      tag=f"{tag}{key}_{method}_{nfe}", use_wandb=use_wandb,
                      output_dir=output_dir)
    mark("grids")
    out["FID_feature_backend"] = feature_backend_name(feature_fn)
    if use_wandb and metrics:
        wblog.log({f"metrics/{tag}{k}": v for k, v in out.items()} | {"epoch": epoch})
    return out


@torch.inference_mode()
def evaluate_model_audio(model_apply: Callable, codec, epoch: int, target_latents,
                         generator: torch.Generator, cond: Optional[dict] = None,
                         batch_size: int = 64, n_classes: int = 0, method: str = "rk4",
                         n_steps: int = 50, cfg_strength: float = 3.0, tag: str = "",
                         use_wandb: bool = True, output_dir: str = "./",
                         t_scale: float = 999.0,
                         n_demo_wavs: int = 4, mark: Optional[Callable] = None,
                         mesh=None, **_) -> dict:
    """The audio twin of ``evaluate_model`` for DAC-codec flows: sample
    ``min(batch_size, len(target_latents))`` folded latents, decode them and
    the targets to waveforms, and compute ``sinkhorn`` (latents),
    ``sinkhorn_mel`` (between the per-clip mean log-mel vectors, n_fft 512,
    40 mels), ``mse``, the latents' means and standard deviations and
    ``nfe``; write ``{tag}ep{epoch:04d}_{i}_gen.wav`` (``n_demo_wavs``) and
    ``_target.wav`` (2). The image evaluation's other keyword arguments are
    accepted and ignored. ``mark`` is called with "sampler", "decode",
    "metrics" and "wavs". Under a ``mesh`` every rank samples the whole
    batch and rank 0 alone writes the WAVs and logs."""
    mark = mark or (lambda name: None)
    batch_size = min(batch_size, target_latents.shape[0])
    tl = target_latents[:batch_size]
    pl, nfe = _sample_latents(
        model_apply, codec, generator, method, batch_size, n_steps, cond, n_classes,
        tl.shape[-3:], cfg_strength, None, None, None, 0.0, t_scale)
    mark("sampler")
    decoded_pred = decode_latents(codec, pl)
    decoded_target = decode_latents(codec, tl)
    mark("decode")
    sr = getattr(codec, "sample_rate", 16000)
    fb = torch.as_tensor(mel_filterbank(sr, 512, 40), device=pl.device)

    def mel_stats(w):           # (B, T, 1) → per-clip mean log-mel (B, 40)
        return torch.log(stft(w[..., 0], 512) @ fb + 1e-5).mean(dim=1)

    metrics = {"sinkhorn": sinkhorn_loss(tl, pl),
               "sinkhorn_mel": sinkhorn_loss(mel_stats(decoded_target),
                                             mel_stats(decoded_pred)),
               "mse": ((pl - tl) ** 2).mean(),
               "pred_mean": pl.mean(), "targ_mean": tl.mean(),
               "pred_std": pl.std(unbiased=False), "targ_std": tl.std(unbiased=False),
               "nfe": float(nfe)}
    out = {k: float(v) for k, v in metrics.items()}
    mark("metrics")
    if not is_writer():
        mark("wavs")
        return out
    os.makedirs(output_dir, exist_ok=True)
    pred_np, target_np = decoded_pred.cpu().numpy(), decoded_target.cpu().numpy()
    for i in range(min(n_demo_wavs, batch_size)):
        save_wav(os.path.join(output_dir, f"{tag}ep{epoch:04d}_{i}_gen.wav"), pred_np[i], sr)
    for i in range(min(2, batch_size)):
        save_wav(os.path.join(output_dir, f"{tag}ep{epoch:04d}_{i}_target.wav"),
                 target_np[i], sr)
    mark("wavs")
    if use_wandb:
        wblog.log({f"metrics/{tag}{k}": v for k, v in out.items()} | {"epoch": epoch})
    return out


def make_e2e_sampler(model_apply: Callable, codec, latent_shape,
                     batch_size: int, method: str = "rk4", n_steps: int = 50,
                     cfg_strength: float = 3.0, n_classes: int = 0,
                     t_scale: float = 999.0, warp_s: float = 0.5):
    """The end-to-end serving function
    ``f(generator, class_cond) -> (latents, images)``: the whole ODE
    integration, then the codec decode."""

    @torch.inference_mode()
    def f(generator: torch.Generator, class_cond=None):
        cond = ({"class_cond": class_cond, "mask_cond": None}
                if n_classes > 0 else None)
        latents, _ = generate_latents(
            model_apply, (batch_size,) + tuple(latent_shape), generator,
            method=method, n_steps=n_steps, cond=cond,
            cfg_strength=cfg_strength, t_scale=t_scale, warp_s=warp_s)
        return latents, codec.decode(latents)

    return f
