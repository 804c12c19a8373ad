"""Generate samples from a trained flow checkpoint on the CUDA card — the
port of the repo's ``generate_samples.py``.

Usage:
    python -m flocoder_torch.generate_samples --config-name flowers_vqgan.yaml \\
        +flow_checkpoint=checkpoints/flowema_100.npz +n_samples=64

Loads the flow and codec checkpoints (npz contract, see
``training/checkpoint.py``), builds the velocity field from the flow
checkpoint's embedded config (the U-Net, or HDiT for ``flow.arch=hdit``;
``models/flow_model.py``), integrates with RK4/Euler/Heun/midpoint and CFG,
decodes through the codec (the VQGAN, the VQGAN+ of
``codec.choice=vqgan_plus``, or the SD VAE of ``flowers_sd``), and writes
PNG grids and individual PNGs. A reflowed checkpoint serves at a few steps
(``+method=euler +n_steps=5``: 4 NFE). For a MIDI data path (``midi`` or
``pop909`` in ``data``) every sample PNG is also laid out as a piano roll
(``square_to_rect_file``) and exported to a ``.mid`` file
(``img_file_2_midi_file``); ``midi_to_audio`` renders one to WAV through
``timidity`` and raises where that program is missing. A checkpoint of an
inpainting run (its U-Net has mask conditioning, its params a
``mask_encoder``) serves unconditionally: the U-Net gets no mask, which it
reads as the all-ones mask.

Serving dtype: a checkpoint trained with ``flow.bf16=true`` serves in bf16,
the velocity field and the codec alike (the codec built at that dtype, so
the decode runs in bf16 too); ``+bf16=true`` or ``+bf16=false`` overrides
the checkpoint's flag in either direction. Parameters stay fp32.
``+quant=int8`` (also ``true`` or ``1``), or the checkpoint config's
``codec.quant_decode: int8``, builds the decoder with W8A8 int8
convolutions (``ops/quant.py``); ``+quant=false`` turns the latter off.
``+device=cpu`` runs on the CPU; without it the run needs a CUDA device.

Audio (a flow trained on DAC latents, ``audio_dac.yaml``): the latent
shape comes from ``codec.crop_len`` (``DACCodec.latent_shape``), the codec
is ``codec.checkpoint`` or, by default, the newest ``dac_*.npz`` under the
checkpoint config's ``+ckpt_dir`` (``checkpoints``), and each sample is
written as a 16-bit WAV (``sample_<batch>_<i>.wav``) instead of PNGs; a
``flow.bf16`` checkpoint serves with the DAC codec in bf16 too, and the
waveforms are widened to fp32 before they are written.

``+use_gradio=true`` serves the sampler's web UI instead
(``ui/webapp.py``, on the Python standard library; the gradio app of the
JAX script is not ported, so this UI is served whether or not gradio is
installed).

Sharded serving: launched on several ranks (``torchrun
--nproc_per_node=N -m flocoder_torch.generate_samples ...``;
``parallel/mesh.py`` and ``+device`` as in
``train_flow``), each rank integrates and decodes its rows of every batch
that splits over the ranks, from its own noise (``rank_seed``), and rank 0
gathers the samples and writes them (``evaluation.sampler``); a batch that
does not split runs whole on every rank and rank 0 writes its own.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .config import ldcfg, parse_cli
from .data.audio_io import save_wav
from .evaluation import sampler
from .models.audio_codec import DACCodec
from .models.codecs import (VQVAE, codec_checkpoint, latest_checkpoint, load_codec_weights,
                            setup_codec)
from .models.flow_model import build_flow_model
from .parallel.mesh import (batch_shard_count, is_writer, make_mesh, maybe_init_distributed,
                            rank0_print, rank_seed)
from .models.sd_vae import SDVAE
from .models.vqgan_plus import VQGANPlus
from .training.checkpoint import UNET_PREFIXES, load_checkpoint, load_jax_flat, subtree
from .utils.viz import save_img, save_img_grid

__all__ = ["load_models_once", "generate_samples", "save_sample_batch",
           "save_wav_batch", "midi_to_audio", "create_gradio_interface", "main",
           "CONFIG_DIR"]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")

_MODEL_CACHE: dict = {}


def load_models_once(config, flow_ckpt_path: str, device) -> dict:
    """Build and load the flow model and codec on ``device``, cached per
    (checkpoint path, device, ``+bf16``, ``+quant``) as the JAX script's
    cache is: None defers to the checkpoint's own flag, and the bundle is
    also filed under the flags it resolved to."""
    bf16_cli = config.get("bf16", None)
    quant_cli = config.get("quant", None)
    quant_req = (None if quant_cli is None
                 else str(quant_cli).lower() in ("int8", "true", "1"))
    key = (flow_ckpt_path, str(device), None if bf16_cli is None else bool(bf16_cli),
           quant_req)
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    ck = load_checkpoint(flow_ckpt_path)
    ck_config = ck["config"] or config
    ck_bf16 = bool(ldcfg(ck_config, "bf16", False))
    ck_quant = str(ldcfg(ck_config, "quant_decode", "")) == "int8"
    bf16 = bool(bf16_cli) if bf16_cli is not None else ck_bf16
    quant = quant_req if quant_req is not None else ck_quant
    dtype = torch.bfloat16 if bf16 else torch.float32
    codec = setup_codec(ck_config, device=device, dtype=dtype, quant_decode=quant)
    is_audio = isinstance(codec, DACCodec)
    H, W, C = codec.latent_shape(int(ldcfg(ck_config, "crop_len", 32768)) if is_audio
                                 else int(ldcfg(ck_config, "image_size", 128)))
    n_classes = int(ldcfg(ck_config, "n_classes", 0))
    meanflow = bool(ldcfg(ck_config, "meanflow", False))
    params = ck["model_state_dict"]
    inpainting = any(k.startswith("mask_encoder/") for k in params)
    model = build_flow_model(ck_config, C, n_classes, dual_time=meanflow, dtype=dtype,
                             dim=H, mask_cond=inpainting).to(device)
    load_jax_flat(model, subtree(params, "model/"), UNET_PREFIXES)
    model.eval()

    # seeded as pre-encoding seeds it
    if isinstance(codec, (VQVAE, VQGANPlus, SDVAE, DACCodec)):
        codec.init(torch.Generator(device).manual_seed(0))
    load_codec_weights(codec, codec_checkpoint(ck_config))
    codec.eval()

    bundle = dict(model=model, codec=codec, latent_shape=(H, W, C),
                  n_classes=n_classes, config=ck_config, bf16=bf16, quant=quant,
                  t_scale=1.0 if meanflow else 999.0)
    _MODEL_CACHE[key] = bundle
    _MODEL_CACHE[(flow_ckpt_path, str(device), bf16, quant)] = bundle
    if bf16 == ck_bf16 and quant == ck_quant:
        _MODEL_CACHE[(flow_ckpt_path, str(device), None, None)] = bundle
    return bundle


def save_sample_batch(decoded: np.ndarray, batch_idx: int, output_dir: str,
                      is_midi: bool = False, max_individual: int = 100) -> list:
    """A grid plus up to 100 individual PNGs; with ``is_midi`` each PNG is
    also laid out as a piano roll (``*_rect.png``) and exported to a
    ``.mid`` file beside it. Returns the ``.mid`` paths."""
    from .data.pianoroll import img_file_2_midi_file, square_to_rect_file
    os.makedirs(output_dir, exist_ok=True)
    save_img_grid(decoded, epoch=batch_idx, tag=f"samples_b{batch_idx}",
                  use_wandb=False, output_dir=output_dir)
    mids = []
    for i in range(min(decoded.shape[0], max_individual)):
        path = os.path.join(output_dir, f"sample_{batch_idx:03d}_{i:03d}.png")
        save_img(decoded[i], path)
        if is_midi:
            mids.append(img_file_2_midi_file(square_to_rect_file(path),
                                             path.replace(".png", ".mid")))
    return mids


def midi_to_audio(midi_path: str) -> str:
    """MIDI → WAV beside it through the ``timidity`` program; raises a
    RuntimeError where it is not installed."""
    import shutil
    import subprocess
    wav = midi_path.replace(".mid", ".wav")
    if shutil.which("timidity") is None:
        raise RuntimeError("timidity not installed")
    subprocess.run(["timidity", midi_path, "-Ow", "-o", wav], check=True,
                   capture_output=True)
    return wav


def save_wav_batch(decoded: np.ndarray, batch_idx: int, output_dir: str,
                   sample_rate: int) -> list:
    """Each waveform (T, 1) of a batch as a 16-bit WAV; returns the paths."""
    os.makedirs(output_dir, exist_ok=True)
    paths = [os.path.join(output_dir, f"sample_{batch_idx:03d}_{i:03d}.wav")
             for i in range(decoded.shape[0])]
    for path, wave in zip(paths, decoded):
        save_wav(path, wave, sample_rate)
    return paths


def generate_samples(config) -> dict:
    """Sample ``+n_samples`` images (waveforms, for an audio codec) in
    batches of ``batch_size`` and write them to ``+output_dir``. Returns
    ``{'images': (N, H, W, 3) array (audio: (N, T, 1)), 'batch_seconds':
    [...], 'nfe': int, 'midi_files': [.mid paths], 'wav_files': [.wav
    paths], 'device': str, 'bf16': bool, 'quant': bool}``, the last two the
    serving dtype and int8 decode in use."""
    device = maybe_init_distributed(config.get("device", None))
    mesh = make_mesh(device=device)
    writer = is_writer()
    flow_ckpt = str(config.get("flow_checkpoint", "") or
                    ldcfg(config, "flow_checkpoint", ""))
    if not flow_ckpt:
        flow_ckpt = (latest_checkpoint("checkpoints", "flowema_") or
                     latest_checkpoint("checkpoints", "flow_") or "")
    if not flow_ckpt or not os.path.exists(flow_ckpt):
        raise SystemExit(f"flow checkpoint not found: {flow_ckpt!r} "
                         "(pass +flow_checkpoint=...)")
    rank0_print(f"loading {flow_ckpt}")
    b = load_models_once(config, flow_ckpt, device)
    if batch_shard_count(mesh) > 1:
        rank0_print(f"serving over {batch_shard_count(mesh)} batch shards ({mesh})")

    n_samples = int(config.get("n_samples", 64))
    batch_size = min(int(ldcfg(config, "batch_size", 256)), n_samples)
    n_steps = int(config.get("n_steps", ldcfg(config, "n_steps", 100)))
    method = str(config.get("method", "rk4"))
    cfg_strength = float(config.get("cfg_strength",
                                    ldcfg(config, "cfg_strength", 3.0)))
    output_dir = str(config.get("output_dir", "samples"))
    is_midi = any(s in str(config.get("data", "")).lower()
                  for s in ("midi", "pop909"))
    keep_gray = int(ldcfg(config, "in_channels", 3)) == 1
    generator = torch.Generator(device).manual_seed(rank_seed(int(config.get("seed", 0)),
                                                                mesh))

    fixed_class = config.get("class_cond", None)
    init_image = config.get("init_image", None) or None
    init_strength = float(config.get("init_strength",
                                     0.5 if init_image else 0.0))
    init_latents = None
    if init_image is not None:
        from PIL import Image
        img = Image.open(str(init_image)).convert("RGB")
        arr = torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None]
        with torch.inference_mode():
            init_latents = b["codec"].encode(arr.to(device))

    images, seconds, mids, wavs, nfe = [], [], [], [], 0
    done, batch_idx = 0, 0
    while done < n_samples:
        bs = min(batch_size, n_samples - done)
        t0 = time.time()
        cond = None
        if fixed_class is not None and b["n_classes"] > 0:
            cond = {"class_cond": torch.full((bs,), int(fixed_class),
                                             dtype=torch.long, device=device)}
        _, decoded, nfe = sampler(
            b["model"], b["codec"], generator, method=method, batch_size=bs,
            n_steps=n_steps, cond=cond, n_classes=b["n_classes"],
            latent_shape=b["latent_shape"], cfg_strength=cfg_strength,
            is_midi=is_midi, keep_gray=keep_gray, init_latents=init_latents,
            init_strength=init_strength, t_scale=b["t_scale"], mesh=mesh)
        decoded = decoded.float().cpu().numpy()
        dt = time.time() - t0
        if writer and isinstance(b["codec"], DACCodec):   # waveforms: WAVs, not PNGs
            wavs += save_wav_batch(decoded, batch_idx, output_dir, b["codec"].sample_rate)
        elif writer:                                      # rank 0 writes the samples
            mids += save_sample_batch(decoded, batch_idx, output_dir, is_midi=is_midi)
        rank0_print(f"batch {batch_idx}: {bs} samples, nfe={nfe}, {dt:.2f}s "
                    f"({bs / dt:.1f} samples/s)")
        images.append(decoded)
        seconds.append(dt)
        done += bs
        batch_idx += 1
    rank0_print(f"wrote {done} samples to {output_dir}/")
    return {"images": np.concatenate(images), "batch_seconds": seconds,
            "nfe": nfe, "midi_files": mids, "wav_files": wavs, "device": str(device),
            "bf16": b["bf16"],
            "quant": b["quant"]}


def create_gradio_interface(config) -> None:
    """The sampler's UI: the stdlib web app of ``ui/webapp.py`` (the port
    has no gradio app), served until interrupted."""
    from .ui.webapp import launch_webapp
    print("gradio not installed — serving the first-party stdlib UI")
    return launch_webapp(config)


def main(argv=None):
    """Samples as ``generate_samples`` does and returns its dict; with
    ``+use_gradio=true`` serves the UI instead and returns None."""
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    if config.get("use_gradio"):
        return create_gradio_interface(config)
    return generate_samples(config)


if __name__ == "__main__":
    main()
