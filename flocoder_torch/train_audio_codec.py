"""Train the DAC audio codec on the CUDA card — the port of the repo's
``train_audio_codec.py`` (the ``fc-train-audio`` script).

Usage:
    python -m flocoder_torch.train_audio_codec --config-name audio_dac.yaml \\
        [data=/path/to/wavs] [codec.epochs=N] [key=value ...]

Data: ``.wav`` files under ``data`` (``data/train`` and ``data/val`` when
they exist, else one folder for both; class label = first-level
subdirectory), or, when ``data`` is not a folder, the synthetic chords
(``synthetic_n`` clips, 256 by default; seeds ``seed`` and ``seed +
10000``). Random crops of ``codec.crop_len`` samples at
``codec.sample_rate`` (``data/audio_io.py``).

Reconstruction epochs, then, with ``codec.gan`` (default on), the GAN
phase from epoch ``codec.gan_warmup_epochs + 1`` with the multi-period and
multi-scale waveform discriminators (``models/audio_disc.py``,
``training/audio.py``). Validation on epoch 1 and every ``eval_every``
(5): the losses on one batch and two original/reconstruction WAV pairs;
codebook usage every 10th epoch; checkpoints every ``codec.ckpt_every``
(50) epochs and at the end, ``dac_<epoch>.npz`` with the newest 5 kept,
holding what the JAX script's hold, the codec's parameters and RVQ state
(no discriminator or Adam state), so that both packages load them.
``load_checkpoint=<dac_*.npz>`` resumes the codec, strictly (the JAX
script loads with ``strict=False``).

``codec.bf16=true`` trains the codec computing in bf16 over fp32
parameters (``setup_codec``; the discriminators, the losses and Adam stay
fp32, as in the JAX script); its ``dac_`` checkpoints hold the fp32
parameters.

``+device=cpu`` runs on the CPU; without it the run needs a CUDA device.
``+ckpt_dir`` and ``+output_dir`` move the checkpoints (default
``checkpoints``) and the WAVs (``output_dac_<data name>``). Unless
``no_wandb`` is set, the metrics go to ``runs/<codec.project_name>/<run_name
or the start time>/metrics.jsonl`` (``utils/logging.py``) at the JAX
script's points, and every 10th epoch the codebook figures to the WAVs'
folder (``utils/codebook_analysis.py``). Tensor parallelism (``tp``) is the
model axis, not ported yet (ROADMAP.md item 13b-ii), and raises.

Data parallelism, as in ``train_vqgan``: on several ranks (``torchrun``;
``parallel/mesh.py``) each rank loads its slice of every epoch's shuffle
(``codec.batch_size`` is the global batch) and steps on it with its own
random stream, the steps averaging gradients and losses over the ranks and
summing the RVQ statistics (``training/audio.py``); the tracker counts the
indices of every rank, and rank 0 alone validates, prints, logs and writes.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import ldcfg, parse_cli
from .data.audio_io import AudioFolderDataset, SyntheticAudioDataset, save_wav
from .data.datasets import Loader
from .generate_samples import CONFIG_DIR
from .models.audio_disc import DACDiscriminator
from .models.codecs import setup_codec
from .models.layers import init_params
from .training.audio import (create_audio_state, make_audio_eval_step,
                             make_audio_gan_step, make_audio_train_step)
from .parallel.mesh import (batch_rank, batch_shard_count, gather_rows, is_writer,
                            make_mesh, maybe_init_distributed, rank0_print, rank_seed)
from .training.checkpoint import (DAC_PREFIXES, load_checkpoint, load_jax_flat,
                                  save_checkpoint, to_jax_flat)
from .utils import logging as wblog
from .utils.codebook_analysis import CodebookUsageTracker, analyze_codebooks

__all__ = ["audio_datasets", "train_audio_codec", "main"]


def audio_datasets(config) -> tuple:
    """``(train, val)`` as the JAX script builds them: a WAV folder (its
    ``train``/``val`` subfolders when present) or the synthetic chords."""
    cc = config.codec
    crop_len = int(cc.get("crop_len", 8192))
    sample_rate = int(cc.get("sample_rate", 16000))
    seed = int(ldcfg(config, "seed", 0))
    data_path = os.path.expanduser(str(config.data))

    def make(split, seed_off):
        if os.path.isdir(data_path):
            sub = os.path.join(data_path, split)
            return AudioFolderDataset(sub if os.path.isdir(sub) else data_path,
                                      crop_len=crop_len, sample_rate=sample_rate)
        return SyntheticAudioDataset(
            n=int(ldcfg(config, "synthetic_n", 256)), crop_len=crop_len,
            sample_rate=sample_rate, n_classes=int(ldcfg(config, "n_classes", 4)),
            seed=seed_off)

    return make("train", seed), make("val", seed + 10_000)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_audio_codec(config, step_hook: Optional[Callable[[int], None]] = None) -> dict:
    """Returns ``{'state': VQGANState, 'step_seconds': {'recon': [...],
    'gan': [...]}, 'epoch_seconds': [...], 'epochs': [per-epoch mean
    losses], 'val': [...], 'wavs': [paths], 'checkpoint': path,
    'metrics_log': path or None, 'device': str}``. Step times are
    host-clock seconds of each step, ending in a device synchronise;
    ``epoch_seconds`` holds each epoch's phase, clips and the seconds of its
    training loop (the loader's wait, the copy and the codebook tracker
    included; validation not). ``step_hook``, if given, is called with the
    epoch after each step, e.g. to record a CUDA event."""
    cc = config.codec
    if str(cc.get("choice", "dac")) != "dac":
        raise SystemExit("train_audio_codec trains codec.choice=dac")
    if int(ldcfg(config, "tp", 1)) > 1:
        raise NotImplementedError("tensor-parallel codec training is the model "
                                  "axis's tensor parallelism, not ported yet "
                                  "(ROADMAP.md item 13b-ii)")
    device = maybe_init_distributed(config.get("device", None))
    mesh = make_mesh(device=device)
    n_shards, writer = batch_shard_count(mesh), is_writer()
    crop_len = int(cc.get("crop_len", 8192))
    sample_rate = int(cc.get("sample_rate", 16000))
    batch_size = int(cc.get("batch_size", 32))
    if batch_size % n_shards:
        raise ValueError(f"codec.batch_size={batch_size} does not split over "
                         f"{n_shards} ranks")
    epochs = int(cc.get("epochs", 200))
    lr = float(cc.get("learning_rate", 1e-4))
    seed = int(ldcfg(config, "seed", 0))
    data_path = os.path.expanduser(str(config.data))

    train_ds, val_ds = audio_datasets(config)
    train_loader = Loader(train_ds, batch_size // n_shards,
                          int(ldcfg(config, "num_workers", 4)), seed,
                          host_shard=(batch_rank(mesh), n_shards) if n_shards > 1 else None)
    val_loader = Loader(val_ds, batch_size, 1, seed + 1)
    rank0_print(f"audio data: {len(train_ds)} train / {len(val_ds)} val clips, "
                f"crop {crop_len} @ {sample_rate} Hz")

    codec = setup_codec(config, device=device)
    gen = torch.Generator(device)
    codec.init(gen.manual_seed(seed))
    n_params = sum(p.numel() for p in [*codec.encoder.parameters(),
                                       *codec.decoder.parameters()])
    rank0_print(f"codec params: {n_params / 1e6:.2f}M  latent {codec.latent_shape(crop_len)} "
                f"(folded), hop {codec.hop}  device {device}")
    resume = ldcfg(config, "load_checkpoint", None)
    if resume and os.path.exists(str(resume)):
        ck = load_checkpoint(str(resume))
        load_jax_flat(codec, ck["model_state_dict"], DAC_PREFIXES)
        print(f"resumed codec from {resume} (epoch {ck['epoch']})")

    use_gan = bool(cc.get("gan", True))
    gan_warmup_epochs = int(cc.get("gan_warmup_epochs", 50))
    disc = None
    if use_gan:
        disc = DACDiscriminator(periods=tuple(cc.get("disc_periods", [2, 3, 5, 7, 11])),
                                scales=int(cc.get("disc_scales", 3)),
                                base_channels=int(cc.get("disc_base_channels", 16)))
        init_params(disc.to(device), gen.manual_seed(seed + 2))
        n_d = sum(p.numel() for p in disc.parameters())
        rank0_print(f"waveform discriminators: {len(disc.periods)} periods + {disc.scales} "
                    f"scales, {n_d / 1e6:.2f}M params, GAN phase from epoch "
                    f"{gan_warmup_epochs + 1}")
    state = create_audio_state(codec, disc, lr, d_lr_scale=float(cc.get("d_lr_scale", 1.0)))
    train_step = make_audio_train_step(config, mesh=mesh)
    gan_step = make_audio_gan_step(config, mesh=mesh) if use_gan else None
    eval_step = make_audio_eval_step(config)

    use_wandb = writer and not bool(ldcfg(config, "no_wandb", False))
    log_path = None
    if use_wandb:
        log_path = wblog.init(project=str(cc.get("project_name", "flocoder-audio")),
                              name=ldcfg(config, "run_name", None), config=dict(config))

    levels = int(cc.get("codebook_levels", 4))
    tracker = CodebookUsageTracker(num_levels=levels,
                                   codebook_size=int(cc.get("vq_num_embeddings", 512)))
    output_dir = str(config.get("output_dir", f"output_dac_{os.path.basename(data_path)}"))
    ckpt_dir = str(config.get("ckpt_dir", "checkpoints"))
    if writer:
        os.makedirs(output_dir, exist_ok=True)

    step_seconds = {"recon": [], "gan": []}
    epoch_seconds, history, val_history, wavs, path = [], [], [], [], None
    gen.manual_seed(rank_seed(seed + 1, mesh))
    t_start = time.time()
    for epoch in range(1, epochs + 1):
        phase = "gan" if use_gan and epoch > gan_warmup_epochs else "recon"
        ep_aux, t_ep = [], time.time()
        for batch in train_loader:
            x = torch.from_numpy(batch["target"]).to(device)
            t0 = time.time()
            state, aux, idx = (gan_step if phase == "gan" else train_step)(state, x, gen)
            if step_hook is not None:
                step_hook(epoch)
            _sync(device)
            step_seconds[phase].append(time.time() - t0)
            ep_aux.append(aux)
            idx = gather_rows(idx, mesh)
            tracker.update_counts("train", idx.reshape(-1, levels).cpu().numpy())
        n_clips = len(ep_aux) * batch_size
        epoch_seconds.append({"epoch": epoch, "phase": phase, "clips": n_clips,
                              "seconds": time.time() - t_ep})
        means = {k: float(np.mean([float(a[k]) for a in ep_aux])) for k in ep_aux[0]}
        history.append({"epoch": epoch, "phase": phase, **means})
        sps = n_clips / max(epoch_seconds[-1]["seconds"], 1e-9)
        if not writer:
            continue
        print(f"epoch {epoch}/{epochs} [{phase}] " +
              "  ".join(f"{k} {v:.4f}" for k, v in means.items()) +
              f"  {sps:.1f} clips/s")
        if use_wandb:
            wblog.log({f"train/{k}": v for k, v in means.items()}
                      | {"epoch": epoch, "clips_per_sec": sps})

        if epoch % int(ldcfg(config, "eval_every", 5)) == 0 or epoch == 1:
            x = torch.from_numpy(next(iter(val_loader))["target"]).to(device)
            recon, vlosses, idx = eval_step(codec, x)
            tracker.update_counts("val", idx.reshape(-1, levels).cpu().numpy())
            vmeans = {k: float(v) for k, v in vlosses.items()}
            print("  val: " + "  ".join(f"{k} {v:.4f}" for k, v in vmeans.items()))
            if use_wandb:
                wblog.log({f"val/{k}": v for k, v in vmeans.items()} | {"epoch": epoch})
            val_history.append({"epoch": epoch, **vmeans})
            x_np, recon_np = x.cpu().numpy(), recon.cpu().numpy()
            for i in range(min(2, x.shape[0])):         # audible progress
                for tag, wave in (("orig", x_np[i]), ("recon", recon_np[i])):
                    wavs.append(os.path.join(output_dir, f"ep{epoch:04d}_{i}_{tag}.wav"))
                    save_wav(wavs[-1], wave, sample_rate)

        if epoch % 10 == 0:
            analyze_codebooks(tracker, codec.vq, epoch, use_wandb=use_wandb,
                              output_dir=output_dir)
            tracker.reset_all()

        if epoch % int(cc.get("ckpt_every", 50)) == 0 or epoch == epochs:
            path = save_checkpoint(to_jax_flat(codec, DAC_PREFIXES), epoch,
                                   ckpt_dir=ckpt_dir, prefix="dac_", config=config, keep=5)
            print(f"  checkpoint -> {path}")
    rank0_print(f"done in {time.time() - t_start:.0f}s")
    if use_wandb:
        wblog.finish()
    return {"state": state, "step_seconds": step_seconds, "epoch_seconds": epoch_seconds,
            "epochs": history, "val": val_history, "wavs": wavs, "checkpoint": path,
            "metrics_log": log_path, "device": str(device)}


def main(argv=None, step_hook: Optional[Callable[[int], None]] = None) -> dict:
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    return train_audio_codec(config, step_hook)


if __name__ == "__main__":
    main()
