"""Train the VQGAN (or VQGAN+) codec on the CUDA card — the port of the repo's
``train_vqgan.py``.

Usage:
    python -m flocoder_torch.train_vqgan --config-name flowers_vqgan.yaml \\
        [data=/path/to/images] [codec.epochs=N] [key=value ...]

Two phases: reconstruction-only warmup for ``codec.warmup_epochs``, then
adversarial training with the discriminator step and the generator step on
one codec forward (``training/vqgan.py``). Validation with reconstruction
grids on epoch 1 and every 5th, codebook usage every 10th, checkpoints every
``codec.ckpt_every`` (50) epochs and at the end, written as the JAX trainer
writes them (``vqgan_<epoch>.npz``: the codec's flax tree), so both
packages load them. ``+device=cpu`` runs on the CPU; without it the run
needs a CUDA device. ``+ckpt_dir`` and ``+output_dir`` move the checkpoints
(default ``checkpoints``) and the grids (``output_vqgan_<data name>``).
``codec.grad_accum`` (or ``flow.grad_accum`` through ``ldcfg``) splits each
batch into that many microbatches. A data path whose name holds ``midi``
or ``pop909`` trains on piano rolls (a folder of ``.mid`` files is
converted to PNGs first, ``data/datasets.py:MIDIImageDataset``), and each
validation adds the note metrics (``calc_note_metrics``: onset and sustain
sensitivity, specificity, precision, F1) and their TP/TN/FP/FN grids.
``codec.bf16`` (``tpu_vqgan.yaml``) trains with the codec, the
discriminator and the VGG16 perceptual net computing in bf16 over fp32
parameters, as the JAX script does; the choice is the codec's own
(``flow.bf16`` does not reach it). The checkpoint holds the same tree as an
fp32 codec's, NATTEN's bf16 ``gamma`` written widened to fp32 (exactly;
both packages' loaders round it back). ``codec.choice=vqgan_plus`` trains
the VQGAN+ codec (``models/vqgan_plus.py``) the same way, its checkpoint
the JAX ``VQGANPlus``'s tree; ``discriminator`` picks ``patch`` (default)
or ``vqgan_plus`` (``VQGANPlusDiscriminator``), and ``lecam_weight`` (default
0) adds LeCAM's regularisation to the discriminator's loss, for either
codec. Unless ``no_wandb`` is set, the metrics go to
``runs/<codec.project_name>/<run_name or the start time>/metrics.jsonl``
(``utils/logging.py``) at the JAX script's points (``train/…`` each epoch,
``val/…``, ``demo/recon`` and, for MIDI, ``note_metrics/…`` at each
validation, ``codebook/…`` every 10th epoch), and the codebook figures to
the grids' folder (``utils/codebook_analysis.py``). Not ported yet
(ROADMAP.md): tensor parallelism (``tp``, the model axis, item 13b-ii) and the
wandb backend.

Data parallelism: launched on several ranks (``torchrun
--nproc_per_node=N -m flocoder_torch.train_vqgan ...``; ``parallel/mesh.py``;
``+device`` as in ``train_flow``), each rank loads its
slice of every epoch's shuffle (``codec.batch_size`` is the global batch and
must split over the ranks) and steps on it with its own random stream; the
steps average the gradients and losses over the ranks and sum the RVQ
statistics (``training/vqgan.py``). The indices the codebook tracker counts
are gathered from every rank; rank 0 alone validates, prints, logs and
writes the grids and checkpoints.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .config import ldcfg, parse_cli
from .data.datasets import create_image_loaders
from .data.pianoroll import calc_note_metrics
from .generate_samples import CONFIG_DIR
from .models.codecs import setup_codec
from .models.discriminator import (VQGANPlusDiscriminator,
                                   VQGANPlusPatchDiscriminator,
                                   init_discriminator)
from .models.perceptual import make_perceptual_fn
from .parallel.mesh import (batch_rank, batch_shard_count, gather_rows, is_writer,
                            make_mesh, maybe_init_distributed, rank0_print, rank_seed)
from .training.checkpoint import (VQVAE_PREFIXES, load_checkpoint,
                                  load_jax_flat, save_checkpoint, to_jax_flat)
from .training.vqgan import (create_vqgan_state, make_vqgan_eval_step,
                             make_vqgan_gan_step, make_vqgan_warmup_step)
from .utils.codebook_analysis import CodebookUsageTracker, analyze_codebooks
from .utils import logging as wblog
from .utils.viz import save_img_grid

__all__ = ["train_vqgan", "main"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_vqgan(config) -> dict:
    """Returns ``{'state': VQGANState, 'step_seconds': {'warmup': [...],
    'gan': [...]}, 'epoch_seconds': [...], 'epochs': [per-epoch mean
    losses], 'val': [...], 'checkpoint': path, 'metrics_log': path or None,
    'codebook_tracker': CodebookUsageTracker (the counts since the last
    analysis), 'device': str}``. Step times
    are host-clock seconds of each training step, ending in a device
    synchronise. ``epoch_seconds`` holds, per epoch, its phase, its samples
    and the host-clock seconds of its training loop: the steps plus the
    loader's wait, the copy to the device and the codebook tracker
    (validation excluded)."""
    cc = config.codec
    image_size = int(cc.get("image_size", ldcfg(config, "image_size", 128)))
    batch_size = int(cc.get("batch_size", 64))
    epochs = int(cc.get("epochs", 2000))
    warmup_epochs = int(cc.get("warmup_epochs", 5))
    lr = float(cc.get("learning_rate", 1e-4))
    in_channels = int(cc.get("in_channels", 3))
    seed = int(ldcfg(config, "seed", 0))
    data_path = os.path.expanduser(str(config.data))
    is_midi = any(s in data_path.lower() for s in ("pop909", "midi"))
    if int(ldcfg(config, "tp", 1)) > 1:
        raise NotImplementedError("tensor-parallel codec training is the model "
                                  "axis's tensor parallelism, not ported yet "
                                  "(ROADMAP.md item 13b-ii)")
    device = maybe_init_distributed(config.get("device", None))
    mesh = make_mesh(device=device)
    n_shards, writer = batch_shard_count(mesh), is_writer()

    train_loader, val_loader = create_image_loaders(
        batch_size, image_size, data_path,
        num_workers=int(ldcfg(config, "num_workers", 4)), is_midi=is_midi,
        seed=seed)
    if n_shards > 1:
        if train_loader.batch_size % n_shards:
            raise ValueError(f"codec batch {train_loader.batch_size} does not split "
                             f"over {n_shards} ranks")
        train_loader.batch_size //= n_shards
        train_loader.host_shard = (batch_rank(mesh), n_shards)

    # quant_* flags are inference-only: a recipe that serves int8 trains fp32
    cc.pop("quant_decode", None)
    cc.pop("quant_encode", None)
    codec = setup_codec(config, device=device)
    gen = torch.Generator(device)
    codec.init(gen.manual_seed(seed))
    n_params = sum(p.numel() for p in [*codec.encoder.parameters(),
                                       *codec.decoder.parameters()])
    rank0_print(f"codec params: {n_params / 1e6:.2f}M  latent "
                f"{codec.latent_shape(image_size)}  device {device}  compute {codec.dtype}"
                + (f"  {n_shards} data-parallel ranks" if n_shards > 1 else ""))
    resume = ldcfg(config, "load_checkpoint", None)
    if resume and os.path.exists(str(resume)):
        ck = load_checkpoint(str(resume))
        load_jax_flat(codec, ck["model_state_dict"], VQVAE_PREFIXES)
        print(f"resumed codec from {resume} (epoch {ck['epoch']})")

    # 'patch' (the default the reference trains with) or 'vqgan_plus'; the
    # discriminator and the perceptual net compute in the codec's dtype
    net_dtype = codec.dtype
    if str(ldcfg(config, "discriminator", "patch")) == "vqgan_plus":
        disc = VQGANPlusDiscriminator(in_channels=in_channels, dtype=net_dtype)
    else:
        disc = VQGANPlusPatchDiscriminator(in_channels=in_channels, dtype=net_dtype)
    init_discriminator(disc.to(device), gen.manual_seed(seed + 2))

    perceptual_fn = None
    if float(cc.get("lambda_perc", 0)) > 0 and in_channels == 3:
        perceptual_fn = make_perceptual_fn(seed=seed, device=device, dtype=net_dtype)
    state = create_vqgan_state(codec, disc, lr)
    grad_accum = max(int(ldcfg(config, "grad_accum", 1)), 1)
    warmup_step = make_vqgan_warmup_step(config, perceptual_fn, mesh=mesh,
                                         grad_accum=grad_accum)
    gan_step = make_vqgan_gan_step(config, perceptual_fn,
                                   lecam_weight=float(ldcfg(config, "lecam_weight", 0.0)),
                                   mesh=mesh, grad_accum=grad_accum)
    eval_step = make_vqgan_eval_step(config, perceptual_fn)

    use_wandb = writer and not bool(ldcfg(config, "no_wandb", False))
    log_path = None
    if use_wandb:
        log_path = wblog.init(project=str(cc.get("project_name", "flocoder-vqgan")),
                              name=ldcfg(config, "run_name", None), config=dict(config))

    levels = int(cc.get("codebook_levels", 4))
    tracker = CodebookUsageTracker(num_levels=levels,
                                   codebook_size=int(cc.get("vq_num_embeddings", 96)))
    output_dir = str(config.get("output_dir",
                                f"output_vqgan_{os.path.basename(data_path)}"))
    ckpt_dir = str(config.get("ckpt_dir", "checkpoints"))
    if writer:
        os.makedirs(output_dir, exist_ok=True)

    step_seconds = {"warmup": [], "gan": []}
    epoch_seconds, history, val_history, path = [], [], [], None
    gen.manual_seed(rank_seed(seed + 1, mesh))
    for epoch in range(1, epochs + 1):
        phase = "gan" if epoch > warmup_epochs else "warmup"
        step_fn = gan_step if phase == "gan" else warmup_step
        ep_aux, t_ep = [], time.time()
        for batch in train_loader:
            x = torch.from_numpy(batch["target"]).to(device)
            t0 = time.time()
            state, aux, idx = step_fn(state, x, gen)
            _sync(device)
            step_seconds[phase].append(time.time() - t0)
            ep_aux.append(aux)
            idx = gather_rows(idx, mesh)
            tracker.update_counts("train", idx.reshape(-1, levels).cpu().numpy())
        n_samples = len(ep_aux) * train_loader.batch_size * n_shards
        epoch_seconds.append({"epoch": epoch, "phase": phase, "samples": n_samples,
                              "seconds": time.time() - t_ep})
        means = {k: float(np.mean([float(a[k]) for a in ep_aux])) for k in ep_aux[0]}
        history.append({"epoch": epoch, "phase": phase, **means})
        sps = n_samples / max(epoch_seconds[-1]["seconds"], 1e-9)
        if not writer:
            continue
        print(f"epoch {epoch}/{epochs} [{phase}] " +
              "  ".join(f"{k} {v:.4f}" for k, v in means.items()) +
              f"  {sps:.1f} samples/s")
        if use_wandb:
            wblog.log({f"train/{k}": v for k, v in means.items()}
                      | {"epoch": epoch, "samples_per_sec": sps})

        if epoch % 5 == 0 or epoch == 1:
            x = torch.from_numpy(next(iter(val_loader))["target"]).to(device)
            recon, vlosses, idx = eval_step(codec, x)
            tracker.update_counts("val", idx.reshape(-1, levels).cpu().numpy())
            vmeans = {k: float(v) for k, v in vlosses.items()}
            print("  val: " + "  ".join(f"{k} {v:.4f}" for k, v in vmeans.items()))
            if use_wandb:
                wblog.log({f"val/{k}": v for k, v in vmeans.items()} | {"epoch": epoch})
            n_demo = min(10, x.shape[0])
            save_img_grid(torch.cat([x[:n_demo], recon[:n_demo]]).float().cpu().numpy(),
                          epoch, tag="recon", use_wandb=use_wandb, output_dir=output_dir,
                          ncols=n_demo)
            if is_midi:
                nm, nm_images = calc_note_metrics(
                    recon.float().cpu().numpy(), x.float().cpu().numpy(),
                    keep_gray=in_channels == 1, return_images=True)
                vmeans.update({f"note_{k}": v for k, v in nm.items()})
                print("  notes: " + "  ".join(f"{k} {v:.4f}" for k, v in nm.items()))
                if use_wandb:
                    wblog.log({f"note_metrics/{k}": v for k, v in nm.items()}
                              | {"epoch": epoch})
                for k, img in nm_images.items():      # TP/TN/FP/FN grids
                    save_img_grid(img[:n_demo], epoch, tag=f"metric_{k}",
                                  use_wandb=use_wandb, output_dir=output_dir, ncols=n_demo)
            val_history.append({"epoch": epoch, **vmeans})

        if epoch % 10 == 0:
            analyze_codebooks(tracker, codec.vq, epoch, use_wandb=use_wandb,
                              output_dir=output_dir)
            tracker.reset_all()

        if epoch % int(cc.get("ckpt_every", 50)) == 0 or epoch == epochs:
            path = save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), epoch,
                                   ckpt_dir=ckpt_dir, prefix="vqgan_",
                                   config=config, keep=5)
            print(f"  checkpoint -> {path}")
    if use_wandb:
        wblog.finish()
    return {"state": state, "step_seconds": step_seconds,
            "epoch_seconds": epoch_seconds, "epochs": history,
            "val": val_history, "checkpoint": path, "metrics_log": log_path,
            "codebook_tracker": tracker, "device": str(device)}


def main(argv=None) -> dict:
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    return train_vqgan(config)


if __name__ == "__main__":
    main()
