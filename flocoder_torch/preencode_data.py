"""Pre-encode an image dataset into latents with frozen augmentations, on the
CUDA card — the port of the repo's ``preencode_data.py``.

Usage:
    python -m flocoder_torch.preencode_data --config-name flowers_vqgan.yaml \\
        [data=/path/to/images] [preencoding.quantize=true] \\
        [preencoding.fused_vq=true] [key=value ...]

For each split (10% of the items by a fixed shuffle go to ``val``, the rest
to ``train``) the host's thread pool draws items with replacement and
augments them (``InfiniteDataset`` under the ``Loader``, seeded by ``seed``
plus 0 for train and 1 for val), the codec encodes each batch on the card
under ``torch.inference_mode``, and a pool of 8 writers saves every latent as
``{data}_encoded_{codec.choice}/{split}/{class}/b{batch:06d}_{item:03d}.npy``
(HWC float32), the files the JAX package writes, so either package's flow
trainer reads either package's latents. ``augs_per`` passes over a split
give ``augs_per·len(split)//batch_size`` batches. A split that already holds
files is never overwritten, and writing stops at ``max_storage_gb``.

Encoding: ``codec.encode`` (for the SD VAE of ``flowers_sd``, the
posterior mean); with ``preencoding.quantize=true`` on the VQGAN codec also
the RVQ (``codec.quantize(...)[0]``); with ``preencoding.fused_vq=true`` as
well, ``encode_quantize_fused``, whose compression tail and RVQ search are
one launch of K3 on the card. The VQGAN+ codec (``codec.choice=vqgan_plus``)
has no fused path in either package: with ``preencoding.fused_vq=true`` it
quantizes through the unfused RVQ, and each split prints so beside its host
decoder (``quantize_path``). The codec loads its weights strictly where
the files exist (``codec.checkpoint``; for the SD VAE first
``weights/sd_vae_ft_mse.npz``), and keeps seeded random weights otherwise.

A data path is an image folder or, when absent, the synthetic image set; a
path whose name holds ``midi`` or ``pop909`` is a folder of piano-roll
images and takes the piano-roll transforms (``midi_transforms``).

``inpainting=true`` writes triplets into ``{data}_encoded_{codec.choice}
_inpainting/{split}``: per batch ``b`` the masks of
``generate_mask_batch(seed=seed·100003 + b)``, the encode of the images
(``target_latents``) and of the masked images (``source_latents``), saved
with the masks (as bool, ``mask_pixels``) in one ``.npz`` per item. A
learned codec whose ``in_channels`` differ from the loader's images raises
a ``ValueError`` (the JAX package fails there too, with a shape error;
ROADMAP.md); the resize and noop codecs take any channels.

``preencoding.device_augs=true`` (image data only; MIDI rolls keep the host
transforms, as in the JAX script): the host decodes each image once and
resizes it to ``S0 = ⌈1.25·image_size⌉`` (the C++ decoder of
``data/native_image.py`` where its library builds, else PIL; the run prints
which and why, and each split's result names it), and the card makes the
frozen augmentations (``data/device_augs.py``) after the copy and before the
encode, its draws from one ``torch.Generator`` seeded with ``seed + 7919``.
With ``inpainting=true`` the masks are drawn after the augment, at
``image_size``.

``preencoding.format=shard`` writes one packed file per split,
``{split}/data.fcshard`` (``data/shard.py``, the JAX package's FCS1
format: HWC float32 records, int32 labels; triplets carry
``source_latents`` and ``mask_pixels`` (S, S, 1) as extra fields), instead
of one file per latent.

``codec.bf16`` builds the codec in bf16 (``setup_codec``); its bf16
latents are written widened to float32, exactly, in files and shards alike.
(The JAX script's ``np.save`` of a bf16 latent writes an opaque ``<V2``
array that its own loader cannot read; ROADMAP.md.) With the fused path the
bf16 encoder hands its bf16 activations to K3's bf16 case. ``+quant=int8``
(also ``true`` or ``1``) sets ``codec.quant_encode: int8``, as the JAX
script does: the encoder's convolutions run W8A8 int8 (``ops/quant.py``),
the compression head stays plain.

Audio (``codec.choice=dac``, ``audio_dac.yaml``): a folder of ``.wav``
files (its ``train``/``val`` subfolder when present) or, when ``data`` is
not a folder, the synthetic chords (256 clips); random crops of
``codec.crop_len`` samples are the frozen augmentation. The DAC encodes
each batch (B, T, 1) and ``fold_latents`` folds the (B, T', D) sequence into
(B, √T', √T', D) latent images, written as image latents are (files or a
shard; with ``preencoding.quantize=true`` through the RVQ first). The codec
is ``codec.checkpoint`` or, by default, the newest ``dac_*.npz`` under
``+ckpt_dir`` (``checkpoints``), loaded strictly. ``inpainting=true``
with ``dac`` raises, as in the JAX script.

``+device=cpu`` runs on the CPU; without it the run needs a CUDA device.
On several ranks (``torchrun --nproc_per_node=N -m
flocoder_torch.preencode_data ...``; ``parallel/mesh.py`` and ``+device``
as in ``train_flow``) every rank reads the same batches,
augments them alike, and encodes its own rows of each (the fused path: K3
on the rank's rows); the latents are gathered and rank 0 alone writes, so
the files are a one-process run's. A batch that does not split over the
ranks is encoded whole on every rank.
A ``data`` path that names no folder (a torchvision set's name, say) takes
the synthetic set, as the JAX script does without torchvision
(``data/datasets.py``); no named set is downloaded.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import ldcfg, parse_cli
from .data import native_image
from .data.audio_io import AudioFolderDataset, SyntheticAudioDataset
from .data.datasets import (ImageFolderDataset, InfiniteDataset, Loader,
                            SyntheticImageDataset)
from .data.device_augs import default_src_size, load_resized, make_device_augment
from .data.shard import ShardWriter
from .data.transforms import image_transforms, midi_transforms
from .generate_samples import CONFIG_DIR
from .inpainting import generate_mask_batch
from .models.audio_codec import DACCodec, fold_latents
from .models.codecs import (VQVAE, NoOpAE, SimpleResizeAE, codec_checkpoint,
                            load_codec_weights, setup_codec)
from .models.layers import init_params
from .models.vqgan_plus import VQGANPlus
from .parallel.mesh import (batch_shard_count, broadcast0_, gather_rows, is_writer,
                            make_mesh, maybe_init_distributed, rank0_print, shard_batch)

__all__ = ["open_split", "process_dataset", "load_codec", "host_decoder",
           "quantize_path", "main"]


def _is_audio(config) -> bool:
    return "codec" in config and config.codec.get("choice") == "dac"


def _quant_flag(config) -> None:
    """``+quant=int8`` (``true``, ``1``) requests the W8A8 encode: it sets
    ``codec.quant_encode``, as the JAX script does."""
    if str(config.get("quant", "") or "").lower() in ("int8", "true", "1"):
        if "codec" not in config:
            config["codec"] = {}
        config.codec["quant_encode"] = "int8"


def load_codec(config, device) -> torch.nn.Module:
    """The recipe's codec on ``device`` with seeded random weights (seed 0),
    then its weights loaded strictly where the files exist
    (``models.codecs.load_codec_weights``: for the SD VAE
    ``weights/sd_vae_ft_mse.npz``, then ``codec_checkpoint``)."""
    _quant_flag(config)
    codec = setup_codec(config, device=device)
    init_params(codec, torch.Generator(device).manual_seed(0))
    load_codec_weights(codec, codec_checkpoint(config))
    return codec.eval()


def quantize_path(config, codec) -> tuple:
    """``(name, why)`` of the quantization after the encode: ``'fused'``
    (``encode_quantize_fused``, K3 on the card), ``'rvq'`` (the codec's
    unfused ``quantize``) or ``'none'`` (the continuous latents)."""
    pe = config.get("preencoding", {})
    if not (bool(pe.get("quantize", False))
            and isinstance(codec, (VQVAE, VQGANPlus, DACCodec))):
        return "none", "preencoding.quantize is off or the codec has no RVQ"
    if not bool(pe.get("fused_vq", False)):
        return "rvq", "preencoding.fused_vq is off"
    if isinstance(codec, VQVAE):
        return "fused", "preencoding.fused_vq=true"
    return "rvq", (f"preencoding.fused_vq=true, but the {type(codec).__name__} codec "
                   "has no fused path")


def _encoder(config, codec):
    """The batch → latents function of the three encode modes
    (``quantize_path``); the DAC codec's latents folded into images."""
    path = quantize_path(config, codec)[0]
    if isinstance(codec, DACCodec):
        if path == "rvq":
            return lambda x: codec.quantize(fold_latents(codec.encode(x)))[0]
        return lambda x: fold_latents(codec.encode(x))
    if path == "fused":
        return lambda x: codec.encode_quantize_fused(x)[0]
    if path == "rvq":
        return lambda x: codec.quantize(codec.encode(x))[0]
    return codec.encode


def _is_midi(config) -> bool:
    return any(s in str(config.data).lower() for s in ("pop909", "midi"))


def _device_augs(config) -> bool:
    """``preencoding.device_augs``, which MIDI and audio data never take."""
    return (bool(config.get("preencoding", {}).get("device_augs", False))
            and not _is_midi(config) and not _is_audio(config))


def host_decoder(config) -> tuple:
    """``(name, why)`` of the host's image decoder for this config:
    ``'native'`` (``data/native_image.py``'s C++ decode and resize),
    ``'pil'`` (PIL's decode, then ``device_augs.load_resized``, when the
    native library does not build) or ``'pil+transforms'`` (the host
    transforms, without device_augs) or ``'wav'`` (audio: the crops are
    read by ``data/audio_io.py``)."""
    if _is_audio(config):
        return "wav", "audio crops (data/audio_io.py)"
    if not _device_augs(config):
        return "pil+transforms", "preencoding.device_augs is off"
    if native_image.available():
        return "native", f"built {native_image.library_file()}"
    return "pil", f"the native decoder did not build: {native_image.why_unavailable()}"


def _audio_dataset(config, data_path: str, split: str):
    """The WAV folder (its ``split`` subfolder when present) or the
    synthetic chords; random crops are the frozen augmentation."""
    crop_len = int(config.codec.get("crop_len", 32768))
    sample_rate = int(config.codec.get("sample_rate", 16000))
    if os.path.isdir(data_path):
        sub = os.path.join(data_path, split)
        dataset = AudioFolderDataset(sub if os.path.isdir(sub) else data_path,
                                     crop_len=crop_len, sample_rate=sample_rate)
        print(f"[{split}] WAV folder {dataset.path}: {len(dataset)} files")
        return dataset
    print(f"data path {data_path!r} is not a folder: pre-encoding the synthetic chords")
    return SyntheticAudioDataset(crop_len=crop_len, sample_rate=sample_rate,
                                 n_classes=int(ldcfg(config, "n_classes", 4)))


def _image_dataset(config, data_path: str, split: str, image_size: int):
    """The image folder or the synthetic image set, with the host
    transforms (or, with device_augs, the host's decode and resize)."""
    if _device_augs(config):
        src_size = default_src_size(image_size)
        if host_decoder(config)[0] == "native":
            tf = native_image.NativeLoadResized(src_size)
        else:
            def tf(img, rng):
                return load_resized(img, src_size)
    else:
        tf = midi_transforms(image_size) if _is_midi(config) else image_transforms(image_size)
    if os.path.isdir(data_path):
        dataset = ImageFolderDataset(data_path, transform=tf)
        print(f"[{split}] image folder {data_path}: {len(dataset)} images")
        return dataset
    print(f"data path {data_path!r} is not a folder (the port downloads "
          "nothing): pre-encoding the synthetic image set")
    return SyntheticImageDataset(image_size=image_size, transform=tf)


def open_split(config, split: str) -> tuple:
    """One split as ``process_dataset`` encodes it: ``(dataset, n_batches,
    batches)``, with ``batches`` a generator of the split's ``n_batches``
    batches ({'pixels', 'class_cond'}) in order. The same config gives the
    same pixels, so a caller can rebuild what was encoded. With
    ``device_augs`` the pixels are the host's (B, S0, S0, 3) sources in
    [0, 1], which ``process_dataset`` augments on the device."""
    data_path = os.path.expanduser(str(config.data))
    image_size = int(ldcfg(config, "image_size", 128))
    pe = config.get("preencoding", {})
    batch_size = int(pe.get("batch_size", 32))
    augs_per = int(pe.get("augs_per", 16))
    num_workers = int(pe.get("num_workers", 4))
    seed = int(ldcfg(config, "seed", 0)) + (0 if split == "train" else 1)

    dataset = (_audio_dataset(config, data_path, split) if _is_audio(config)
               else _image_dataset(config, data_path, split, image_size))

    # 90/10 split by a fixed shuffle of the item indices
    idx = np.arange(len(dataset))
    np.random.default_rng(0).shuffle(idx)
    n_val = max(1, len(dataset) // 10)
    ids = idx[:n_val] if split == "val" else idx[n_val:]

    class _Split:
        n_classes = getattr(dataset, "n_classes", 0)

        def __len__(self):
            return len(ids)

        def get(self, i, rng):
            return dataset.get(int(ids[i]), rng)

    batch_size = max(1, min(batch_size, len(ids)))
    loader = Loader(InfiniteDataset(_Split(), length=len(ids)), batch_size,
                    num_workers=num_workers, seed=seed, key="pixels")
    total_batches = max(1, (augs_per * len(ids)) // batch_size)

    def batches():
        it = iter(loader)
        try:
            for _ in range(total_batches):
                try:
                    yield next(it)
                except StopIteration:       # the next pass over the split
                    it = iter(loader)
                    yield next(it)
        finally:
            it.close()

    return dataset, total_batches, batches()


def process_dataset(config, split: str, codec, device, mesh=None) -> dict:
    """Pre-encode one split; returns ``{'split', 'out_dir', 'batches',
    'latents', 'seconds', 'latents_per_s', 'bytes', 'format', 'decoder',
    'quantize'}``, the seconds by the host clock over the whole split
    (loader, copies, augments, encodes, writes), ``decoder`` the host's
    image decoder (``host_decoder``), ``quantize`` the quantization
    (``quantize_path``). With ``inpainting`` a latent is one triplet (two
    encodes). ``mesh``: each rank encodes its rows, rank 0 writes (every
    rank calls; ``bytes`` counts rank 0's files)."""
    data_path = os.path.expanduser(str(config.data))
    pe = config.get("preencoding", {})
    max_gb = float(pe.get("max_storage_gb", 60))
    fmt = str(pe.get("format", "files"))
    if fmt not in ("files", "shard"):
        raise ValueError(f"preencoding.format={fmt!r}: files or shard")
    inpainting = bool(config.get("inpainting", False))
    if inpainting and isinstance(codec, DACCodec):
        raise SystemExit("inpainting triplets are an image-pipeline feature; "
                         "codec.choice=dac pre-encodes waveforms")
    image_size = int(ldcfg(config, "image_size", 128))
    seed = int(ldcfg(config, "seed", 0)) + (0 if split == "train" else 1)
    out_dir = f"{data_path}_encoded_{config.codec.choice}"
    out_split = os.path.join(out_dir + ("_inpainting" if inpainting else ""), split)
    if os.path.exists(out_split) and os.listdir(out_split):
        raise SystemExit(f"Refusing to overwrite existing {out_split}")
    writer_rank, n_shards = is_writer(), batch_shard_count(mesh)
    decoder, why = host_decoder(config)
    rank0_print(f"[{split}] host decoder: {decoder} ({why})")
    quantize, why = quantize_path(config, codec)
    rank0_print(f"[{split}] quantize: {quantize} ({why})")
    dataset, total_batches, batches = open_split(config, split)
    if writer_rank:
        os.makedirs(out_split, exist_ok=True)
    encode_all = _encoder(config, codec)

    def encode(x):
        """This rank's rows encoded, every rank's gathered (a batch that
        does not split: all of it)."""
        if x.shape[0] % n_shards:
            return encode_all(x)
        return gather_rows(encode_all(shard_batch(mesh, x)), mesh)

    augment = aug_gen = None
    if _device_augs(config):
        augment = make_device_augment(image_size)
        aug_gen = torch.Generator(device).manual_seed(seed + 7919)
    shard = None
    class_names = getattr(dataset, "class_names", None)
    n_classes = getattr(dataset, "n_classes", 0)
    bytes_written = 0
    lock = threading.Lock()

    def write_one(name: str, latent, label: int) -> None:
        nonlocal bytes_written
        sub = (class_names[label] if class_names and class_names != [""]
               else f"{label:04d}" if n_classes else "data")
        d = os.path.join(out_split, sub)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        if isinstance(latent, dict):        # an inpainting triplet
            np.savez(path, **latent)
            path += ".npz"
        else:
            path += ".npy"
            np.save(path, latent)
        with lock:
            bytes_written += os.path.getsize(path)

    t0 = time.time()
    n_saved, b = 0, 0
    with ThreadPoolExecutor(8) as writer, torch.inference_mode():
        for b, batch in enumerate(batches):
            x = torch.from_numpy(batch["pixels"]).to(device)
            if augment is not None:
                x = augment(x, aug_gen)
            # the resize and noop codecs take any channels (the resize codec's
            # in_channels is its latent width, as in the JAX package)
            if not isinstance(codec, (SimpleResizeAE, NoOpAE)) and \
                    x.shape[-1] != getattr(codec, "in_channels", x.shape[-1]):
                raise ValueError(
                    f"the codec takes {codec.in_channels}-channel images but the "
                    f"loader gives {x.shape[-1]}-channel ones (the MIDI loaders give "
                    "RGB piano rolls; a grayscale loader is not wired in, in either "
                    "package: ROADMAP.md)")
            if inpainting:
                masks = generate_mask_batch(tuple(x.shape[1:3]), batch_size=x.shape[0],
                                            seed=seed * 100003 + b)
                masked = x * (1 - torch.from_numpy(masks).to(device))
                target = encode(x).float().cpu().numpy()
                source = encode(masked).float().cpu().numpy()
                extras = {"source_latents": source, "mask_pixels": masks}
            else:
                target, extras = encode(x).float().cpu().numpy(), None
            labels = np.asarray(batch["class_cond"])
            if not writer_rank:
                n_saved += len(target)
            elif fmt == "shard":
                if shard is None:       # the record shape is the first batch's
                    shard = ShardWriter(
                        os.path.join(out_split, "data.fcshard"), target.shape[1:],
                        extra_fields=None if extras is None else {
                            "source_latents": target.shape[1:],
                            "mask_pixels": (image_size, image_size, 1)})
                bytes_written += shard.add_batch(target, labels, extras)
                n_saved += len(target)
            else:
                for i, label in enumerate(labels):
                    item = target[i] if extras is None else {
                        "target_latents": target[i], "source_latents": source[i],
                        "mask_pixels": masks[i].astype(bool)}
                    writer.submit(write_one, f"b{b:06d}_{i:03d}", item, int(label))
                    n_saved += 1
            stop = bytes_written > max_gb * 1e9
            if n_shards > 1:                        # rank 0 counts the bytes
                stop = bool(broadcast0_(torch.tensor(stop, device=device), mesh))
            if stop:
                rank0_print(f"storage cap {max_gb}GB reached")
                batches.close()
                break
            if b % 50 == 0:
                rank0_print(f"  [{split}] batch {b}/{total_batches}  {n_saved} latents  "
                            f"{n_saved / max(time.time() - t0, 1e-9):.0f}/s  "
                            f"{bytes_written / 1e9:.2f}GB")
    if shard is not None:
        shard.close()
    seconds = time.time() - t0
    rate = n_saved / max(seconds, 1e-9)
    rank0_print(f"[{split}] done: {n_saved} latents in {seconds:.1f}s ({rate:.1f} "
                f"latents/s, {fmt}, decoder {decoder}) -> {out_split}")
    return {"split": split, "out_dir": out_split, "batches": b + 1,
            "latents": n_saved, "seconds": seconds, "latents_per_s": rate,
            "bytes": bytes_written, "format": fmt, "decoder": decoder,
            "quantize": quantize}


def main(argv=None) -> dict:
    """Pre-encode ``val`` then ``train``; returns ``{'val': stats, 'train':
    stats, 'codec': the codec, 'device': str}``."""
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    device = maybe_init_distributed(config.get("device", None))
    mesh = make_mesh(device=device)
    codec = load_codec(config, device)
    out = {split: process_dataset(config, split, codec, device, mesh)
           for split in ("val", "train")}
    return {**out, "codec": codec, "device": str(device)}


if __name__ == "__main__":
    main()
