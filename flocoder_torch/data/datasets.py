"""Datasets and the host input pipeline, the port's own copy of
``flocoder_tpu/data/datasets.py``: ``fast_scandir``, ``ImageFolderDataset``
(class label = first-level subdirectory, RAM cache),
``SyntheticImageDataset``, ``PairDataset``, ``InfiniteDataset`` (draws with
replacement, for the pre-encode pass), ``PreEncodedDataset`` (plain latent
files, and the inpainting triplets as ``.npz`` of target, source and mask),
``MIDIImageDataset`` (a MIDI corpus converted once to piano-roll PNGs by a
thread pool, split by song number), ``maybe_download_pop909``,
``InpaintingDataset`` (an image, a generated mask and the masked image),
the thread-pool ``Loader`` with prefetch (stacked numpy NHWC batches, the
inpainting ``source`` and ``mask_pixels`` beside the target, last partial
batch dropped; a packed shard, ``data/shard.py:ShardDataset``, gives each
batch from one native gather) and ``create_image_loaders``.
``ImageFolderDataset`` hands a transform with ``wants_path`` (the C++
decoder, ``data/native_image.py:NativeLoadResized``) the file's path
instead of a decoded image.

There is no torchvision download: a data path that is not a folder takes
the synthetic set, with a message, as the JAX package does when its
download fails. A MIDI data path that holds ``.mid`` files is converted to
piano rolls; one that holds images is read as an image folder.
"""
from __future__ import annotations

import os
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

__all__ = ["fast_scandir", "ImageFolderDataset", "SyntheticImageDataset",
           "PairDataset", "InfiniteDataset", "PreEncodedDataset", "Loader",
           "create_image_loaders", "MIDIImageDataset", "InpaintingDataset",
           "maybe_download_pop909", "POP909_URL"]

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
LATENT_EXTS = (".npy", ".npz", ".pt")


def fast_scandir(path: str, exts: Sequence[str]) -> Tuple[List[str], List[str]]:
    """Recursive scan for files with the given extensions. Returns
    (subdirs, files), both sorted."""
    subdirs, files = [], []
    for root, dirs, names in os.walk(path):
        subdirs += [os.path.join(root, d) for d in dirs]
        files += [os.path.join(root, n) for n in names
                  if os.path.splitext(n)[1].lower() in exts]
    return sorted(subdirs), sorted(files)


class ImageFolderDataset:
    """Images under a directory tree; class label = first-level subdir name
    when subdirs exist, else 0. The decoded images stay cached in RAM. A
    transform with ``wants_path`` gets the file's path and decodes it
    itself (nothing is cached). A file that fails to load is replaced by
    another draw."""

    def __init__(self, path: str, transform: Optional[Callable] = None):
        self.path = os.path.expanduser(path)
        _, self.files = fast_scandir(self.path, IMG_EXTS)
        if not self.files:
            raise FileNotFoundError(f"no images under {self.path}")
        self.class_names = sorted({self._top(f) for f in self.files})
        self.class_map = {c: i for i, c in enumerate(self.class_names)}
        self.transform = transform
        self._cache: dict = {}

    def _top(self, f: str) -> str:
        parts = os.path.relpath(f, self.path).split(os.sep)
        return parts[0] if len(parts) > 1 else ""

    @property
    def n_classes(self) -> int:
        return len(self.class_names) if self.class_names != [""] else 0

    def __len__(self):
        return len(self.files)

    def _redraw(self, i: int, f: str, e: Exception, rng: np.random.Generator):
        print(f"ImageFolderDataset: failed to load {f} ({e}); redrawing")
        j = int(rng.integers(0, len(self.files)))
        return self.get(j if j != i else (i + 1) % len(self.files), rng)

    def get(self, i: int, rng: np.random.Generator):
        f = self.files[i]
        label = np.int32(self.class_map[self._top(f)])
        if getattr(self.transform, "wants_path", False):
            try:
                return self.transform(f, rng), label
            except OSError as e:
                return self._redraw(i, f, e, rng)
        try:
            if f in self._cache:
                img = self._cache[f]
            else:
                img = Image.open(f).convert("RGB")
                img.load()
                self._cache[f] = img
        except OSError as e:
            return self._redraw(i, f, e, rng)
        out = self.transform(img, rng) if self.transform else np.asarray(img)
        return out, label


class SyntheticImageDataset:
    """Deterministic procedural images (a coloured blob per class) for runs
    with no dataset on disk; image ``i`` is drawn from ``seed + i``."""

    def __init__(self, image_size: int, transform: Optional[Callable] = None,
                 n: int = 256, n_classes: int = 4, seed: int = 0):
        self.n, self.image_size = n, image_size
        self.transform = transform
        self.n_classes, self.seed = n_classes, seed

    def __len__(self):
        return self.n

    def get(self, i: int, rng: np.random.Generator):
        g = np.random.default_rng(self.seed + i)
        label = i % self.n_classes
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s] / s
        cx, cy = g.uniform(0.3, 0.7, 2)
        r = g.uniform(0.1, 0.3)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2)
        color = np.zeros(3)
        color[label % 3] = 1.0
        img = Image.fromarray((blob[..., None] * color[None, None, :] * 255)
                              .astype(np.uint8))
        out = self.transform(img, rng) if self.transform else np.asarray(
            img, np.float32) / 255.0
        return out, np.int32(label)


class PairDataset:
    """Yields ({'source', 'target'}, label) with source == target."""

    def __init__(self, base):
        self.base = base
        self.n_classes = getattr(base, "n_classes", 0)

    def __len__(self):
        return len(self.base)

    def get(self, i: int, rng: np.random.Generator):
        img, label = self.base.get(i, rng)
        return {"source": img, "target": img}, label


class InfiniteDataset:
    """Draws with replacement: item ``i`` is a uniformly random item of
    ``base``, picked by the item's own generator before ``base`` draws its
    augmentation from it, so each pass re-randomises the frozen
    augmentations. ``length`` is the nominal epoch length."""

    def __init__(self, base, length: Optional[int] = None):
        self.base = base
        self.length = length or len(base)
        self.n_classes = getattr(base, "n_classes", 0)

    def __len__(self):
        return self.length

    def get(self, i: int, rng: np.random.Generator):
        return self.base.get(int(rng.integers(0, len(self.base))), rng)


class PreEncodedDataset:
    """Latent files written by the pre-encode pass: class subdirectories are
    labels; a file is a plain latent, HWC, as ``.npy``, as ``.npz`` with the
    one key ``latents``, or as a torch ``.pt`` tensor (CHW, the reference's
    files, turned to HWC); an inpainting triplet is an ``.npz`` of
    ``target_latents``, ``source_latents`` and ``mask_pixels`` and loads as
    that dict. Loaded latents stay cached in RAM, with random replacement
    beyond ``cache_size``."""

    def __init__(self, path: str, n_classes: int = 0, cache_size: int = 20000):
        self.path = os.path.expanduser(path)
        _, self.files = fast_scandir(self.path, LATENT_EXTS)
        if not self.files:
            raise FileNotFoundError(f"no latent files under {self.path}")
        tops = sorted({self._top(f) for f in self.files})
        self.class_map = {c: i for i, c in enumerate(tops)}
        self.n_classes = n_classes or (len(tops) if tops != [""] else 0)
        self.cache_size = cache_size
        self._cache: dict = {}

    def _top(self, f: str) -> str:
        parts = os.path.relpath(f, self.path).split(os.sep)
        return parts[0] if len(parts) > 1 else ""

    def __len__(self):
        return len(self.files)

    @staticmethod
    def _load(f: str):
        ext = os.path.splitext(f)[1].lower()
        if ext == ".npy":
            return np.load(f)
        if ext == ".npz":
            with np.load(f) as z:
                if set(z.files) == {"latents"}:
                    return z["latents"]
                return {k: z[k] for k in z.files}
        if ext == ".pt":
            import torch
            t = torch.load(f, map_location="cpu", weights_only=True)
            if isinstance(t, torch.Tensor):
                arr = t.detach().float().numpy()
                return np.transpose(arr, (1, 2, 0)) if arr.ndim == 3 else arr
        raise ValueError(f"unknown latent file {f}")

    def get(self, i: int, rng: np.random.Generator):
        f = self.files[i]
        if f in self._cache:
            data = self._cache[f]
        else:
            data = self._load(f)
            if len(self._cache) >= self.cache_size:
                victim = list(self._cache)[int(rng.integers(len(self._cache)))]
                del self._cache[victim]
            self._cache[f] = data
        return data, np.int32(self.class_map.get(self._top(f), 0))


class Loader:
    """Thread-pool batch loader, two batches ahead. Yields dict batches
    {key, 'class_cond'} (plus 'source', the same array, for
    ``PairDataset`` items; plus 'source' and 'mask_pixels' (B, H, W, 1)
    float32 for inpainting triplets) of stacked NHWC numpy arrays, dropping
    the last partial batch. Each epoch draws its order (shuffled unless
    ``shuffle=False``) and each item's generator from ``seed + epoch``, in
    the JAX package's order; the item generators are drawn when a batch is
    queued, so the streams do not depend on thread timing. A dataset with
    ``get_batch`` (a packed shard) gives each batch of the order from one
    call, the batches prefetched on their own pool (keys as ``get_batch``
    names them). ``host_shard=(rank, n_ranks)`` serves only this rank's
    contiguous slice of each epoch's order (the same seeded shuffle on
    every rank), as the JAX ``Loader``'s ``_host_slice``; ``batch_size`` is
    then the rank's own."""

    prefetch = 2

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed: int = 0, shuffle: bool = True, key: str = "target",
                 host_shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shuffle = shuffle
        self.key = key
        self.host_shard = host_shard
        self._epoch = 0

    def _host_slice(self, order: np.ndarray) -> np.ndarray:
        if not self.host_shard:
            return order
        rank, n = self.host_shard
        per = len(order) // n
        return order[rank * per:(rank + 1) * per]

    def __len__(self):
        n = len(self.dataset)
        if self.host_shard:
            n //= self.host_shard[1]
        return n // self.batch_size

    def _assemble(self, items) -> dict:
        datas, labels = zip(*items)
        batch: dict = {"class_cond": np.stack(labels)}
        if isinstance(datas[0], dict) and "target" in datas[0]:
            batch[self.key] = np.stack([d["target"] for d in datas]).astype(np.float32)
            batch["source"] = batch[self.key]
        elif isinstance(datas[0], dict):
            batch[self.key] = np.stack([d["target_latents"] for d in datas])
            if "source_latents" in datas[0]:
                batch["source"] = np.stack([d["source_latents"] for d in datas])
            if "mask_pixels" in datas[0]:
                mp = np.stack([np.asarray(d["mask_pixels"], np.float32) for d in datas])
                batch["mask_pixels"] = mp[..., None] if mp.ndim == 3 else mp
        else:
            batch[self.key] = np.stack(datas).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        order = self._host_slice(order)
        n_batches = len(self)
        batch_pool = ThreadPoolExecutor(self.prefetch)
        if hasattr(self.dataset, "get_batch"):      # a packed shard: one gather a batch
            try:
                yield from self._ahead(n_batches, lambda b: batch_pool.submit(
                    self.dataset.get_batch,
                    order[b * self.batch_size:(b + 1) * self.batch_size]))
            finally:
                batch_pool.shutdown(wait=False, cancel_futures=True)
            return
        # Item loaders and batch assemblers in separate pools: nesting them
        # in one pool deadlocks when every worker waits on item futures.
        item_pool = ThreadPoolExecutor(self.num_workers)
        try:
            def make_batch(idxs, item_rngs):
                return self._assemble(list(item_pool.map(
                    lambda a: self.dataset.get(int(a[0]), a[1]),
                    zip(idxs, item_rngs))))

            def submit(b):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                item_rngs = [np.random.default_rng(rng.integers(2 ** 31))
                             for _ in idxs]
                return batch_pool.submit(make_batch, idxs, item_rngs)

            yield from self._ahead(n_batches, submit)
        finally:
            batch_pool.shutdown(wait=False, cancel_futures=True)
            item_pool.shutdown(wait=False, cancel_futures=True)

    def _ahead(self, n_batches: int, submit) -> Iterator[dict]:
        """The results of ``submit(b)`` (a future) for b in range(n_batches),
        each submitted ``prefetch`` batches ahead, in order."""
        pending: "queue.Queue" = queue.Queue()
        n_ahead = min(self.prefetch, n_batches)
        for b in range(n_ahead):
            pending.put(submit(b))
        for b in range(n_batches):
            fut = pending.get()
            if b + n_ahead < n_batches:
                pending.put(submit(b + n_ahead))
            yield fut.result()


class _Subset:
    def __init__(self, base, ids):
        self.base, self.ids = base, ids
        self.n_classes = getattr(base, "n_classes", 0)

    def __len__(self):
        return len(self.ids)

    def get(self, i, rng):
        return self.base.get(int(self.ids[i]), rng)


def create_image_loaders(batch_size: int, image_size: int, data_path: str,
                         num_workers: int = 4, is_midi: bool = False,
                         val_frac: float = 0.1, seed: int = 0) -> Tuple[Loader, Loader]:
    """Train/val loaders of ``PairDataset`` items: an existing directory is
    an image folder (with ``is_midi``, the piano-roll transforms; a folder
    that holds ``.mid`` files is converted to piano rolls first by
    ``MIDIImageDataset``, its train split); any other path takes the
    synthetic set. 10% of the items (at least one) go to validation; a
    split smaller than the batch gets a batch of its size."""
    from .transforms import image_transforms, midi_transforms
    tf = midi_transforms(image_size) if is_midi else image_transforms(image_size)
    path = os.path.expanduser(data_path)
    if os.path.isdir(path) and is_midi and fast_scandir(path, (".mid", ".midi"))[1]:
        dataset = MIDIImageDataset(path, split="train", transform=tf,
                                   num_workers=num_workers)
    elif os.path.isdir(path):
        dataset = ImageFolderDataset(path, transform=tf)
    else:
        print(f"data path {path!r} is not a folder (the port downloads "
              "nothing): training on the synthetic image set")
        dataset = SyntheticImageDataset(image_size=image_size, transform=tf)
    n = len(dataset)
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    n_val = max(1, int(n * val_frac))
    train = Loader(PairDataset(_Subset(dataset, idx[n_val:])),
                   max(1, min(batch_size, n - n_val)), num_workers, seed)
    val = Loader(PairDataset(_Subset(dataset, idx[:n_val])),
                 max(1, min(batch_size, n_val)), num_workers, seed + 1)
    return train, val


POP909_URL = ("https://github.com/music-x-lab/POP909-Dataset/raw/refs/"
              "heads/master/POP909.zip")


def maybe_download_pop909(root: str, url: str = POP909_URL) -> Optional[str]:
    """Fetch the POP909 zip from ``url`` into ``root`` and extract it;
    returns the extracted directory, or None on any failure (no egress, a
    bad archive), so that callers keep the local-corpus path. An already
    extracted corpus is returned without a fetch; ``file://`` URLs work."""
    import urllib.request
    import zipfile
    name = url.rsplit("/", 1)[-1]
    out_dir = os.path.join(root, name[:-4] if name.endswith(".zip") else name)
    if os.path.isdir(out_dir) and fast_scandir(out_dir, (".mid", ".midi"))[1]:
        return out_dir
    try:
        os.makedirs(root, exist_ok=True)
        zip_path = os.path.join(root, name)
        if not os.path.isfile(zip_path):
            with urllib.request.urlopen(url, timeout=60) as r, \
                    open(zip_path + ".part", "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(zip_path + ".part", zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(root)
        return out_dir if os.path.isdir(out_dir) else root
    except Exception as e:  # no egress, a corrupt archive: the local corpus
        print(f"maybe_download_pop909: {type(e).__name__}: {e}; "
              "expecting a local MIDI corpus")
        return None


class MIDIImageDataset:
    """Piano-roll images converted from a MIDI corpus. When ``download`` is
    set and ``midi_dir`` holds no MIDI files, tries ``maybe_download_pop909``;
    otherwise ``midi_dir`` is an existing corpus. ``skip_versions`` drops the
    ``versions/`` alternate takes of each song; ``total_only`` keeps only
    each song's ``_TOTAL`` roll. The conversion runs once, by a thread pool,
    into ``image_dir`` (default ``<midi_dir>_images``); a song directory whose
    number is divisible by ``val_mod`` goes to ``val``, the rest to
    ``train``. Items are RGB piano rolls through ``transform``."""

    def __init__(self, midi_dir: str, image_dir: Optional[str] = None,
                 split: str = "train", val_mod: int = 10,
                 transform: Optional[Callable] = None,
                 num_workers: int = 4, download: bool = True,
                 skip_versions: bool = True, total_only: bool = False,
                 url: str = POP909_URL):
        from .pianoroll import midi_to_pr_img
        self.midi_dir = os.path.expanduser(midi_dir)
        self.image_dir = image_dir or self.midi_dir.rstrip("/") + "_images"
        _, midis = fast_scandir(self.midi_dir, (".mid", ".midi"))
        if not midis and download:
            got = maybe_download_pop909(self.midi_dir, url=url)
            if got:
                self.image_dir = image_dir or got.rstrip("/") + "_images"
                _, midis = fast_scandir(got, (".mid", ".midi"))
        if skip_versions:
            midis = [m for m in midis if f"{os.sep}versions{os.sep}" not in m]
        if not midis:
            raise FileNotFoundError(f"no MIDI files under {self.midi_dir}")
        if not os.path.isdir(self.image_dir) or not fast_scandir(self.image_dir, IMG_EXTS)[1]:
            os.makedirs(self.image_dir, exist_ok=True)
            with ThreadPoolExecutor(num_workers) as pool:
                list(pool.map(lambda m: midi_to_pr_img(m, self.image_dir), midis))
        _, files = fast_scandir(self.image_dir, IMG_EXTS)
        if total_only:
            files = [f for f in files if "_TOTAL" in os.path.basename(f)]

        def song_num(f: str) -> int:
            digits = "".join(c for c in os.path.basename(os.path.dirname(f))
                             if c.isdigit()) or "0"
            return int(digits)

        keep_val = split == "val"
        self.files = [f for f in files if (song_num(f) % val_mod == 0) == keep_val]
        self.transform = transform
        self.n_classes = 0

    def __len__(self):
        return len(self.files)

    def get(self, i: int, rng: np.random.Generator):
        img = Image.open(self.files[i]).convert("RGB")
        out = self.transform(img, rng) if self.transform else np.asarray(
            img, np.float32) / 255.0
        return out, np.int32(0)


class InpaintingDataset:
    """Items {'target_latents': image, 'source_latents': image·(1 − mask),
    'mask_pixels': mask (H, W, 1)} of a pixel-space dataset, the mask drawn
    by ``inpainting.generate_mask`` from the item's generator; the
    pre-encode pass turns such items into latent triplets."""

    def __init__(self, base, mask_kwargs: Optional[dict] = None):
        self.base = base
        self.mask_kwargs = mask_kwargs or {}
        self.n_classes = getattr(base, "n_classes", 0)

    def __len__(self):
        return len(self.base)

    def get(self, i: int, rng: np.random.Generator):
        from ..inpainting import generate_mask
        img, label = self.base.get(i, rng)
        img = np.asarray(img, np.float32)
        mask = generate_mask(img.shape[:2], rng=rng, **self.mask_kwargs)[..., None]
        return {"target_latents": img, "source_latents": img * (1 - mask),
                "mask_pixels": mask}, label
