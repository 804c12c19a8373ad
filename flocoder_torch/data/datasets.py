"""Image datasets and the host input pipeline, the port's own copy of the
image part of ``flocoder_tpu/data/datasets.py``: ``fast_scandir``,
``ImageFolderDataset`` (class label = first-level subdirectory, RAM cache),
``SyntheticImageDataset``, ``PairDataset``, ``InfiniteDataset`` (draws with
replacement, for the pre-encode pass), ``PreEncodedDataset`` (plain latent
files; the inpainting dicts wait for ROADMAP.md item 8), the thread-pool
``Loader`` with prefetch (stacked numpy NHWC batches, last partial batch
dropped) and ``create_image_loaders``.

There is no torchvision download: a data path that is not a folder takes
the synthetic set, with a message, as the JAX package does when its
download fails. MIDI data waits for the MIDI slice (ROADMAP.md) and raises.
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
           "create_image_loaders"]

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
    file that fails to load is replaced by another draw."""

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

    def get(self, i: int, rng: np.random.Generator):
        f = self.files[i]
        try:
            if f in self._cache:
                img = self._cache[f]
            else:
                img = Image.open(f).convert("RGB")
                img.load()
                self._cache[f] = img
        except OSError as e:
            print(f"ImageFolderDataset: failed to load {f} ({e}); redrawing")
            j = int(rng.integers(0, len(self.files)))
            return self.get(j if j != i else (i + 1) % len(self.files), rng)
        out = self.transform(img, rng) if self.transform else np.asarray(img)
        return out, np.int32(self.class_map[self._top(f)])


class SyntheticImageDataset:
    """Deterministic procedural images (a coloured blob per class) for runs
    with no dataset on disk."""

    n_classes = 4

    def __init__(self, image_size: int, transform: Optional[Callable] = None,
                 n: int = 256):
        self.n, self.image_size = n, image_size
        self.transform = transform

    def __len__(self):
        return self.n

    def get(self, i: int, rng: np.random.Generator):
        g = np.random.default_rng(i)
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
    files, turned to HWC). The inpainting dicts (``.npz`` of target, source
    and mask) wait for ROADMAP.md item 8 and raise. Loaded latents stay
    cached in RAM, with random replacement beyond ``cache_size``."""

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
    def _load(f: str) -> np.ndarray:
        ext = os.path.splitext(f)[1].lower()
        if ext == ".npy":
            return np.load(f)
        if ext == ".npz":
            with np.load(f) as z:
                if set(z.files) == {"latents"}:
                    return z["latents"]
        elif ext == ".pt":
            import torch
            t = torch.load(f, map_location="cpu", weights_only=True)
            if isinstance(t, torch.Tensor):
                arr = t.detach().float().numpy()
                return np.transpose(arr, (1, 2, 0)) if arr.ndim == 3 else arr
        raise NotImplementedError(f"{f} is not a plain latent: inpainting "
                                  "latents are not ported yet (ROADMAP.md item 8)")

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
    ``PairDataset`` items) of stacked float32 NHWC numpy arrays, dropping
    the last partial batch. Each epoch draws its order (shuffled unless
    ``shuffle=False``) and each item's generator from ``seed + epoch``, in
    the JAX package's order; the item generators are drawn when a batch is
    queued, so the streams do not depend on thread timing."""

    prefetch = 2

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed: int = 0, shuffle: bool = True, key: str = "target"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shuffle = shuffle
        self.key = key
        self._epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _assemble(self, items) -> dict:
        datas, labels = zip(*items)
        batch: dict = {"class_cond": np.stack(labels)}
        if isinstance(datas[0], dict):
            batch[self.key] = np.stack([d["target"] for d in datas]).astype(np.float32)
            batch["source"] = batch[self.key]
        else:
            batch[self.key] = np.stack(datas).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        n_batches = len(self)
        # Item loaders and batch assemblers in separate pools: nesting them
        # in one pool deadlocks when every worker waits on item futures.
        item_pool = ThreadPoolExecutor(self.num_workers)
        batch_pool = ThreadPoolExecutor(self.prefetch)
        try:
            def make_batch(idxs, item_rngs):
                return self._assemble(list(item_pool.map(
                    lambda a: self.dataset.get(int(a[0]), a[1]),
                    zip(idxs, item_rngs))))

            def submit(b):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                item_rngs = [np.random.default_rng(rng.integers(2 ** 31))
                             for _ in idxs]
                pending.put(batch_pool.submit(make_batch, idxs, item_rngs))

            pending: "queue.Queue" = queue.Queue()
            n_ahead = min(self.prefetch, n_batches)
            for b in range(n_ahead):
                submit(b)
            for b in range(n_batches):
                fut = pending.get()
                if b + n_ahead < n_batches:
                    submit(b + n_ahead)
                yield fut.result()
        finally:
            batch_pool.shutdown(wait=False, cancel_futures=True)
            item_pool.shutdown(wait=False, cancel_futures=True)


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
    an image folder; any other path takes the synthetic set. 10% of the
    items (at least one) go to validation; a split smaller than the batch
    gets a batch of its size."""
    if is_midi:
        raise NotImplementedError("MIDI datasets are not ported yet (ROADMAP.md)")
    from .transforms import image_transforms
    tf = image_transforms(image_size)
    path = os.path.expanduser(data_path)
    if os.path.isdir(path):
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
