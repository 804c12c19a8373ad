"""Packed latent shards and the native (C++) batch gather, the port's own
copy of ``flocoder_tpu/data/shard.py``.

One mmap'd shard per split replaces one ``.npy`` file per latent: a batch is
one multithreaded gather by ``csrc/fcloader.cpp`` (``fcs_gather``) instead of
B file opens. The library is built with g++ at first use into
``flocoder_torch/build/`` (``ops/kernels/build.py:build_host_library``); a
failed build raises. ``ShardReader(use_native=False)`` reads the same file
through numpy memmaps, the plain twin of the gather.

Format (FCS1), byte for byte the JAX package's: ``b"FCS1" | u32 json_len |
header json | i32 labels[n] | records``, contiguous fixed-size float32
records. The header carries ``shape`` (per-record HWC) and the optional
``extra_fields`` packed after the main record in each record (the
inpainting triplets' ``source_latents`` and ``mask_pixels``).
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.kernels.build import build_host_library

__all__ = ["ShardWriter", "ShardReader", "ShardDataset", "library_file"]

_lib = None
_lib_path = None
_lib_lock = threading.Lock()


def library_file() -> str:
    """The path of the built gather library (built on first call)."""
    _load_lib()
    return _lib_path


def _load_lib():
    global _lib, _lib_path
    with _lib_lock:
        if _lib is None:
            _lib_path = build_host_library("fcloader.cpp")
            lib = ctypes.CDLL(_lib_path)
            lib.fcs_open.restype = ctypes.c_void_p
            lib.fcs_open.argtypes = [ctypes.c_char_p]
            lib.fcs_count.restype = ctypes.c_int64
            lib.fcs_count.argtypes = [ctypes.c_void_p]
            lib.fcs_record_bytes.restype = ctypes.c_int64
            lib.fcs_record_bytes.argtypes = [ctypes.c_void_p]
            lib.fcs_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.fcs_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class ShardWriter:
    """Streams records into a shard file. ``shape`` is the per-record array
    shape; ``extra_fields`` maps name → shape of further per-record arrays
    packed after the main one (the inpainting source latents and mask).
    The payload goes to ``<path>.payload.tmp`` until ``close`` writes the
    header and labels before it."""

    def __init__(self, path: str, shape: Sequence[int],
                 extra_fields: Optional[dict] = None):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.extra_fields = {k: tuple(int(x) for x in v)
                             for k, v in (extra_fields or {}).items()}
        self._labels: list = []
        self._tmp_payload = path + ".payload.tmp"
        self._f = open(self._tmp_payload, "wb")
        self._record_bytes = 4 * int(np.prod(self.shape)) + sum(
            4 * int(np.prod(s)) for s in self.extra_fields.values())

    def add(self, record: np.ndarray, label: int = 0, extras: Optional[dict] = None):
        rec = np.ascontiguousarray(record, dtype=np.float32)
        assert rec.shape == self.shape, (rec.shape, self.shape)
        self._f.write(rec.tobytes())
        for name, shp in self.extra_fields.items():
            arr = np.ascontiguousarray(extras[name], dtype=np.float32)
            assert arr.shape == shp, (name, arr.shape, shp)
            self._f.write(arr.tobytes())
        self._labels.append(int(label))

    def add_batch(self, records: np.ndarray, labels=None,
                  extras: Optional[dict] = None) -> int:
        """Appends a batch in one write, the ``[main | extras...]`` records
        assembled by one concatenate. Returns the bytes written."""
        recs = np.asarray(records, dtype=np.float32)
        B = recs.shape[0]
        assert recs.shape[1:] == self.shape, (recs.shape, self.shape)
        parts = [recs.reshape(B, -1)]
        for name, shp in self.extra_fields.items():
            arr = np.asarray(extras[name], dtype=np.float32)
            assert arr.shape == (B,) + shp, (name, arr.shape, shp)
            parts.append(arr.reshape(B, -1))
        payload = np.concatenate(parts, axis=1) if len(parts) > 1 else \
            np.ascontiguousarray(parts[0])
        self._f.write(payload.tobytes())
        if labels is None:
            labels = np.zeros((B,), np.int32)
        self._labels.extend(np.asarray(labels, np.int64).tolist())
        return B * self._record_bytes

    def close(self) -> str:
        self._f.close()
        header = json.dumps({
            "n": len(self._labels), "record_bytes": self._record_bytes,
            "shape": list(self.shape), "dtype": "float32",
            "extra_fields": {k: list(v) for k, v in self.extra_fields.items()},
        }).encode()
        with open(self.path, "wb") as out:
            out.write(b"FCS1")
            out.write(np.uint32(len(header)).tobytes())
            out.write(header)
            out.write(np.asarray(self._labels, np.int32).tobytes())
            with open(self._tmp_payload, "rb") as pf:
                while chunk := pf.read(1 << 22):
                    out.write(chunk)
        os.remove(self._tmp_payload)
        return self.path


class ShardReader:
    """Batch gather from a shard: the native C++ gather, or with
    ``use_native=False`` numpy memmaps (the plain twin)."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != b"FCS1":
                raise ValueError(f"{path}: bad magic {magic!r}")
            json_len = int(np.frombuffer(f.read(4), np.uint32)[0])
            self.header = json.loads(f.read(json_len).decode())
        labels_off = 8 + json_len
        self.n = self.header["n"]
        self.shape = tuple(self.header["shape"])
        self.extra_fields = {k: tuple(v) for k, v in
                             self.header.get("extra_fields", {}).items()}
        self.record_bytes = self.header["record_bytes"]
        self._native = None
        if use_native:
            self._native = _load_lib().fcs_open(path.encode())
            if not self._native:
                raise RuntimeError(f"fcs_open could not map {path}")
        else:
            self._labels = np.memmap(path, np.int32, "r", offset=labels_off,
                                     shape=(self.n,))
            self._payload = np.memmap(path, np.uint8, "r", offset=labels_off + 4 * self.n,
                                      shape=(self.n, self.record_bytes))

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def gather(self, indices: np.ndarray, n_threads: int = 4) -> Tuple[dict, np.ndarray]:
        """indices (B,) → ({'target': (B,) + shape, extras...}, labels (B,))."""
        idx = np.ascontiguousarray(indices, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"shard index out of range [0, {self.n})")
        B = idx.shape[0]
        raw = np.empty((B, self.record_bytes), np.uint8)
        labels = np.empty((B,), np.int32)
        if self._native is not None:
            _load_lib().fcs_gather(self._native, idx.ctypes.data_as(ctypes.c_void_p), B,
                                   raw.ctypes.data_as(ctypes.c_void_p),
                                   labels.ctypes.data_as(ctypes.c_void_p), n_threads)
        else:
            raw[:] = self._payload[idx]
            labels[:] = self._labels[idx]
        return self._split(raw), labels

    def _split(self, raw: np.ndarray) -> dict:
        B = raw.shape[0]
        flat = raw.view(np.float32).reshape(B, -1)
        main = int(np.prod(self.shape))
        out = {"target": flat[:, :main].reshape((B,) + self.shape)}
        off = main
        for name, shp in self.extra_fields.items():
            sz = int(np.prod(shp))
            out[name] = flat[:, off:off + sz].reshape((B,) + shp)
            off += sz
        return out

    def close(self):
        if self._native is not None:
            _load_lib().fcs_close(self._native)
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShardDataset:
    """``Loader`` dataset over one shard: the ``Loader`` takes whole batches
    from one gather (``get_batch``, keys ``target``, ``class_cond`` and for
    triplets ``source`` and ``mask_pixels``); ``get`` reads one item as
    ``PreEncodedDataset`` gives it."""

    def __init__(self, path: str, n_classes: int = 0, use_native: bool = True):
        self.reader = ShardReader(path, use_native=use_native)
        self.n_classes = n_classes
        self.is_inpainting = "source_latents" in self.reader.extra_fields

    def __len__(self):
        return self.reader.n

    def get_batch(self, indices: np.ndarray) -> dict:
        fields, labels = self.reader.gather(indices)
        batch = {"target": fields["target"], "class_cond": labels}
        if "source_latents" in fields:
            batch["source"] = fields["source_latents"]
        if "mask_pixels" in fields:
            batch["mask_pixels"] = fields["mask_pixels"]
        return batch

    def get(self, i: int, rng):
        fields, labels = self.reader.gather(np.asarray([i]))
        data = {k: v[0] for k, v in fields.items()}
        if self.is_inpainting:
            data["target_latents"] = data.pop("target")
            return data, labels[0]
        return data["target"], labels[0]
