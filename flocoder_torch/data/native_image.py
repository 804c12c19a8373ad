"""Native (C++) image decode + resize, the port's own copy of
``flocoder_tpu/data/native_image.py``.

Wraps ``csrc/fcimage.cpp`` (libjpeg/libpng decode and PIL's triangle
resample, with a threaded batch API) behind ctypes, so that a loader thread
gets a finished (S, S, 3) uint8 image without PIL's decode; ctypes drops the
GIL for the C calls, so the ``Loader``'s item pool decodes in parallel. The
library is built with g++ at first use into ``flocoder_torch/build/``
(``ops/kernels/build.py:build_host_library``) and links ``-ljpeg -lpng``.

Where those headers or libraries are missing the build (or the load)
fails, ``available()`` is false and ``why_unavailable()`` says why;
``preencode_data`` then decodes with PIL and prints that choice (the JAX
package makes the same choice, but quietly). A per-file decode failure returns None (a redraw signal) rather
than raising.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from ..ops.kernels.build import build_host_library

__all__ = ["available", "why_unavailable", "library_file", "decode_resize",
           "decode_resize_batch", "NativeLoadResized"]

_lib = None
_lib_path = None
_why = ""
_lib_lock = threading.Lock()


def _load_lib():
    """The loaded library, or False when it does not build or load."""
    global _lib, _lib_path, _why
    with _lib_lock:
        if _lib is None:
            try:
                _lib_path = build_host_library("fcimage.cpp", libs=("-ljpeg", "-lpng"))
                lib = ctypes.CDLL(_lib_path)
            except (RuntimeError, OSError) as e:
                _why = str(e).strip().splitlines()[-1] if str(e).strip() else repr(e)
                _lib = False
                return _lib
            lib.fci_probe.restype = ctypes.c_int
            lib.fci_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
            lib.fci_decode_resize.restype = ctypes.c_int
            lib.fci_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_int]
            lib.fci_decode_resize_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the decoder library builds and loads (built on first call)."""
    return bool(_load_lib())


def why_unavailable() -> str:
    """The build's error when ``available()`` is false, else ''."""
    _load_lib()
    return _why


def library_file() -> Optional[str]:
    """The built library's path, or None when it does not build."""
    return _lib_path if _load_lib() else None


def decode_resize(path: str, size: int) -> Optional[np.ndarray]:
    """Decodes one JPEG/PNG and resamples it to (size, size, 3) uint8.
    Returns None when the file does not decode (the caller redraws)."""
    lib = _load_lib()
    if not lib:
        raise RuntimeError(f"the native image library is unavailable: {_why}")
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.fci_decode_resize(os.fspath(path).encode(),
                               out.ctypes.data_as(ctypes.c_void_p), size, size)
    return out if rc == 0 else None


def decode_resize_batch(paths: Sequence[str], size: int, n_threads: int = 8) -> tuple:
    """Threaded batch decode → ((B, size, size, 3) uint8, ok mask (B,))."""
    lib = _load_lib()
    if not lib:
        raise RuntimeError(f"the native image library is unavailable: {_why}")
    enc = [os.fspath(p).encode() + b"\0" for p in paths]
    offsets = np.cumsum([0] + [len(e) for e in enc[:-1]]).astype(np.int64)
    n = len(enc)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.empty((n,), np.int32)
    lib.fci_decode_resize_batch(b"".join(enc), offsets.ctypes.data_as(ctypes.c_void_p), n,
                                out.ctypes.data_as(ctypes.c_void_p), size, size,
                                int(n_threads), status.ctypes.data_as(ctypes.c_void_p))
    return out, status == 0


class NativeLoadResized:
    """Path-based ``device_augs.load_resized``: decode and one resize to
    ``src_size`` in C++, giving float32 (S, S, 3) in [0, 1]. ``wants_path =
    True`` makes ``ImageFolderDataset`` hand over the file path instead of a
    PIL image. A PIL image (datasets without files) takes the host resize,
    and a file the native decoder rejects (webp, for instance) takes PIL."""

    wants_path = True

    def __init__(self, src_size: int):
        self.src_size = int(src_size)

    def __call__(self, path, rng=None) -> np.ndarray:
        from .device_augs import load_resized
        if not isinstance(path, (str, os.PathLike)):
            return load_resized(path, self.src_size)
        arr = decode_resize(path, self.src_size)
        if arr is None:
            from PIL import Image
            with Image.open(path) as img:
                return load_resized(img.convert("RGB"), self.src_size)
        return arr.astype(np.float32) / 255.0
