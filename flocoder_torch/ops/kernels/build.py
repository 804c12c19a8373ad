"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``flocoder_torch/csrc/`` with a plain C
interface; sources may include the shared headers (``*.cuh``) beside them.
It is compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``flocoder_torch/build/`` and loaded with ``ctypes``.
The library's file name carries a hash of its source, every header under
``csrc/`` and the flags, so an edited source or header is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "library_path",
           "build_library", "Kernel"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` when CUDA_HOME is set, else ``nvcc`` on PATH,
    else the toolkit's default install location. Raises if none exists."""
    home = os.environ.get("CUDA_HOME")
    if home:
        cands = [os.path.join(home, "bin", "nvcc")]
    else:
        cands = [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (searched %s): the CUDA kernels of flocoder_torch are "
        "built at first use and need the CUDA toolkit" % [c for c in cands if c])


def library_path(source: str, build_dir: str = BUILD_DIR,
                 csrc_dir: str = CSRC_DIR) -> str:
    """``<build_dir>/lib<stem>_<hash>.so``, the hash over ``<csrc_dir>/<source>``,
    every ``*.cuh`` header in ``csrc_dir`` (by name, in sorted order) and the
    nvcc flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(csrc_dir) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:12]}.so")


def build_library(source: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``csrc/<source>`` into ``library_path(source, build_dir)``
    unless that file already exists; returns its path. Raises RuntimeError
    when nvcc is missing or fails."""
    src = os.path.join(CSRC_DIR, source)
    out = library_path(source, build_dir)
    if os.path.isfile(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


class Kernel:
    """One C entry point of a kernel library: the library is built at first
    use and the entry bound with ctypes. ``launches`` counts kernel launches
    (nothing else adds to it), so a run can show that it went through the
    kernel. Entries that share a source share one library file."""

    _source = ""
    _entry = ""
    _argtypes: list = []

    def __init__(self, build_dir: str = BUILD_DIR):
        self.build_dir = build_dir
        self.launches = 0
        self._fn = None

    def build(self):
        """Compile (if needed) and load the kernel library; returns its C
        entry point. Raises RuntimeError when it cannot be built."""
        if self._fn is None:
            lib = ctypes.CDLL(build_library(self._source, self.build_dir))
            fn = getattr(lib, self._entry)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
