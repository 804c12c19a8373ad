"""Python side of the hand-written Hopper NA2D kernels:

- K1, the forward (``flocoder_torch/csrc/na2d_fwd.cu``; replaces the Pallas
  TPU kernel ``flocoder_tpu/ops/pallas/na2d.py:_na2d_kernel``), launched by
  ``na2d_fwd`` (an ``NA2DForward``);
- K2, the backward (``flocoder_torch/csrc/na2d_bwd.cu``; replaces
  ``_na2d_bwd_kernel`` of the same file), launched by ``na2d_bwd`` (an
  ``NA2DBackward``).

Both kernels run on the tensor cores (``mma.sync``; see
``csrc/na2d_mma.cuh``): one warp owns a 4×4 patch of queries (K1, K2's first
pass) or of keys (K2's second pass), the M=16 rows of one ``mma`` tile.

The launch plan is worked out here, once per shape (``plan_queries``,
``plan_keys``; cached), and handed to the C entries, which only check that
their shared-memory layout fits the bytes the plan gives them. Each wrapper
validates its inputs, builds its kernel at first use, allocates the outputs
and launches on PyTorch's current stream. The plain twins are
``na2d_banded`` and ``na2d_bwd_banded`` in
``flocoder_torch.ops.neighborhood_attention``; the dispatcher there sends CPU
tensors to the twins and CUDA tensors here, through ``NA2DFunction``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .build import Kernel

__all__ = ["NA2DForward", "NA2DBackward", "na2d_fwd", "na2d_bwd",
           "QueryPlan", "KeyPlan", "query_plans", "key_plans", "plan_queries",
           "plan_keys", "window_start",
           "q_lo", "q_hi", "KS_MAX", "DH_MAX", "COL_SLICE"]

KS_MAX = 7               # the key union of a 4×4 patch, (3+ks)², fits 14 n8 tiles
DH_MAX = 256             # widest head slice the kernels take
# Widest column slice of dh a warp's output accumulators hold at once
# (``kColSlice`` in csrc/na2d_mma.cuh): a wider head forms its P·V-type
# products (K1's output, K2's dq, dk, dv) in slices of this many columns,
# so that the registers a lane takes stay those of dh 128.
COL_SLICE = 128
PATCH = 4                # a warp's patch: PATCH × PATCH = 16 rows of an mma tile
_MAX_WARPS = 8
_SMEM_BLOCK = 227 * 1024     # one block's dynamic shared memory at most
_SMEM_SM = 228 * 1024        # one SM's, of which each block also reserves 1 KB
_MAX_THREADS_SM = 2048
_REGS_SM = 65536
# Registers a thread of each kernel may hold: K1 and K2's first pass are
# built for two blocks of 8 warps (``__launch_bounds__(256, 2)``); K2's
# second pass keeps dK, dV and a chunk's Sᵀ and dPᵀ and takes up to 255.
_REGS_QUERY, _REGS_KEY = 128, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def window_start(i: int, n: int, ks: int) -> int:
    """First row (or column) of the clamped window of query ``i`` on an axis
    of length ``n``."""
    return min(max(i - ks // 2, 0), n - ks)


def q_lo(j: int, ks: int) -> int:
    """First query on an axis whose clamped window holds key ``j`` (as
    ``q_lo`` in csrc/na2d_mma.cuh)."""
    return 0 if j <= ks - 1 else j - ks + 1 + ks // 2


def q_hi(j: int, n: int, ks: int) -> int:
    """Last query on an axis of length ``n`` whose clamped window holds key
    ``j`` (as ``q_hi`` in csrc/na2d_mma.cuh)."""
    return n - 1 if j >= n - ks else j + ks // 2


def row_bytes(dh: int, bf16: bool) -> int:
    """Bytes of one pixel's head slice in shared memory: fp32 rows padded to
    dh + 4 floats, bf16 rows to the k16-padded dh + 8 values (the zero pad
    feeds the k16 steps where dh is not a multiple of 16). Either stride is
    an odd multiple of 16 bytes, so the eight rows an ``mma`` fragment
    reads hit disjoint banks, and a multiple of 16 bytes, as ``cp.async``
    needs."""
    if bf16:
        return (-(-dh // 16) * 16 + 8) * 2
    return (dh + 4) * 4


def key_table(ks: int, bf16: bool) -> int:
    """Entries of a warp's key table in K1 and K2's first pass: the (3+ks)²
    keys of a 4×4 query patch's window union, padded to whole k-steps of
    the P·V product (8 keys in TF32, 16 in bf16)."""
    step = 16 if bf16 else 8
    return -(-(ks + PATCH - 1) ** 2 // step) * step


def query_chunk(dh: int) -> int:
    """Queries per chunk of K2's second pass (``kQueryChunk`` in
    csrc/na2d_bwd.cu): 32, four n8 tiles, so that a chunk's Sᵀ and dPᵀ (32
    registers a lane) sit beside one column slice of dK and dV
    (2·min(dh, COL_SLICE)/8·4); a head of 256 walks its chunks once per
    slice."""
    return 32


def _axis_query_union(n: int, ks: int, lo: int, hi: int) -> int:
    """Length of the query union of the keys lo..hi on one axis."""
    return q_hi(min(hi, n - 1), n, ks) - q_lo(lo, ks) + 1


def _tiles(H: int, W: int):
    """Block tiles (tile_h, tile_w): whole patches, 1 to 8 warps, no larger
    than the map rounded up to whole patches."""
    for th in range(PATCH, -(-H // PATCH) * PATCH + 1, PATCH):
        for tw in range(PATCH, -(-W // PATCH) * PATCH + 1, PATCH):
            if (th // PATCH) * (tw // PATCH) <= _MAX_WARPS:
                yield th, tw


def _residency(smem: int, warps: int, regs: int) -> tuple:
    """(blocks, warps) that shared memory, the thread limit and ``regs``
    registers a thread let one SM hold."""
    blocks = min(_SMEM_SM // (smem + 1024), _MAX_THREADS_SM // (32 * warps),
                 _REGS_SM // (regs * 32 * warps))
    return blocks, blocks * warps


class QueryPlan(NamedTuple):
    """Launch plan of K1 and of K2's first pass: a block owns a tile_h ×
    tile_w query tile (one warp per 4×4 patch) and stages the tile's K and V
    halo (halo_h × halo_w pixels); with ``two_buf`` both halos are resident
    at once, else the second follows the first through one buffer.
    ``smem``: bytes of one block (the halos, then each warp's key table of
    ``table`` entries of 8 bytes)."""
    tile_h: int
    tile_w: int
    halo_h: int
    halo_w: int
    two_buf: int
    table: int
    smem: int


class KeyPlan(NamedTuple):
    """Launch plan of K2's second pass: a block owns a tile_h × tile_w key
    tile (one warp per 4×4 patch) and stages q, g, the log-sum-exp and δ
    of the widest query halo any tile has (span_h × span_w pixels). Each warp walks its patch's query union (at most
    ``table`` queries, a whole number of ``chunk``-query chunks) from a
    table of 8-byte entries. ``smem``: bytes of one block."""
    tile_h: int
    tile_w: int
    span_h: int
    span_w: int
    chunk: int
    table: int
    smem: int


def _check_plan_args(H: int, W: int, dh: int, ks: int) -> None:
    if not (1 <= ks <= min(KS_MAX, H, W)):
        raise ValueError(f"na2d kernel: window {ks} must be within 1..{KS_MAX} "
                         f"and the map {H}x{W}")
    if dh % 8 or not 8 <= dh <= DH_MAX:
        raise ValueError(f"na2d kernel: head dim {dh} must be a multiple of 8 "
                         f"up to {DH_MAX}")


def query_plans(H: int, W: int, dh: int, ks: int, bf16: bool):
    """Every launch plan of K1 (and of K2's first pass) that fits one
    block's shared memory, with its score (lower is better): at least 8
    resident warps and 2 blocks an SM (so that one block's loads overlap
    another's math), then the fewest halo pixels staged over the map (each
    a read of 2·dh values), then one buffer (less shared memory), then more
    warps. Chosen by timing every plan (benchmarks/na2d_plan_sweep.py)."""
    _check_plan_args(H, W, dh, ks)
    rb = row_bytes(dh, bf16)
    table = key_table(ks, bf16)
    for th, tw in _tiles(H, W):
        warps = (th // PATCH) * (tw // PATCH)
        hh, hw = min(th + ks - 1, H), min(tw + ks - 1, W)
        staged = -(-H // th) * -(-W // tw) * hh * hw
        for two in (1, 0):
            smem = (1 + two) * hh * hw * rb + warps * table * 8
            if smem <= _SMEM_BLOCK:
                blocks, resident = _residency(smem, warps, _REGS_QUERY)
                yield ((-min(resident, 8), -min(blocks, 2), staged, two, -warps),
                       QueryPlan(th, tw, hh, hw, two, table, smem))


@functools.lru_cache(maxsize=None)
def plan_queries(H: int, W: int, dh: int, ks: int, bf16: bool) -> QueryPlan:
    """The best of ``query_plans`` for K1 (and K2's first pass). Cached: the
    search takes longer on the host than a launch takes on the card."""
    best = min(query_plans(H, W, dh, ks, bf16), default=None)
    if best is None:
        raise ValueError(f"na2d kernel: a {ks}x{ks} window at dh={dh} does not "
                         "fit in shared memory")
    return best[1]


def _max_span(n: int, t: int, ks: int) -> int:
    """Widest query union of the key tiles of length ``t`` on one axis."""
    return max(_axis_query_union(n, ks, r0, r0 + t - 1) for r0 in range(0, n, t))


def key_plans(H: int, W: int, dh: int, ks: int, bf16: bool):
    """Every launch plan of K2's second pass that fits one block's shared
    memory, with its score (lower is better): at least 8 resident warps,
    then in bf16 2 blocks an SM and in fp32 8 warps a block (the timings of
    benchmarks/na2d_plan_sweep.py differ so between the two), then the
    fewest query-halo pixels staged across the map (each a read of 2·dh
    values), then more warps."""
    _check_plan_args(H, W, dh, ks)
    rb = row_bytes(dh, bf16)
    chunk = query_chunk(dh)
    patch_q = (max(_axis_query_union(H, ks, p, p + PATCH - 1) for p in range(0, H, PATCH))
               * max(_axis_query_union(W, ks, p, p + PATCH - 1) for p in range(0, W, PATCH)))
    table = -(-patch_q // chunk) * chunk
    for th, tw in _tiles(H, W):
        warps = (th // PATCH) * (tw // PATCH)
        sh, sw = _max_span(H, th, ks), _max_span(W, tw, ks)
        smem = sh * sw * (2 * rb + 8) + warps * table * 8
        if smem <= _SMEM_BLOCK:
            staged = (sum(_axis_query_union(H, ks, r0, r0 + th - 1) for r0 in range(0, H, th))
                      * sum(_axis_query_union(W, ks, c0, c0 + tw - 1) for c0 in range(0, W, tw)))
            blocks, resident = _residency(smem, warps, _REGS_KEY)
            yield ((-min(resident, 8), -(min(blocks, 2) if bf16 else warps), staged, -warps),
                   KeyPlan(th, tw, sh, sw, chunk, table, smem))


@functools.lru_cache(maxsize=None)
def plan_keys(H: int, W: int, dh: int, ks: int, bf16: bool) -> KeyPlan:
    """The best of ``key_plans`` for K2's second pass. Cached."""
    best = min(key_plans(H, W, dh, ks, bf16), default=None)
    if best is None:
        raise ValueError(f"na2d backward kernel: a {ks}x{ks} window at dh={dh} "
                         "does not fit in shared memory")
    return best[1]


def _window(q: torch.Tensor, kernel_size: int, heads: int,
            scale: Optional[float]) -> tuple:
    B, H, W, C = q.shape
    dh = C // heads
    ks = min(kernel_size, H, W)
    if ks < 1:
        raise ValueError(f"na2d kernel: kernel_size must be >= 1, got {kernel_size}")
    return B, H, W, dh, ks, dh ** -0.5 if scale is None else scale


class NA2DForward(Kernel):
    """Launches K1: ``na2d_fwd(q, k, v, kernel_size, heads, scale) -> out``."""

    _source = "na2d_fwd.cu"
    _entry = "na2d_fwd"
    _argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                 + [ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kernel_size: int = 7, heads: int = 8,
                 scale: Optional[float] = None) -> torch.Tensor:
        _check(heads, q=q, k=k, v=v)
        B, H, W, dh, ks, scale = _window(q, kernel_size, heads, scale)
        p = plan_queries(H, W, dh, ks, q.dtype == torch.bfloat16)
        fn = self.build()
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            self.launches += 1
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _DTYPES[q.dtype], B, H, W, heads, dh, ks, p.tile_h, p.tile_w,
                     p.halo_h, p.halo_w, p.two_buf, p.smem, float(scale), stream)
        if err != 0:
            raise RuntimeError(f"na2d kernel launch failed: cudaError {err} "
                               f"(shape {tuple(q.shape)}, heads {heads}, plan {p})")
        return out


class NA2DBackward(Kernel):
    """Launches K2: ``na2d_bwd(q, k, v, o, g, kernel_size, heads, scale) ->
    (dq, dk, dv)``, with ``o`` K1's output for (q, k, v) and ``g`` the
    gradient of the loss with respect to it. One call is one launch of the
    kernel, which runs as two grid passes on the stream (dq over query tiles
    by ``plan_queries``, then dk and dv over key tiles by ``plan_keys``);
    the wrapper allocates their fp32 scratch (log-sum-exp and δ, one value
    per pixel and head)."""

    _source = "na2d_bwd.cu"
    _entry = "na2d_bwd"
    _argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 20
                 + [ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, g: torch.Tensor, kernel_size: int = 7,
                 heads: int = 8, scale: Optional[float] = None) -> tuple:
        _check(heads, q=q, k=k, v=v, o=o, g=g)
        B, H, W, dh, ks, scale = _window(q, kernel_size, heads, scale)
        bf16 = q.dtype == torch.bfloat16
        p1 = plan_queries(H, W, dh, ks, bf16)
        p2 = plan_keys(H, W, dh, ks, bf16)
        fn = self.build()
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        lse, delta = (torch.empty(B, H, W, heads, device=q.device,
                                  dtype=torch.float32) for _ in range(2))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            self.launches += 1
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], B, H,
                     W, heads, dh, ks, p1.tile_h, p1.tile_w, p1.halo_h, p1.halo_w,
                     p1.two_buf, p1.smem, p2.tile_h, p2.tile_w, p2.span_h,
                     p2.span_w, p2.chunk, p2.table, p2.smem, float(scale), stream)
        if err != 0:
            raise RuntimeError(f"na2d backward kernel launch failed: cudaError "
                               f"{err} (shape {tuple(q.shape)}, heads {heads}, "
                               f"plans {p1}, {p2})")
        return dq, dk, dv


def _check(heads: int, **tensors) -> None:
    q = tensors["q"]
    names = ", ".join(tensors)
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"na2d kernel: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"na2d kernel: {names} are on different devices")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"na2d kernel: {name} has dtype {t.dtype}; {names} "
                            "must all be float32 or all bfloat16")
        if t.dim() != 4 or tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"na2d kernel: {name} has shape {tuple(t.shape)}; "
                             f"{names} must share one NHWC (B, H, W, C) shape")
        if not t.is_contiguous():
            raise ValueError(f"na2d kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"na2d kernel: {name} does not start on a 16-byte "
                             "boundary, which the kernels' 16-byte copies need")
    C = q.shape[-1]
    if heads < 1 or C % heads:
        raise ValueError(f"na2d kernel: C={C} is not divisible by heads={heads}")
    dh = C // heads
    if dh % 8 or dh > DH_MAX:
        raise ValueError(f"na2d kernel: head dim {dh} must be a multiple of 8 "
                         f"and at most {DH_MAX}")
    if min(q.shape) < 1:
        raise ValueError(f"na2d kernel: empty input {tuple(q.shape)}")


na2d_fwd = NA2DForward()
na2d_bwd = NA2DBackward()
