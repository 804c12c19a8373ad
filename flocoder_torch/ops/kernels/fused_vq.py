"""Python side of the hand-written Hopper kernels of the codec's compression
tail and residual VQ, all in ``flocoder_torch/csrc/fused_vq.cu``:

- K4, launched by ``fused_compress_vq`` (a ``FusedCompressVQ``): replaces the
  Pallas TPU kernel ``flocoder_tpu/ops/pallas/fused_vq.py:_kernel``;
- K3, launched by ``fused_compress_tail_vq`` (a ``FusedCompressTailVQ``)
  on fp32 ``h`` and by ``fused_compress_tail_vq_bf16`` (its bf16 case, a
  ``FusedCompressTailVQBF16``, counted apart) on bf16 ``h``: replaces
  ``fused_vq.py:_tail_kernel``;
- K5, launched by ``compress_tail_debug`` (a ``CompressTailDebug``): replaces
  ``benchmarks/fused_probe.py:dbg_kernel``.

Each wrapper validates its inputs and raises on what its kernel does not
take, in this order: a dtype other than float32 (``TypeError``; K3's bf16
case takes bf16 ``h`` and float32 for everything else), shapes that
disagree, a D that the source does not instantiate (``BUILT_D``: the latent
widths of the repo's configs) or groups that do not divide D, a tensor that
is not contiguous, and a tensor that is not on one CUDA device
(``ValueError``). Then it builds the library at first use, allocates the
outputs and launches on PyTorch's current stream. K3 and K5 run a cluster
of blocks per image, each block a band of rows; ``plan_bands`` works out
that plan here, where the CPU tests check it, and the C entry checks it
again. The C entry alone sizes shared memory: a band or codebooks too large
for one block's shared memory come back as its ``kErrSharedMemory`` code,
raised here as a ``ValueError``. Each launch that the entry reports adds
one to the wrapper's ``launches``. The plain twins and the dispatch by
device are in ``flocoder_torch.ops.fused_vq``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import Kernel

__all__ = ["FusedCompressVQ", "FusedCompressTailVQ", "FusedCompressTailVQBF16",
           "CompressTailDebug", "fused_compress_vq", "fused_compress_tail_vq",
           "fused_compress_tail_vq_bf16", "compress_tail_debug",
           "plan_bands", "band_layout", "BUILT_D", "CLUSTER_SIZES"]

BUILT_D = (3, 4, 8)       # FUSED_VQ_CASES in the source
_ERR_SHARED_MEMORY = -1   # kErrSharedMemory in the source
TAIL_THREADS = 128        # kThreads in the source
TOKENS_PER_GROUP = 2      # kTok in the source: tokens a lane group searches at once
CLUSTER_SIZES = (1, 2, 4, 8)   # 8: the portable limit of a cluster
_SOURCE = "fused_vq.cu"
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _check(kernel: str, shapes: dict, tensors: dict, D: int, groups: int,
           h_dtype: torch.dtype = torch.float32) -> None:
    """dtype (``h`` in ``h_dtype``, every other tensor float32), then each
    tensor's shape against ``shapes`` (None: any size), then D and groups,
    then contiguity (``h`` may also be an NHWC view of NCHW memory), then
    one CUDA device."""
    for name, t in tensors.items():
        want = h_dtype if name == "h" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{kernel} kernel: {name} has dtype {t.dtype}; it takes "
                            f"{str(want).removeprefix('torch.')}")
    for name, t in tensors.items():
        want = shapes[name]
        if t.dim() != len(want) or any(w is not None and s != w
                                       for s, w in zip(t.shape, want)):
            raise ValueError(f"{kernel} kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple('*' if w is None else w for w in want)}")
        if min(t.shape) < 1:
            raise ValueError(f"{kernel} kernel: {name} is empty {tuple(t.shape)}")
    if D not in BUILT_D:
        raise ValueError(f"{kernel} kernel: D={D}; csrc/fused_vq.cu is built for D in "
                         f"{BUILT_D}, the configs' latent widths (others: ROADMAP.md)")
    if groups < 1 or D % groups:
        raise ValueError(f"{kernel} kernel: groups={groups} does not divide D={D}")
    for name, t in tensors.items():
        if not (t.is_contiguous() or (name == "h" and _nchw_memory(t))):
            raise ValueError(f"{kernel} kernel: {name} is not contiguous")
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, not a CUDA device")
        if t.device != dev:
            raise ValueError(f"{kernel} kernel: its inputs are on different devices")


def _nchw_memory(h: torch.Tensor) -> bool:
    return h.dim() == 4 and h.permute(0, 3, 1, 2).is_contiguous()


def plan_bands(H: int, W: int, cluster: int | None = None, batch: int = 1,
               sms: int = 132) -> tuple:
    """K3's and K5's launch plan for ``batch`` H×W maps on a card of ``sms``
    SMs: ``(cluster, rows, lanes)``. Each image gets a cluster of
    ``cluster`` blocks (1, 2, 4 or 8); by default the most for which the
    blocks come to at most two an SM (batch·cluster ≤ 2·sms) and no more
    than the map has rows: 8 at the pre-encode batch of 32, the fastest
    there (PERF.md §6 times every size). Block ``rank`` owns rows ``[rank·rows, (rank + 1)·rows)`` clipped to the map,
    so the last bands may be short or empty (``band_layout``). ``lanes``
    lanes (a power of two up to 32) search each group of TOKENS_PER_GROUP
    tokens: the most for which a full band's tokens fit the block's threads
    in one pass."""
    if cluster is None:      # double while the doubled grid stays within 2·sms
        cluster = 1
        while cluster < CLUSTER_SIZES[-1] and cluster < H and cluster * batch <= sms:
            cluster *= 2
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster={cluster}; K3 and K5 take a cluster of {CLUSTER_SIZES} blocks")
    rows = -(-H // cluster)
    lanes = 1
    while lanes < 32 and 2 * lanes * rows * W <= TAIL_THREADS * TOKENS_PER_GROUP:
        lanes *= 2
    return cluster, rows, lanes


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def band_layout(H: int, cluster: int, rows: int) -> list:
    """Each block's band as the kernel derives it from the plan: ``(first
    row, end row, rank holding the row above, rank holding the row below)``,
    a rank of -1 where the band meets the image's edge (its halo row is
    zero) or the band is empty."""
    out = []
    for rank in range(cluster):
        r0 = min(H, rank * rows)
        r1 = min(H, r0 + rows)
        live = r1 > r0
        out.append((r0, r1, rank - 1 if live and r0 > 0 else -1,
                    rank + 1 if live and r1 < H else -1))
    return out


def _launch(kernel: Kernel, fn, args: list, staged: str) -> None:
    """Calls the C entry ``fn``; counts the launch if it reports one, else
    raises: ``ValueError`` when ``staged`` does not fit in one block's
    shared memory, ``RuntimeError`` on any other error."""
    err = fn(*args)
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(f"{kernel._entry} kernel: {staged} do not fit in one "
                         "block's shared memory")
    if err != 0:
        raise RuntimeError(f"{kernel._entry} kernel launch failed: cudaError {err} "
                           f"({staged})")
    kernel.launches += 1


class FusedCompressVQ(Kernel):
    """Launches K4: ``fused_compress_vq(z, w, b, codebooks) -> (z_q, idx)``
    with z (N, Din), w (Din, D), b (D,), codebooks (L, K, D); z_q (N, D)
    fp32 and idx (N, L) int32."""

    _source = _SOURCE
    _entry = "fused_compress_vq"
    _argtypes = [_P] * 6 + [_LL] + [_I] * 4 + [_P]

    def __call__(self, z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 codebooks: torch.Tensor) -> tuple:
        N, Din = z.shape if z.dim() == 2 else (None, None)
        D = w.shape[-1]
        _check(self._entry, {"z": (None, None), "w": (Din, D), "b": (D,),
                             "codebooks": (None, None, D)},
               dict(z=z, w=w, b=b, codebooks=codebooks), D, 1)
        L, K = codebooks.shape[:2]
        fn = self.build()
        z_q = torch.empty(N, D, device=z.device, dtype=torch.float32)
        idx = torch.empty(N, L, device=z.device, dtype=torch.int32)
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            _launch(self, fn, [z.data_ptr(), w.data_ptr(), b.data_ptr(),
                               codebooks.data_ptr(), z_q.data_ptr(), idx.data_ptr(),
                               N, Din, D, L, K, stream],
                    f"w ({Din}x{D}) and the {L}x{K} codebooks")
        return z_q, idx


def _tail_inputs(kernel: str, h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                 groups: int, codebooks=None, h_dtype=torch.float32) -> tuple:
    """Validates K3's or K5's inputs; returns (B, H, W, Din, D, image
    stride, channel stride, pixel stride) with h read as
    h[b·sb + c·sc + p·sp], p = y·W + x."""
    B, H, W, Din = h.shape if h.dim() == 4 else (None,) * 4
    D = w1.shape[0]
    tensors = dict(h=h, w1=w1, b1=b1, gn_scale=gn_scale, gn_bias=gn_bias,
                   conv_w=conv_w, conv_b=conv_b)
    shapes = {"h": (None,) * 4, "w1": (D, Din, 1, 1), "b1": (D,), "gn_scale": (D,),
              "gn_bias": (D,), "conv_w": (D, D, 3, 3), "conv_b": (D,)}
    if codebooks is not None:
        tensors["codebooks"] = codebooks
        shapes["codebooks"] = (None, None, D)
    _check(kernel, shapes, tensors, D, groups, h_dtype)
    if h.is_contiguous():                       # NHWC memory
        strides = (H * W * Din, 1, Din)
    else:                                       # an NHWC view of NCHW memory
        strides = (Din * H * W, H * W, 1)
    return (B, H, W, Din, D) + strides


class FusedCompressTailVQ(Kernel):
    """Launches K3: ``fused_compress_tail_vq(h, w1, b1, gn_scale, gn_bias,
    conv_w, conv_b, codebooks, groups, eps) -> (z_q (B, H, W, D), idx (B, H,
    W, L) int32)``. ``h`` is (B, H, W, Din), either contiguous NHWC or an
    NHWC view of contiguous NCHW memory (what ``permute(0, 2, 3, 1)`` of the
    codec's NCHW activations gives; read without a copy, coalesced); ``w1``
    and ``conv_w`` are the 1×1 and 3×3 convolutions' OIHW weights, (D, Din,
    1, 1) and (D, D, 3, 3). A cluster of ``cluster`` blocks per image
    (``plan_bands``; by default its choice). h and z_q are float32 here,
    bfloat16 in ``FusedCompressTailVQBF16``."""

    _source = _SOURCE
    _entry = "fused_compress_tail_vq"
    _argtypes = [_P, _LL, _LL, _LL] + [_I] * 7 + [_P] * 7 + [_I] * 4 + [_F, _P, _P, _P]
    h_dtype = torch.float32

    def __call__(self, h, w1, b1, gn_scale, gn_bias, conv_w, conv_b, codebooks,
                 groups: int, eps: float = 1e-5, cluster: int | None = None) -> tuple:
        B, H, W, Din, D, sb, sc, sp = _tail_inputs(
            self._entry, h, w1, b1, gn_scale, gn_bias, conv_w, conv_b, groups,
            codebooks, self.h_dtype)
        L, K = codebooks.shape[:2]
        cs, rows, lanes = plan_bands(H, W, cluster, B, _sm_count(h.device))
        fn = self.build()
        z_q = torch.empty(B, H, W, D, device=h.device, dtype=self.h_dtype)
        idx = torch.empty(B, H, W, L, device=h.device, dtype=torch.int32)
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            _launch(self, fn, [h.data_ptr(), sb, sc, sp, B, H, W, Din, cs, rows, lanes,
                               w1.data_ptr(), b1.data_ptr(), gn_scale.data_ptr(),
                               gn_bias.data_ptr(), conv_w.data_ptr(),
                               conv_b.data_ptr(), codebooks.data_ptr(), D, L, K,
                               groups, float(eps), z_q.data_ptr(), idx.data_ptr(),
                               stream],
                    f"an image's {H}x{W}x{D} map in bands of {rows} rows over a cluster "
                    f"of {cs}, Din={Din} and the {L}x{K} codebooks")
        return z_q, idx


class FusedCompressTailVQBF16(FusedCompressTailVQ):
    """K3's bf16 case: ``h`` bf16 (the activations of a bf16 codec), widened
    to fp32 where the kernel reads it; the weights and codebooks float32;
    z_q bf16 (the fp32 sum of the picked codes rounded to nearest even),
    idx int32. Its launches are counted apart from the fp32 case's."""

    _entry = "fused_compress_tail_vq_bf16"
    h_dtype = torch.bfloat16


class CompressTailDebug(Kernel):
    """Launches K5: ``compress_tail_debug(h, w1, b1, gn_scale, gn_bias,
    conv_w, conv_b, groups, eps) -> (y1, y2, out)``, K3's tail without the
    search: each (B·H·W, D) fp32, after the 1×1, after GroupNorm + SiLU and
    after the 3×3. Inputs and ``cluster`` as ``FusedCompressTailVQ``."""

    _source = _SOURCE
    _entry = "compress_tail_debug"
    _argtypes = [_P, _LL, _LL, _LL] + [_I] * 7 + [_P] * 6 + [_I] * 2 + [_F] + [_P] * 4

    def __call__(self, h, w1, b1, gn_scale, gn_bias, conv_w, conv_b,
                 groups: int, eps: float = 1e-5, cluster: int | None = None) -> tuple:
        B, H, W, Din, D, sb, sc, sp = _tail_inputs(
            self._entry, h, w1, b1, gn_scale, gn_bias, conv_w, conv_b, groups)
        cs, rows, lanes = plan_bands(H, W, cluster, B, _sm_count(h.device))
        fn = self.build()
        y1, y2, out = (torch.empty(B * H * W, D, device=h.device, dtype=torch.float32)
                       for _ in range(3))
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            _launch(self, fn, [h.data_ptr(), sb, sc, sp, B, H, W, Din, cs, rows, lanes,
                               w1.data_ptr(), b1.data_ptr(), gn_scale.data_ptr(),
                               gn_bias.data_ptr(), conv_w.data_ptr(),
                               conv_b.data_ptr(), D, groups, float(eps),
                               y1.data_ptr(), y2.data_ptr(), out.data_ptr(), stream],
                    f"an image's {H}x{W}x{D} map in bands of {rows} rows over a cluster "
                    f"of {cs} and Din={Din}")
        return y1, y2, out


fused_compress_vq = FusedCompressVQ()
fused_compress_tail_vq = FusedCompressTailVQ()
fused_compress_tail_vq_bf16 = FusedCompressTailVQBF16()
compress_tail_debug = CompressTailDebug()
