"""Dynamic W8A8 int8 convolutions for the serving decode and the pre-encode
encode, the port of ``flocoder_tpu/ops/quant.py``.

The scheme, step by step as the JAX function computes it:

- weights: per output channel, symmetric, scale ``max|w| / 127`` floored at
  1e-12, codes ``clip(round(w / s_w), ±127)``, from the live fp32 weight, so
  any checkpoint serves unchanged;
- activations: one per-tensor scale ``s_x = max(max|x_bf| / 127, 1e-12)``
  over the input rounded to bf16, codes ``clip(round(x_bf / bf16(s_x)),
  ±127)`` computed in bf16 (every operation rounds to bf16; ``round``
  takes half to even);
- the product accumulates exactly in int32;
- the result is dequantized in fp32 as ``y · (s_x · s_w)``, plus the bias in
  fp32, then cast to the output dtype.

``int8_conv`` dispatches by device. On a CUDA tensor it unfolds the
quantized activations (an im2col, while they are still bf16: integers up to
127 are exact there, and ``F.unfold`` has no int8 path on the card), casts
them to int8 and multiplies with ``torch._int_mm`` (int8 × int8 → int32,
cuBLASLt). ``_int_mm`` takes M > 16 rows and K and N that are multiples of
8; a shape outside that raises a ``ValueError`` (there is no fallback). The
batch is cut into chunks whose bf16 im2col stays under ``IM2COL_BYTES``. On
a CPU tensor the plain twin runs: the same quantization, then ``F.conv2d``
in float64 on the codes, which is exact (|Σ| ≤ 127²·K < 2⁵³).

``QuantConv`` is a drop-in for the codecs' ``layers.Conv``: the same
parameters (``weight`` OIHW, ``bias``), so a checkpoint loads unchanged.
Where either channel count is below ``MIN_QUANT_CHANNELS`` it runs the plain
convolution in its compute dtype, as the JAX module does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.layers import Conv

__all__ = ["MIN_QUANT_CHANNELS", "IM2COL_BYTES", "quantize_weight",
           "quantize_activations", "int8_conv", "int8_conv_plain", "QuantConv",
           "conv_or_quant", "int_mm_calls"]

MIN_QUANT_CHANNELS = 32
IM2COL_BYTES = 1 << 30          # a chunk's bf16 im2col, at most


class _Calls:
    """Counts the ``torch._int_mm`` calls of ``int8_conv`` on the card."""

    def __init__(self):
        self.launches = 0


int_mm_calls = _Calls()


def _127(t: torch.Tensor) -> torch.Tensor:
    """127 as a tensor on ``t``'s device: divided by it, the quotient is
    correctly rounded on the card too (PyTorch multiplies by the reciprocal
    of a host scalar divisor there, an ulp off at times)."""
    return torch.full((), 127.0, device=t.device)


def quantize_weight(w: torch.Tensor) -> tuple:
    """OIHW weight → (int8 codes OIHW, fp32 scale per output channel)."""
    w32 = w.float()
    s_w = (w32.abs().amax(dim=(1, 2, 3)) / _127(w32)).clamp(min=1e-12)
    w_q = torch.clamp(torch.round(w32 / s_w[:, None, None, None]), -127, 127)
    return w_q.to(torch.int8), s_w


def quantize_activations(x: torch.Tensor) -> tuple:
    """Any tensor → (its codes as bf16 integers in [-127, 127], the fp32
    per-tensor scale), the arithmetic in bf16 as the JAX function's."""
    x_bf = x.to(torch.bfloat16)
    s_x = (x_bf.float().abs().amax() / _127(x)).clamp(min=1e-12)
    x_q = torch.clamp(torch.round(x_bf / s_x.to(torch.bfloat16)), -127, 127)
    return x_q, s_x


def _pads(padding, kernel: tuple, stride: tuple, size: tuple) -> tuple:
    """``padding`` (an int, per-dimension ints or (lo, hi) pairs, "SAME" or
    "VALID", as flax takes it) → F.pad's (left, right, top, bottom)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0, 0, 0)
        if padding.upper() != "SAME":
            raise ValueError(f"padding {padding!r}: an int, pairs, SAME or VALID")
        pairs = []
        for n, k, s in zip(size, kernel, stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pairs.append((total // 2, total - total // 2))
    elif isinstance(padding, int):
        pairs = [(padding, padding)] * 2
    else:
        pairs = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    (t, b), (l, r) = pairs
    return (l, r, t, b)


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def _dequant(y: torch.Tensor, s_x, s_w, bias, out_dtype) -> torch.Tensor:
    """int32-valued products (…, Cout) → fp32 · (s_x · s_w) + bias → out."""
    y = y.float() * (s_x * s_w)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_conv_plain(x, weight, bias, stride=1, padding=0, out_dtype=None):
    """The twin of ``int8_conv``: NCHW ``x``, OIHW ``weight``; the codes
    multiplied by ``F.conv2d`` in float64 (exact), then dequantized."""
    out_dtype = out_dtype or x.dtype
    kernel, stride = tuple(weight.shape[2:]), _pair(stride)
    x_q, s_x = quantize_activations(x)
    w_q, s_w = quantize_weight(weight)
    x_q = F.pad(x_q.double(), _pads(padding, kernel, stride, tuple(x.shape[2:])))
    y = F.conv2d(x_q, w_q.double(), stride=stride)
    return _dequant(y.permute(0, 2, 3, 1), s_x, s_w, bias, out_dtype).permute(0, 3, 1, 2)


def _int8_conv_card(x, weight, bias, stride, padding, out_dtype):
    kernel, stride = tuple(weight.shape[2:]), _pair(stride)
    cout = weight.shape[0]
    x_q, s_x = quantize_activations(x)
    w_q, s_w = quantize_weight(weight)
    x_q = F.pad(x_q, _pads(padding, kernel, stride, tuple(x.shape[2:])))
    B, cin, Hp, Wp = x_q.shape
    Ho = (Hp - kernel[0]) // stride[0] + 1
    Wo = (Wp - kernel[1]) // stride[1] + 1
    K = cin * kernel[0] * kernel[1]
    per_image = 2 * K * Ho * Wo
    chunk = max(1, min(B, IM2COL_BYTES // per_image))
    if min(chunk, B) * Ho * Wo <= 16 or K % 8 or cout % 8:
        raise ValueError(
            f"int8_conv on the card: torch._int_mm takes M > 16 rows and K, N "
            f"multiples of 8; this conv gives M={min(chunk, B) * Ho * Wo}, K={K}, "
            f"N={cout} (input {tuple(x.shape)}, weight {tuple(weight.shape)})")
    w_t = w_q.reshape(cout, K).t()                  # (K, N), column-major
    outs = []
    for b0 in range(0, B, chunk):
        xb = x_q[b0:b0 + chunk]
        cols = F.unfold(xb, kernel, stride=stride)  # (b, K, L), bf16 integers
        a = cols.transpose(1, 2).reshape(-1, K).to(torch.int8).contiguous()
        if a.shape[0] <= 16:
            raise ValueError(f"int8_conv on the card: a chunk of {a.shape[0]} rows; "
                             "torch._int_mm takes more than 16")
        y = torch._int_mm(a, w_t)
        int_mm_calls.launches += 1
        outs.append(_dequant(y, s_x, s_w, bias, out_dtype)
                    .reshape(xb.shape[0], Ho, Wo, cout))
    return torch.cat(outs).permute(0, 3, 1, 2)


def int8_conv(x, weight, bias, stride=1, padding=0, out_dtype=None):
    """W8A8 convolution of NCHW ``x`` with the OIHW ``weight`` (and
    ``bias``): codes as the module docstring gives them, an exact integer
    product, fp32 dequantization, output in ``out_dtype`` (default: x's).
    ``padding`` as flax takes it (an int, pairs, "SAME", "VALID"). A CPU
    tensor runs the float64 twin, a CUDA one the im2col and
    ``torch._int_mm``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv_plain(x, weight, bias, stride, padding, out_dtype)
    return _int8_conv_card(x, weight, bias, stride, padding, out_dtype)


class QuantConv(Conv):
    """``layers.Conv`` whose product is ``int8_conv`` where both channel
    counts are at least ``MIN_QUANT_CHANNELS``; below that the plain
    convolution in the compute dtype. The output is the compute dtype
    (None: the weight's)."""

    def forward(self, x):
        if min(self.in_channels, self.out_channels) < MIN_QUANT_CHANNELS:
            return super().forward(x)
        return int8_conv(x, self.weight, self.bias, self.stride, self.padding,
                         self.compute_dtype or self.weight.dtype)


def conv_or_quant(quant: bool, cin: int, cout: int, kernel: int, stride: int = 1,
                  padding=None, dtype=None) -> Conv:
    """A codec's convolution: ``QuantConv`` with ``quant``, else
    ``layers.Conv``; padding ``kernel // 2`` unless given, ``dtype`` the
    compute dtype (None: the parameters')."""
    c = (QuantConv if quant else Conv)(cin, cout, kernel, stride=stride,
                                       padding=kernel // 2 if padding is None else padding)
    c.compute_dtype = dtype
    return c
