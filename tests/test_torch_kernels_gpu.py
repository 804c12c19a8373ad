"""K1 and K2, the hand-written NA2D forward and backward kernels, against
their plain versions on the card. Marked ``gpu``: it skips without a CUDA device. This file imports
neither jax nor flocoder_tpu, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
from flocoder_torch.ops.neighborhood_attention import (na2d, na2d_banded,
                                                      na2d_bwd_banded)

SHAPES = [(2, 32, 32, 512, 7, 8), (2, 16, 16, 1024, 7, 8), (2, 16, 16, 128, 7, 8),
          (2, 5, 6, 32, 7, 4), (1, 17, 13, 48, 7, 2)]


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """K1 against the plain version on the card (fp32: 1e-4; bf16 against
    the plain version in fp32 on the same bf16 values: 2e-2, one bf16
    rounding of outputs of magnitude up to ~4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    for (B, H, W, C, ks, heads) in SHAPES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.randn(B, H, W, C, device="cuda", generator=g)
                       .to(dtype) for _ in range(3))
            out = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            ref = na2d_banded(q.float(), k.float(), v.float(),
                              kernel_size=ks, heads=heads)
            assert (out.float() - ref).abs().max().item() < tol


@pytest.mark.gpu
def test_backward_kernel_matches_plain_on_card():
    """K2 against its plain twin on the same inputs and K1's output (fp32:
    1e-4·max(1, max|ref|); bf16 against the twin in fp32 on the same bf16
    values: 3e-2·max(1, max|ref|)), and na2d's gradients on the card
    (K1 forward, K2 backward) against autograd of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(1)
    for (B, H, W, C, ks, heads) in SHAPES:
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g)
                           .to(dtype) for _ in range(4))
            o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            refs = na2d_bwd_banded(*(t.float() for t in (q, k, v, o, gr)),
                                   kernel_size=ks, heads=heads)
            for a, ref in zip(grads, refs):
                tol = rel * max(1.0, ref.abs().max().item())
                assert (a.float() - ref).abs().max().item() < tol
        q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g)
                       for _ in range(4))
        got = []
        for fn in (na2d, na2d_banded):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            got.append(torch.autograd.grad(fn(*leaves, kernel_size=ks, heads=heads),
                                           leaves, gr))
        for a, ref in zip(*got):
            assert (a - ref).abs().max().item() < 1e-4 * max(1.0, ref.abs().max().item())
