"""The hand-written kernels against their plain versions on the card: K1 and
K2 (the NA2D forward and backward), K3, K4 and K5 (the fused compression
tail and RVQ search). Marked ``gpu``: it skips without a CUDA device. This file imports
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


@pytest.mark.gpu
def test_fused_vq_kernels_match_twins_on_card():
    """K4, K3 and K5 against their plain twins on the card, TF32 off: picks
    equal to the twin's or ε-optimal (relative fp64 distance gap < 1e-5),
    z_q within 1e-5·max(1, max|ref|) where the picks agree, K5's
    intermediates within 1e-5·max(1, max|ref|) of the twin and of the fp64
    oracle; every D that the source instantiates; a map too large for one
    block's shared memory raises."""
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops.kernels import fused_vq as kernels
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(2)

    for N, Din, D, L, K in ((8192, 128, 4, 4, 96), (1024, 256, 4, 3, 512), (77, 16, 4, 3, 8),
                            (300, 64, 8, 2, 64), (300, 64, 3, 2, 64)):
        z, w, b, cb = fvq.random_vq_inputs(g, N, Din, D, L, K)
        zq, idx = fvq.fused_compress_vq(z, w, b, cb)
        torch.cuda.synchronize()
        res = fvq.check_quantized(zq, idx, *fvq.fused_compress_vq_plain(z, w, b, cb),
                                  z.double() @ w.double() + b.double(), cb)
        assert res["ok"], res

    for B, H, W, Din, D, L, K, groups, nchw in (
            (32, 16, 16, 128, 4, 4, 96, 2, True), (32, 16, 16, 128, 4, 4, 96, 2, False),
            (3, 5, 7, 16, 4, 3, 8, 2, True), (2, 20, 20, 16, 4, 2, 16, 2, True),
            (2, 16, 16, 32, 3, 2, 16, 1, True), (2, 16, 16, 32, 8, 2, 16, 2, True)):
        h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, D, L, K, groups, nchw)
        zq, idx = fvq.fused_compress_tail_vq(h, *tail, cb, groups)
        torch.cuda.synchronize()
        res = fvq.check_quantized(zq, idx, *fvq.fused_compress_tail_vq_plain(h, *tail, cb, groups),
                                  fvq.compress_tail_oracle(h, *tail, groups)[2], cb)
        assert res["ok"], res

    h, tail, _ = fvq.random_tail_inputs(g, 4, 16, 16, 256, 4, 1, 1, 2)
    ours = fvq.compress_tail_debug(h, *tail, 2)
    torch.cuda.synchronize()
    for a, ref, ref64 in zip(ours, fvq.compress_tail_debug_plain(h, *tail, 2),
                             fvq.compress_tail_oracle(h, *tail, 2)):
        for r in (ref, ref64):
            assert (a - r).abs().max().item() < 1e-5 * max(1.0, r.abs().max().item())

    h, tail, cb = fvq.random_tail_inputs(g, 1, 256, 256, 8, 4, 1, 4, 2)
    before = kernels.compress_tail_debug.launches
    with pytest.raises(ValueError, match="shared memory"):     # a 1 MB map
        kernels.compress_tail_debug(h, *tail, 2)
    assert kernels.compress_tail_debug.launches == before
