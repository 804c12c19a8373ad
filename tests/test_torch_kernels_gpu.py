"""The hand-written kernels against their plain versions on the card: K1 and
K2 (the NA2D forward and backward), K3, K4 and K5 (the fused compression
tail and RVQ search; K3 also on bf16 h), and the W8A8 int8 convolution
(``ops/quant.py`` over ``torch._int_mm``, not a TPU kernel) against its
float64 twin. Marked ``gpu``: it skips without a CUDA device. This file imports
neither jax nor flocoder_tpu, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
from flocoder_torch.ops.neighborhood_attention import (na2d, na2d_banded,
                                                      na2d_bwd_banded)

# (B, H, W, C, kernel_size, heads): the codec's three shapes; a map smaller
# than the window (ks 5); a ragged one; an even window (6x6 map: ks 6); a
# 33x31 map, so that 4x4 patches are ragged on both axes; a small window
# (ks 3); head dims 8 and 24, which bf16 pads to its k16 step.
SHAPES = [(2, 32, 32, 512, 7, 8), (2, 16, 16, 1024, 7, 8), (2, 16, 16, 128, 7, 8),
          (2, 5, 6, 32, 7, 4), (1, 17, 13, 48, 7, 2), (2, 6, 6, 64, 7, 4),
          (1, 33, 31, 64, 7, 2), (1, 16, 16, 64, 3, 4), (2, 12, 12, 64, 7, 8),
          (2, 12, 12, 96, 7, 4)]


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
            err = (out.float() - ref).abs().max().item()
            assert err < tol, ((B, H, W, C, ks, heads), dtype, err)


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
            for name, a, ref in zip(("dq", "dk", "dv"), grads, refs):
                tol = rel * max(1.0, ref.abs().max().item())
                err = (a.float() - ref).abs().max().item()
                assert err < tol, ((B, H, W, C, ks, heads), dtype, name, err, tol)
        q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g)
                       for _ in range(4))
        got = []
        for fn in (na2d, na2d_banded):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            got.append(torch.autograd.grad(fn(*leaves, kernel_size=ks, heads=heads),
                                           leaves, gr))
        for a, ref in zip(*got):
            assert (a - ref).abs().max().item() < 1e-4 * max(1.0, ref.abs().max().item())


# HDiT's neighborhood-attention level: flowers_hdit at patch 2 gives 8x8
# tokens of width 256 (4 heads of 64) under na:7; at patch 4, 4x4 tokens,
# where the 7x7 window is clamped to 4x4. B=32 here (the recipe's 256 and the
# evaluation's 512 run in chip_smoke.py).
HDIT_SHAPES = [(32, 8, 8, 256, 7, 4), (32, 4, 4, 256, 7, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HDIT_SHAPES, ids=["8x8", "4x4"])
def test_kernels_at_hdit_shapes_on_card(shape):
    """K1 and K2 at HDiT's shapes against their plain twins, fp32 and bf16,
    with the tolerances of the tests above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, W, C, ks, heads = shape
    g = torch.Generator("cuda").manual_seed(7)
    for dtype, tol1, rel2 in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 3e-2)):
        q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                       for _ in range(4))
        o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
        grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, o, gr)]
        ref = na2d_banded(*f32[:3], kernel_size=ks, heads=heads)
        assert (o.float() - ref).abs().max().item() < tol1, (shape, dtype)
        refs = na2d_bwd_banded(*f32, kernel_size=ks, heads=heads)
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            tol = rel2 * max(1.0, r.abs().max().item())
            assert (a.float() - r).abs().max().item() < tol, (shape, dtype, name)


# Head dim 256: midi_inpainting's codec has two encoder NATTEN blocks at
# 8x8x2048 with 8 heads (B=8 here; the training batch of 64 and the
# pre-encode batch of 32 run in chip_smoke.py), a ragged map with 2 heads
# of 256, and in bf16 a 16x16 map (in fp32 K2's second pass does not fit
# maps whose border key tiles see 11x11 queries at this width).
DH256_SHAPES = [((8, 8, 8, 2048, 7, 8), (torch.float32, torch.bfloat16)),
                ((2, 9, 6, 512, 5, 2), (torch.float32, torch.bfloat16)),
                ((2, 16, 16, 512, 7, 2), (torch.bfloat16,))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", DH256_SHAPES, ids=["8x8x2048", "9x6x512", "16x16x512"])
def test_kernels_at_head_dim_256_on_card(shape, dtypes):
    """K1 and K2 at dh 256 against their plain twins with the tolerances of
    the tests above, and na2d's gradients on the card (K1, K2 through
    ``NA2DFunction``) against autograd of the plain version in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, W, C, ks, heads = shape
    g = torch.Generator("cuda").manual_seed(11)
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)}
    for dtype in dtypes:
        tol1, rel2 = tols[dtype]
        q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                       for _ in range(4))
        o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
        grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, o, gr)]
        ref = na2d_banded(*f32[:3], kernel_size=ks, heads=heads)
        assert (o.float() - ref).abs().max().item() < tol1, (shape, dtype)
        refs = na2d_bwd_banded(*f32, kernel_size=ks, heads=heads)
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            tol = rel2 * max(1.0, r.abs().max().item())
            assert (a.float() - r).abs().max().item() < tol, (shape, dtype, name)
    if torch.float32 in dtypes:
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
def test_backward_kernel_is_deterministic_on_card():
    """K2 writes every output once, with no atomics: two calls on the same
    inputs give bitwise-equal dq, dk and dv, in fp32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator("cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, gr = (torch.randn(2, 33, 31, 128, device="cuda", generator=g).to(dtype)
                       for _ in range(4))
        o = na2d_fwd(q, k, v, kernel_size=7, heads=4)
        first = na2d_bwd(q, k, v, o, gr, kernel_size=7, heads=4)
        second = na2d_bwd(q, k, v, o, gr, kernel_size=7, heads=4)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


# tpu_vqgan's codec (flowers' widths, codec.bf16) at its training batch:
# the NATTEN shapes at which every bf16 codec step runs K2
CODEC_STEP_SHAPES = [(64, 32, 32, 512, 7, 8), (64, 16, 16, 1024, 7, 8),
                     (64, 16, 16, 128, 7, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CODEC_STEP_SHAPES, ids=["32x32x512", "16x16x1024",
                                                          "16x16x128"])
def test_backward_kernel_in_bf16_at_the_codec_step_shapes_on_card(shape):
    """K2 in bf16 at the bf16 codec step's shapes, B=64: within
    3e-2·max(1, max|ref|) of its twin in fp32 on the same bf16 values, and
    bitwise equal across two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, W, C, ks, heads = shape
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
    first = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
    second = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
    torch.cuda.synchronize()
    refs = na2d_bwd_banded(*(t.float() for t in (q, k, v, o, gr)), kernel_size=ks,
                           heads=heads)
    for name, a, b, ref in zip(("dq", "dk", "dv"), first, second, refs):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
        tol = 3e-2 * max(1.0, ref.abs().max().item())
        err = (a.float() - ref).abs().max().item()
        assert err < tol, (shape, name, err, tol)


@pytest.mark.gpu
def test_kernels_refuse_a_misaligned_view_on_card():
    """The kernels copy 16-byte chunks, so a view that starts off a 16-byte
    boundary is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = (1, 8, 8, 64)
    buf = torch.randn(8 * 8 * 64 + 1, device="cuda")
    bad = buf[1:].view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    good = torch.randn(shape, device="cuda")
    fwd, bwd = na2d_fwd.launches, na2d_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        na2d_fwd(good, bad, good, kernel_size=7, heads=4)
    with pytest.raises(ValueError, match="16-byte"):
        na2d_bwd(good, good, good, good, bad, kernel_size=7, heads=4)
    assert (na2d_fwd.launches, na2d_bwd.launches) == (fwd, bwd)


@pytest.mark.gpu
def test_fused_vq_kernels_match_twins_on_card():
    """K4, K3 and K5 against their plain twins on the card, TF32 off: picks
    equal to the twin's or ε-optimal (relative fp64 distance gap < 1e-5),
    z_q within 1e-5·max(1, max|ref|) where the picks agree, K5's
    intermediates within 1e-5·max(1, max|ref|) of the twin and of the fp64
    oracle; every D that the source instantiates; K3 and K5 at every cluster
    size, on a 1×1 map, at B=1 and on a 3-row map with a cluster of 8 (five
    blocks with no rows); codebooks with duplicated codes, where the pick is
    the first index exactly; a NaN token picks code 0 at every level; two
    calls are bitwise equal; a map too large for a cluster's shared memory
    raises before any launch."""
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops.kernels import fused_vq as kernels
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(2)

    for N, Din, D, L, K in ((8192, 128, 4, 4, 96), (1024, 256, 4, 3, 512), (77, 16, 4, 3, 8),
                            (300, 64, 8, 2, 64), (300, 64, 3, 2, 64), (100, 30, 4, 2, 16)):
        z, w, b, cb = fvq.random_vq_inputs(g, N, Din, D, L, K)
        zq, idx = fvq.fused_compress_vq(z, w, b, cb)
        torch.cuda.synchronize()
        res = fvq.check_quantized(zq, idx, *fvq.fused_compress_vq_plain(z, w, b, cb),
                                  z.double() @ w.double() + b.double(), cb)
        assert res["ok"], res
        again = fvq.fused_compress_vq(z, w, b, cb)
        assert torch.equal(zq, again[0]) and torch.equal(idx, again[1])

    for B, H, W, Din, D, L, K, groups, nchw, cs in (
            (32, 16, 16, 128, 4, 4, 96, 2, True, None), (32, 16, 16, 128, 4, 4, 96, 2, False, None),
            (32, 16, 16, 128, 4, 4, 96, 2, True, 1), (32, 16, 16, 128, 4, 4, 96, 2, True, 2),
            (32, 16, 16, 128, 4, 4, 96, 2, True, 4), (32, 16, 16, 128, 4, 4, 96, 2, True, 8),
            (3, 5, 7, 16, 4, 3, 8, 2, True, None), (2, 20, 20, 16, 4, 2, 16, 2, True, None),
            (2, 20, 20, 16, 4, 2, 16, 2, True, 1), (2, 16, 16, 32, 3, 2, 16, 1, True, None),
            (2, 16, 16, 32, 8, 2, 16, 2, True, None), (1, 1, 1, 16, 4, 2, 16, 2, True, None),
            (1, 1, 1, 16, 4, 2, 16, 2, True, 8), (1, 16, 16, 128, 4, 4, 96, 2, True, None),
            (2, 3, 5, 32, 4, 2, 16, 2, True, 8), (2, 3, 8, 32, 4, 2, 16, 2, False, 8)):
        h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, D, L, K, groups, nchw)
        zq, idx = kernels.fused_compress_tail_vq(h, *tail, cb, groups, cluster=cs)
        torch.cuda.synchronize()
        res = fvq.check_quantized(zq, idx, *fvq.fused_compress_tail_vq_plain(h, *tail, cb, groups),
                                  fvq.compress_tail_oracle(h, *tail, groups)[2], cb)
        assert res["ok"], ((B, H, W, Din, D, L, K, groups, nchw, cs), res)
        again = kernels.fused_compress_tail_vq(h, *tail, cb, groups, cluster=cs)
        assert torch.equal(zq, again[0]) and torch.equal(idx, again[1])

    # duplicated codes: codes 2i and 2i + 1 are equal, so every pick is even
    z, w, b, cb = fvq.random_vq_inputs(g, 8192, 128, 4, 4, 48)
    cb2 = cb.repeat_interleave(2, dim=1)
    idx = fvq.fused_compress_vq(z, w, b, cb2)[1]
    torch.cuda.synchronize()
    assert not (idx % 2).any()
    h, tail, cb = fvq.random_tail_inputs(g, 32, 16, 16, 128, 4, 4, 48, 2)
    for cs in kernels.CLUSTER_SIZES:
        idx = kernels.fused_compress_tail_vq(h, *tail, cb.repeat_interleave(2, dim=1), 2,
                                             cluster=cs)[1]
        torch.cuda.synchronize()
        assert not (idx % 2).any(), cs
    # a NaN token: every distance is NaN, so no code wins at any level, as
    # in the TPU kernels' all-zero one-hot: z_q 0, index 0; the others as
    # the twin's. In K3 a NaN pixel makes its whole image NaN (GroupNorm).
    z[5] = float("nan")
    zq, idx = fvq.fused_compress_vq(z, w, b, cb)
    torch.cuda.synchronize()
    assert not idx[5].any() and not zq[5].any()
    zq_p, idx_p = fvq.fused_compress_vq_plain(z, w, b, cb)
    assert torch.equal(idx, idx_p) and not zq_p[5].any()
    h, tail, cb = fvq.random_tail_inputs(g, 2, 16, 16, 128, 4, 4, 96, 2)
    h[1, 3, 4] = float("nan")
    for cs in kernels.CLUSTER_SIZES:
        zq, idx = kernels.fused_compress_tail_vq(h, *tail, cb, 2, cluster=cs)
        torch.cuda.synchronize()
        assert not idx[1].any() and not zq[1].any(), cs
        assert torch.equal(idx, fvq.fused_compress_tail_vq_plain(h, *tail, cb, 2)[1]), cs

    for (B, H, W, Din, D, groups), cs in (((4, 16, 16, 256, 4, 2), None),
                                          ((4, 16, 16, 256, 4, 2), 1),
                                          ((4, 16, 16, 256, 4, 2), 2),
                                          ((3, 5, 7, 64, 3, 1), 8), ((1, 1, 1, 16, 8, 2), 8)):
        h, tail, _ = fvq.random_tail_inputs(g, B, H, W, Din, D, 1, 1, groups)
        ours = kernels.compress_tail_debug(h, *tail, groups, cluster=cs)
        torch.cuda.synchronize()
        for a, ref, ref64 in zip(ours, fvq.compress_tail_debug_plain(h, *tail, groups),
                                 fvq.compress_tail_oracle(h, *tail, groups)):
            for r in (ref, ref64):
                assert (a - r).abs().max().item() < 1e-5 * max(1.0, r.abs().max().item())
        again = kernels.compress_tail_debug(h, *tail, groups, cluster=cs)
        assert all(torch.equal(a, b) for a, b in zip(ours, again))

    h, tail, cb = fvq.random_tail_inputs(g, 1, 512, 512, 8, 4, 1, 4, 2)
    before = kernels.compress_tail_debug.launches
    with pytest.raises(ValueError, match="shared memory"):     # bands of 64 rows: 540 KB
        kernels.compress_tail_debug(h, *tail, 2)
    assert kernels.compress_tail_debug.launches == before


@pytest.mark.gpu
def test_fused_tail_vq_on_bf16_h_matches_twin_on_card():
    """K3's bf16 case against its plain twin on the same bf16 h, TF32 off:
    the picks equal and z_q equal in bf16 (the twin widens h and runs the
    fp32 tail); and against K3's fp32 case on h widened: the same picks
    and z_q rounded, bit for bit. At the pre-encode shape (B=32, 16²×128,
    D=4, L=4, K=96) in both layouts of h and every cluster size; a ragged
    5×7 map (no 16-byte runs: values staged one at a time), D=3 and 8, a
    1×1 map and a 3-row map in a cluster of 8."""
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops.kernels import fused_vq as kernels
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(5)
    for B, H, W, Din, D, L, K, groups, nchw, cs in (
            (32, 16, 16, 128, 4, 4, 96, 2, True, None), (32, 16, 16, 128, 4, 4, 96, 2, False, None),
            (32, 16, 16, 128, 4, 4, 96, 2, True, 1), (32, 16, 16, 128, 4, 4, 96, 2, True, 2),
            (32, 16, 16, 128, 4, 4, 96, 2, True, 4), (32, 16, 16, 128, 4, 4, 96, 2, True, 8),
            (3, 5, 7, 16, 4, 3, 8, 2, True, None), (3, 5, 7, 16, 4, 3, 8, 2, False, None),
            (2, 16, 16, 32, 3, 2, 16, 1, True, None), (2, 16, 16, 32, 8, 2, 16, 2, True, None),
            (1, 1, 1, 16, 4, 2, 16, 2, True, 8), (2, 3, 8, 32, 4, 2, 16, 2, True, 8)):
        h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, D, L, K, groups, nchw)
        hb = h.to(torch.bfloat16)
        before = kernels.fused_compress_tail_vq_bf16.launches
        zq, idx = fvq.fused_compress_tail_vq(hb, *tail, cb, groups)
        if cs is not None:
            zq, idx = kernels.fused_compress_tail_vq_bf16(hb, *tail, cb, groups, cluster=cs)
        torch.cuda.synchronize()
        case = (B, H, W, Din, D, L, K, groups, nchw, cs)
        assert kernels.fused_compress_tail_vq_bf16.launches == before + (1 if cs is None else 2)
        assert zq.dtype == torch.bfloat16 and idx.dtype == torch.int32, case
        zq_t, idx_t = fvq.fused_compress_tail_vq_plain(hb, *tail, cb, groups)
        assert torch.equal(idx, idx_t) and torch.equal(zq, zq_t), case
        zq32, idx32 = kernels.fused_compress_tail_vq(hb.float(), *tail, cb, groups, cluster=cs)
        assert torch.equal(idx, idx32) and torch.equal(zq, zq32.to(torch.bfloat16)), case
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_compress_tail_vq_bf16(hb, *(t.bfloat16() for t in tail), cb, groups)


@pytest.mark.gpu
def test_int8_conv_matches_its_twin_on_card():
    """The W8A8 convolution on the card (im2col + ``torch._int_mm``) against
    its float64 twin on the CPU: the int8 codes equal, the output within
    1e-6 of the largest |ref|; at an SD-decoder shape (128²×128, k 3, B=4,
    cut in chunks), a VQGAN decoder shape (32²×512 → 512, k 3), a stride-2
    SAME conv and a 1×1 in bf16; a shape ``_int_mm`` does not take raises."""
    from flocoder_torch.ops import quant
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator("cuda").manual_seed(3)
    for B, C, S, Co, k, stride, pad, dt in ((4, 128, 128, 128, 3, 1, 1, torch.float32),
                                           (8, 512, 32, 512, 3, 1, 1, torch.bfloat16),
                                           (2, 64, 16, 64, 3, 2, "SAME", torch.float32),
                                           (2, 256, 16, 128, 1, 1, 0, torch.bfloat16)):
        x = (torch.randn(B, C, S, S, device="cuda", generator=g) * 2).to(dt)
        w = torch.randn(Co, C, k, k, device="cuda", generator=g) / (C * k * k) ** 0.5
        b = torch.randn(Co, device="cuda", generator=g) * 0.1
        before = quant.int_mm_calls.launches
        y = quant.int8_conv(x, w, b, stride, pad, dt)
        torch.cuda.synchronize()
        assert quant.int_mm_calls.launches > before
        assert torch.equal(quant.quantize_activations(x)[0].cpu(),
                           quant.quantize_activations(x.cpu())[0])
        assert torch.equal(quant.quantize_weight(w)[0].cpu(), quant.quantize_weight(w.cpu())[0])
        ref = quant.int8_conv(x.cpu(), w.cpu(), b.cpu(), stride, pad, dt)
        assert y.dtype == ref.dtype == dt and y.shape == ref.shape
        err = (y.cpu().float() - ref.float()).abs().max().item()
        assert err <= 1e-6 * ref.float().abs().max().item(), (B, C, S, Co, k, err)
    with pytest.raises(ValueError, match="_int_mm"):
        quant.int8_conv(torch.randn(1, 64, 4, 4, device="cuda"),
                        torch.randn(64, 64, 3, 3, device="cuda"), None, 1, 1)


@pytest.mark.gpu
def test_reflow_pairs_on_card_launch_k1_and_match_the_cpu():
    """The reflow sampler (``make_reflow_pairs.sample_pairs``) of a small
    HDiT with the NA variant (patch 2, ``na:3`` at width 16 on 8×8×4
    latents, depth 1: two NA blocks a forward) on the card: K1 launches
    exactly 2 a velocity call (CFG rides in the batch), and the pairs equal
    the same model's on the CPU with the same noise and labels within
    1e-3·max(1, |ref|), fp32, TF32 off."""
    from flocoder_torch.config import load_config
    from flocoder_torch.make_reflow_pairs import sample_pairs
    from flocoder_torch.models.flow_model import build_flow_model
    from flocoder_torch.models.layers import init_params
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("flowers_hdit", "configs", [
        "flow.hdit_depths=[1,1]", "flow.hdit_widths=[16,32]", "flow.hdit_d_ffs=[32,64]",
        "flow.hdit_d_head=8", "flow.hdit_mapping_depth=1", "flow.hdit_mapping_width=32",
        "flow.hdit_mapping_d_ff=64", "flow.hdit_patch_size=2", "flow.hdit_attns=[na:3,global]"])
    model = init_params(build_flow_model(cfg, 4, 3), torch.Generator().manual_seed(0))
    with torch.no_grad():                       # every zero-init projection carries signal
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    g = torch.Generator().manual_seed(2)
    noise = torch.randn(8, 8, 8, 4, generator=g)
    labels = torch.randint(0, 3, (8,), generator=g)
    ref, nfe = sample_pairs(model.eval(), noise, labels, 3, "rk4", 4, 3.0)
    before = na2d_fwd.launches
    lat, nfe_card = sample_pairs(model.cuda(), noise.cuda(), labels, 3, "rk4", 4, 3.0)
    torch.cuda.synchronize()
    assert nfe == nfe_card == 12 and na2d_fwd.launches - before == 2 * 12
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    assert (lat.cpu() - ref).abs().max().item() < tol


@pytest.mark.gpu
def test_vqgan_plus_on_card_launches_no_kernel_and_matches_the_cpu():
    """A small VQGAN+ codec (hidden 32, three downsamples, 32² images) on the
    card against the CPU, fp32, TF32 off: the reconstruction within
    1e-3·max(1, |ref|), the RVQ indices equal, no K1 or K2 launch."""
    from flocoder_torch.models.vqgan_plus import VQGANPlus
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    codec = VQGANPlus(hidden_channels=32, num_downsamples=3, internal_dim=32,
                      vq_embedding_dim=4, codebook_levels=2, vq_num_embeddings=16)
    codec.init(torch.Generator().manual_seed(0)).eval()
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, _, idx_ref, _ = codec(x)
        before = (na2d_fwd.launches, na2d_bwd.launches)
        out, _, idx, _ = codec.cuda()(x.cuda())
        torch.cuda.synchronize()
    assert (na2d_fwd.launches, na2d_bwd.launches) == before
    assert torch.equal(idx.cpu(), idx_ref)
    assert (out.cpu() - ref).abs().max().item() < 1e-3 * max(1.0, ref.abs().max().item())
