#!/usr/bin/env python3
"""Smoke test of flocoder_torch on one CUDA card (an H100).

    python3 chip_smoke.py

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the hand-written kernels from the sources in this checkout, one
   nvcc each, started together: K1, the NA2D forward
   (flocoder_torch/csrc/na2d_fwd.cu), K2, the NA2D backward
   (flocoder_torch/csrc/na2d_bwd.cu), and K3, K4 and K5, the fused
   compression tail and RVQ search (flocoder_torch/csrc/fused_vq.cu).
3. Holds K1 against its plain PyTorch version (na2d_banded) on the card, TF32
   off: the codec's shapes at B=8 (32²×512 with head dim 64, 16²×1024 with
   head dim 128, 16²×128 with head dim 16) and at the main paths' batches
   (64 for the serving decode, 1 for img2img's encode, 32 for the
   pre-encode's encoder, fp32 only), a non-square map, a map smaller than
   the window, a ragged one; fp32 (max |Δ| < 1e-4) and bf16 (against the
   plain version in fp32 on the same bf16 values, max |Δ| < 2e-2: one bf16
   rounding of outputs of magnitude up to ~4).
4. Holds K2 against its plain twin (na2d_bwd_banded) at the training shapes
   at B=8 and the same non-square, smaller-than-window and ragged maps: fp32
   max |Δ| < 1e-4·max(1, max|ref|), bf16 < 3e-2·max(1, max|ref|) against the
   twin in fp32 on the same bf16 values; that two K2 calls on the same
   inputs are bitwise equal; and the gradients of na2d on the card
   (NA2DFunction: K1 forward, K2 backward) against torch autograd of
   na2d_banded.
5. Times K1 and K2 at the decoder's shape (B=64, 32², C=512, fp32), by
   CUDA events over back-to-back calls and by the profiler's device time of
   the kernels alone, beside the plain versions, the least time the card
   could take, and
   F.scaled_dot_product_attention with the neighborhood mask (forward for
   K1, forward + backward against K1 + K2 for K2: a yardstick only; the
   port never calls it). Then times K1 at every NATTEN shape of the codec
   (32²×512, 16²×1024, 16²×128) at B=64 and B=32 and K2 at B=64, fp32 and
   bf16, beside each shape's bound (time_na2d_shapes; the same function
   times another checkout's kernels in benchmarks/na2d_shapes.py).
6. Serves flowers_vqgan at full width through the port's entry point
   (flocoder_torch.generate_samples.main) from seeded random-init
   checkpoints: unconditional, class-conditional with CFG (n_classes=102),
   and img2img from an init image (which runs the encoder). The kernels'
   launch counts are zeroed before and read after these runs. Then times
   the parts of a serving batch: a U-Net forward, a decode, an encode.
7. Trains flowers_vqgan at full width (128², hidden 256, batch 64, VGG16
   perceptual loss, patch discriminator) through the port's entry point
   (flocoder_torch.train_vqgan.main): one warmup and one GAN epoch over a
   folder of 320 seeded random PNGs (4 steps per epoch, then one validation
   batch). The launch counts are zeroed before and read after, and must be
   6 K1 and 6 K2 per training step plus 6 K1 per validation batch. Prints
   samples/s per phase (over the steady steps, and over the whole epoch
   with the loader's wait and the copy to the card), peak memory and the
   losses; then a GAN step's breakdown by CUDA events and its device idle
   share under the profiler.
8. Checks small inputs end to end against the same models on the CPU, TF32
   off: the RK4 + CFG sampler and decode, the encoder, and one warmup step
   and one GAN step of a small codec (hidden 64): losses and parameters
   within 1e-3·max(1, |ref|), and the gradients (Adam's first moments of
   the codec and of the discriminator) within 1e-3·max|ref| of each model.
9. Holds K4, K3 and K5 against their plain twins (flocoder_torch.ops.fused_vq)
   on the card, TF32 off: each token's picks equal the twin's or ε-optimal
   under an fp64 oracle (relative distance gap < 1e-5), z_q within
   1e-5·max(1, |ref|) where the picks agree, K5's intermediates within
   1e-5·max(1, |ref|) of the twin and of the fp64 oracle; K4 at a
   pre-encode batch of tokens, the probe's shape, a ragged N and D=3 and 8,
   K3 at a pre-encode batch (both layouts of h), a ragged 5×7 map, a 20×20
   map, D=3 with one group and D=8 with two. Times each at its main shape
   beside its twin, the unfused torch path (the yardstick) and its bound.
10. Pre-encodes flowers_vqgan at full width through the port's entry point
   (flocoder_torch.preencode_data.main) with preencoding.quantize=true
   preencoding.fused_vq=true, batch 32, augs_per 4, over 320 seeded random
   500² PNGs (4 val and 36 train batches). The launch counts are zeroed
   before and read after: 5 K1 and 1 K3 per batch, no K2, K4 or K5. Reads
   the latents back, rebuilds the first batch from the same config and
   holds its fused picks against the unfused path's, and prints latents/s
   per split, encode ms per batch fused and unfused, peak memory and one
   batch's device idle share.
11. Pre-encodes a small codec's (hidden 64) batches on the card and on the
   CPU through the same entry point: on each rebuilt batch the picks equal
   or ε-optimal, the latent files within 1e-4·max(1, |ref|) elsewhere.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Imports nothing of JAX or of flocoder_tpu.
"""
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, key: str, iters: int = 10) -> float:
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    name holds ``key``, by the profiler over ``iters`` calls after a warm
    one: the kernels' own time, whatever the host spends between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key) / 1e3 / iters


def na2d_bound_ms(B, H, W, C, ks, dtype) -> tuple:
    """(least ms, 'bytes' or 'operations'): q, k, v read once and the output
    written once, against 4·ks²·C FLOPs per pixel (QKᵀ and PV)."""
    n = B * H * W * C
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 4 * n * elem / HBM_BYTES_PER_S
    t_ops = 4 * ks * ks * n / (FP32_FLOPS_PER_S if dtype == torch.float32
                               else BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_k1(na2d_fwd, na2d_banded) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    both = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    cases = [  # (label, (B, H, W, C), heads, kernel_size, dtypes)
        ("decoder/encoder 32x32 C512 dh64", (8, 32, 32, 512), 8, 7, both),
        ("encoder 16x16 C1024 dh128", (8, 16, 16, 1024), 8, 7, both),
        ("encoder 16x16 C128 dh16", (8, 16, 16, 128), 8, 7, both),
        # the serving runs' own shapes: decode at batch 64, img2img's encode
        # of one image (the decode at 64 is held in time_k1)
        ("serving encode 32x32 C512 dh64 B1", (1, 32, 32, 512), 8, 7, both),
        ("serving encode 16x16 C1024 dh128 B1", (1, 16, 16, 1024), 8, 7, both),
        ("serving encode 16x16 C128 dh16 B1", (1, 16, 16, 128), 8, 7, both),
        # the pre-encode's own shapes: the encoder at batch 32, in fp32
        ("pre-encode 32x32 C512 dh64 B32", (32, 32, 32, 512), 8, 7, both[:1]),
        ("pre-encode 16x16 C1024 dh128 B32", (32, 16, 16, 1024), 8, 7, both[:1]),
        ("pre-encode 16x16 C128 dh16 B32", (32, 16, 16, 128), 8, 7, both[:1]),
        ("non-square 24x40 dh32", (2, 24, 40, 64), 2, 7, both),
        ("smaller than k 5x6 dh8 (ks=5)", (2, 5, 6, 32), 4, 7, both),
        ("ragged tiles 17x13 dh24", (2, 17, 13, 48), 2, 7, both),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, heads, ks, dtypes in cases:
        for dtype, tol in dtypes:
            q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                       for _ in range(3))
            out = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            ref = na2d_banded(q.float(), k.float(), v.float(),
                              kernel_size=ks, heads=heads)
            err = (out.float() - ref).abs().max().item()
            ok = bool(np.isfinite(err)) and err < tol
            print(f"K1 check {label} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                  f"(tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K1 disagrees with its plain version at {label} {dtype}")
            errs[dtype] = max(errs[dtype], err)
    return errs


def time_k1(na2d_fwd, na2d_banded, card: str) -> dict:
    import torch.nn.functional as F
    B, H, W, C, heads, ks = 64, 32, 32, 512, 8, 7
    dh = C // heads
    g = torch.Generator("cuda").manual_seed(1)
    q, k, v = (torch.randn(B, H, W, C, device="cuda", generator=g)
               for _ in range(3))
    out = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
    torch.cuda.synchronize()
    err = (out - na2d_banded(q, k, v, kernel_size=ks, heads=heads)).abs().max().item()
    print(f"K1 check serving decode {H}x{W} C{C} dh{dh} B{B} float32: "
          f"max_abs_err={err:.3e} (tol 0.0001) {'ok' if err < 1e-4 else 'FAIL'}",
          flush=True)
    if not err < 1e-4:
        fail("K1 disagrees with its plain version at the serving decode shape")
    ms = cuda_ms(lambda: na2d_fwd(q, k, v, kernel_size=ks, heads=heads), 50)
    dev_ms = device_ms(lambda: na2d_fwd(q, k, v, kernel_size=ks, heads=heads), "na2d_fwd")
    plain_ms = cuda_ms(lambda: na2d_banded(q, k, v, kernel_size=ks,
                                           heads=heads), 5, warmup=1)
    qb, kb, vb = (bf.to(torch.bfloat16) for bf in (q, k, v))
    bf16_ms = cuda_ms(lambda: na2d_fwd(qb, kb, vb, kernel_size=ks,
                                       heads=heads), 50)

    # yardstick: one SDPA call over the 1024 tokens with the NATTEN mask
    r = torch.arange(H, device="cuda")
    c = torch.arange(W, device="cuda")
    rs = (r - ks // 2).clamp(0, H - ks)
    cs = (c - ks // 2).clamp(0, W - ks)
    row_ok = (r[None, :] >= rs[:, None]) & (r[None, :] < rs[:, None] + ks)
    col_ok = (c[None, :] >= cs[:, None]) & (c[None, :] < cs[:, None] + ks)
    mask = (row_ok[:, None, :, None] & col_ok[None, :, None, :]).reshape(H * W, H * W)
    qs, ks_, vs = (t.reshape(B, H * W, heads, dh).transpose(1, 2).contiguous()
                   for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask)  # noqa: E731
    lib = sdpa().transpose(1, 2).reshape(B, H, W, C)
    lib_err = (lib - out).abs().max().item()
    if not lib_err < 1e-3:
        fail(f"the SDPA yardstick disagrees with K1 ({lib_err:.3e})")
    library_ms = cuda_ms(sdpa, 10, warmup=2)
    bound_ms, bound_by = na2d_bound_ms(B, H, W, C, ks, torch.float32)
    bf16_bound, _ = na2d_bound_ms(B, H, W, C, ks, torch.bfloat16)
    print(f"K1 time (B={B}, {H}x{W}, C={C}, {heads} heads, k={ks}) fp32: "
          f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) | bf16: kernel_ms={bf16_ms:.4f} "
          f"bound_ms={bf16_bound:.4f} | card: {card}", flush=True)
    del q, k, v, qb, kb, vb, qs, ks_, vs, lib, out
    torch.cuda.empty_cache()
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by), err


def na2d_bwd_bound_ms(B, H, W, C, ks, dtype) -> tuple:
    """(least ms, 'bytes' or 'operations') of K2: q, k, v, o and g read
    once, dq, dk and dv written once, against 10·ks²·C FLOPs per pixel
    (the QKᵀ recompute, dP, dQ, dK and dV)."""
    n = B * H * W * C
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 8 * n * elem / HBM_BYTES_PER_S
    t_ops = 10 * ks * ks * n / (FP32_FLOPS_PER_S if dtype == torch.float32
                                else BF16_FLOPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded) -> dict:
    """K2 against its plain twin on the same q, k, v, g and K1's output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(3)
    cases = [  # (label, (B, H, W, C), heads, kernel_size)
        ("decoder/encoder 32x32 C512 dh64", (8, 32, 32, 512), 8, 7),
        ("encoder 16x16 C1024 dh128", (8, 16, 16, 1024), 8, 7),
        ("encoder 16x16 C128 dh16", (8, 16, 16, 128), 8, 7),
        ("non-square 24x40 dh32", (2, 24, 40, 64), 2, 7),
        ("smaller than k 5x6 dh8 (ks=5)", (2, 5, 6, 32), 4, 7),
        ("ragged tiles 17x13 dh24", (2, 17, 13, 48), 2, 7),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, heads, ks in cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, gr = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
            grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
            torch.cuda.synchronize()
            refs = na2d_bwd_banded(*(t.float() for t in (q, k, v, o, gr)),
                                   kernel_size=ks, heads=heads)
            for name, a, ref in zip(("dq", "dk", "dv"), grads, refs):
                err = (a.float() - ref).abs().max().item()
                tol = rel * max(1.0, ref.abs().max().item())
                ok = bool(np.isfinite(err)) and err < tol
                print(f"K2 check {label} {str(dtype)[6:]} {name}: max_abs_err="
                      f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K2 disagrees with its plain twin at {label} {dtype} {name}")
                errs[dtype] = max(errs[dtype], err)
            if label.startswith("decoder"):     # no atomics: a second call is bitwise equal
                again = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                print(f"K2 determinism {label} {str(dtype)[6:]}: two calls bitwise equal: "
                      f"{same}", flush=True)
                if not same:
                    fail(f"K2 gave two different results on the same inputs ({dtype})")
    return errs


def check_function(na2d, na2d_banded) -> None:
    """The gradients of na2d on the card (NA2DFunction: K1 forward, K2
    backward) against torch autograd through the plain na2d_banded."""
    g = torch.Generator("cuda").manual_seed(4)
    for shape, heads in (((2, 16, 16, 128), 8), ((2, 17, 13, 48), 2)):
        q, k, v, gr = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        grads = []
        for fn in (na2d, na2d_banded):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, kernel_size=7, heads=heads)
            grads.append(torch.autograd.grad(out, leaves, gr))
        for name, a, ref in zip(("dq", "dk", "dv"), *grads):
            err = (a - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            print(f"NA2DFunction {shape} {name}: max_abs_err={err:.3e} (tol {tol:.3e})",
                  flush=True)
            if not (np.isfinite(err) and err < tol):
                fail(f"na2d's gradient on the card disagrees with autograd ({name})")


def time_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded, na2d, card: str) -> tuple:
    import torch.nn.functional as F
    B, H, W, C, heads, ks = 64, 32, 32, 512, 8, 7
    dh = C // heads
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g)
                   for _ in range(4))
    o = na2d_fwd(q, k, v, kernel_size=ks, heads=heads)
    grads = na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads)
    torch.cuda.synchronize()
    refs = na2d_bwd_banded(q, k, v, o, gr, kernel_size=ks, heads=heads)
    err = max((a - r).abs().max().item() for a, r in zip(grads, refs))
    tol = 1e-4 * max(1.0, max(r.abs().max().item() for r in refs))
    print(f"K2 check training decode {H}x{W} C{C} dh{dh} B{B} float32: "
          f"max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    if not err < tol:
        fail("K2 disagrees with its plain twin at the decoder's training shape")
    del refs
    ms = cuda_ms(lambda: na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads), 20)
    dev_ms = device_ms(lambda: na2d_bwd(q, k, v, o, gr, kernel_size=ks, heads=heads),
                       "na2d_bwd")
    plain_ms = cuda_ms(lambda: na2d_bwd_banded(q, k, v, o, gr, kernel_size=ks,
                                               heads=heads), 3, warmup=1)
    qb, kb, vb, ob, gb = (t.to(torch.bfloat16) for t in (q, k, v, o, gr))
    bf16_ms = cuda_ms(lambda: na2d_bwd(qb, kb, vb, ob, gb, kernel_size=ks,
                                       heads=heads), 20)

    # yardstick: SDPA forward + backward with the NATTEN mask, against K1 + K2
    r = torch.arange(H, device="cuda")
    c = torch.arange(W, device="cuda")
    rs = (r - ks // 2).clamp(0, H - ks)
    cs = (c - ks // 2).clamp(0, W - ks)
    row_ok = (r[None, :] >= rs[:, None]) & (r[None, :] < rs[:, None] + ks)
    col_ok = (c[None, :] >= cs[:, None]) & (c[None, :] < cs[:, None] + ks)
    mask = (row_ok[:, None, :, None] & col_ok[None, :, None, :]).reshape(H * W, H * W)
    heads_first = lambda t: (t.reshape(B, H * W, heads, dh).transpose(1, 2)  # noqa: E731
                             .contiguous().requires_grad_())
    qs, ks_, vs = (heads_first(t) for t in (q, k, v))
    gs = gr.reshape(B, H * W, heads, dh).transpose(1, 2).contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_grads = torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask), (qs, ks_, vs), gs)
    lib_err = max((a.transpose(1, 2).reshape(B, H, W, C) - b).abs().max().item()
                  for a, b in zip(sdpa_grads, grads))
    if not lib_err < 1e-3:
        fail(f"the SDPA yardstick's gradients disagree with K2 ({lib_err:.3e})")
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask),
        (qs, ks_, vs), gs), 5, warmup=2)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        na2d(*leaves, kernel_size=ks, heads=heads), leaves, gr), 20)
    bound_ms, bound_by = na2d_bwd_bound_ms(B, H, W, C, ks, torch.float32)
    bf16_bound, _ = na2d_bwd_bound_ms(B, H, W, C, ks, torch.bfloat16)
    print(f"K2 time (B={B}, {H}x{W}, C={C}, {heads} heads, k={ks}) fp32: "
          f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} "
          f"({bound_by}) | K1+K2 fwd+bwd_ms={fwd_bwd_ms:.4f} SDPA fwd+bwd "
          f"library_ms={library_ms:.4f} | bf16: kernel_ms={bf16_ms:.4f} "
          f"bound_ms={bf16_bound:.4f} | card: {card}", flush=True)
    del q, k, v, gr, o, grads, qb, kb, vb, ob, gb, qs, ks_, vs, gs, leaves, sdpa_grads
    torch.cuda.empty_cache()
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, fwd_bwd_ms=fwd_bwd_ms,
                bf16_ms=bf16_ms), err


# (B, H, W, C, heads) of the codec's NATTEN blocks (k=7) at the main paths'
# batches: 64 (serving decode, training), 32 (pre-encode's encoder).
NA2D_SHAPES = [(64, 32, 32, 512, 8), (64, 16, 16, 1024, 8), (64, 16, 16, 128, 8),
               (32, 32, 32, 512, 8), (32, 16, 16, 1024, 8), (32, 16, 16, 128, 8)]


def time_na2d_shapes(na2d_fwd, na2d_bwd, card: str, bwd_batch: int = 64) -> list:
    """K1 at every shape of NA2D_SHAPES and K2 at those of batch
    ``bwd_batch``, fp32 and bf16: the kernels' device time by the profiler
    (10 calls), CUDA events over 20 back-to-back calls, and the bound.
    Takes the kernels as arguments, so that benchmarks/na2d_shapes.py can
    time another checkout's kernels with it."""
    rows = []
    g = torch.Generator("cuda").manual_seed(6)
    for B, H, W, C, heads in NA2D_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            fwd = lambda: na2d_fwd(q, k, v, kernel_size=7, heads=heads)  # noqa: E731
            runs = [("na2d_fwd", fwd, na2d_bound_ms)]
            if B == bwd_batch:
                o = fwd()
                runs.append(("na2d_bwd", lambda: na2d_bwd(q, k, v, o, gr, kernel_size=7,
                                                          heads=heads), na2d_bwd_bound_ms))
            for name, fn, bound in runs:
                row = dict(kernel=name, shape=[B, H, W, C], heads=heads,
                           dtype=str(dtype)[6:], device_ms=device_ms(fn, name),
                           ms=cuda_ms(fn, 20), bound_ms=bound(B, H, W, C, 7, dtype)[0])
                rows.append(row)
                print(f"{name} shape B={B} {H}x{W} C={C} {row['dtype']}: device_ms="
                      f"{row['device_ms']:.4f} ms={row['ms']:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} | card: {card}", flush=True)
            del q, k, v, gr
    torch.cuda.empty_cache()
    return rows


def scale_codebooks(codec, image_size: int) -> None:
    """Scales the codec's N(0, 0.02²) codebooks to the spread of its
    encoder's output on seeded random images, so that the RVQ picks spread
    over the codes (as the JAX package's fused VQ test does)."""
    g = torch.Generator(codec.vq.codebooks.device).manual_seed(9)
    x = torch.rand(4, image_size, image_size, 3, device=g.device, generator=g) * 2 - 1
    with torch.inference_mode():
        spread = codec.encode(x).std().item()
    codec.vq.codebooks.data.mul_(spread / 0.02)


def write_checkpoints(tmp: str, config_dir: str):
    """Seeded random-init checkpoints in the npz contract for flowers_vqgan
    as composed: the VQGAN codec (128², hidden 256, 3 downsamples; its
    codebooks scaled by ``scale_codebooks``), an unconditional U-Net (dim
    16, dim_mults 1,2,4,8) and a class-conditional one (n_classes 102).
    NATTEN gates are set to 1 so that K1's output reaches the images."""
    from flocoder_torch.config import load_config
    from flocoder_torch.models.codecs import NATTENBlock, setup_codec
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.training.checkpoint import (
        UNET_PREFIXES, VQVAE_PREFIXES, save_checkpoint, to_jax_flat)

    codec_path = os.path.join(tmp, "vqgan_0.npz")
    base = ["flowers_vqgan.yaml", config_dir]
    cfg = load_config(*base, overrides=[f"codec.checkpoint={codec_path}"])
    cfg_cls = load_config(*base, overrides=[f"codec.checkpoint={codec_path}",
                                            "flow.unet.n_classes=102"])
    gen = torch.Generator("cuda")
    codec = init_params(setup_codec(cfg, device="cuda"), gen.manual_seed(0))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):
            m.gamma.data.fill_(1.0)
    scale_codebooks(codec, 128)
    save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), 0, ckpt_dir=tmp,
                    prefix="vqgan_")
    H, W, C = codec.latent_shape(128)
    paths = {"codec": codec_path}
    for name, c, n_classes in (("uncond", cfg, 0), ("cfg", cfg_cls, 102)):
        unet = Unet(dim=H, channels=C, dim_mults=(1, 2, 4, 8),
                    n_classes=n_classes).cuda()
        init_params(unet, gen.manual_seed(1))
        paths[name] = save_checkpoint(to_jax_flat(unet, UNET_PREFIXES), 0,
                                      ckpt_dir=tmp, prefix=f"flowema_{name}_",
                                      config=c)
    return paths


def serve(tmp: str, paths: dict, card: str, na2d_fwd) -> tuple:
    from PIL import Image
    from flocoder_torch import generate_samples as gs

    init_png = os.path.join(tmp, "init.png")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(init_png)
    runs = [  # (label, checkpoint, extra args, samples, decodes, encodes)
        ("unconditional", paths["uncond"], [], 128, 2, 0),
        ("CFG n_classes=102", paths["cfg"], [], 128, 2, 0),
        ("img2img (encoder)", paths["uncond"],
         [f"+init_image={init_png}", "+init_strength=0.5"], 64, 1, 1),
    ]
    results = []
    na2d_fwd.launches = 0
    expected = 0
    for label, ckpt, extra, n, decodes, encodes in runs:
        torch.cuda.reset_peak_memory_stats()
        res = gs.main(["--config-name", "flowers_vqgan.yaml",
                       f"+flow_checkpoint={ckpt}", f"+n_samples={n}",
                       "+n_steps=20", "flow.batch_size=64", "+seed=0",
                       f"+output_dir={os.path.join(tmp, 'out')}", *extra])
        imgs = res["images"]
        if imgs.shape != (n, 128, 128, 3) or not np.isfinite(imgs).all():
            fail(f"serving {label}: images {imgs.shape}, finite="
                 f"{bool(np.isfinite(imgs).all())}")
        secs = res["batch_seconds"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = dict(run=label, samples=n, nfe=res["nfe"], batch=64,
                   s_per_batch=secs, samples_per_s=n / sum(secs),
                   steady_samples_per_s=64 / secs[-1], peak_mem_gib=peak,
                   card=card)
        print(f"serve {label}: {n} samples, nfe={res['nfe']}, s/batch="
              f"{[round(s, 4) for s in secs]}, {rec['samples_per_s']:.2f} samples/s "
              f"(last batch {rec['steady_samples_per_s']:.2f}), peak "
              f"{peak:.2f} GiB | card: {card}", flush=True)
        results.append(rec)
        expected += decodes + 5 * encodes   # 1 NATTEN block per decode, 5 per encode
    launches = na2d_fwd.launches
    print(f"K1 launches in the serving runs: {launches} (expected {expected})")
    if launches == 0 or launches != expected:
        fail(f"serving launched K1 {launches} times, expected {expected}")
    return results, launches


def breakdown(paths: dict, card: str) -> dict:
    """Where a serving batch's time goes, by CUDA events on the served
    models: one U-Net forward at the batch the sampler gives it (64, or 128
    with CFG), the decode of 64 latents, and the encode of one image; then
    one unconditional batch of 64 (20 grid points) under the profiler."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.config import Config
    from flocoder_torch.evaluation import sampler

    dev = torch.device("cuda")
    unc = gs.load_models_once(Config({}), paths["uncond"], dev)
    cls = gs.load_models_once(Config({}), paths["cfg"], dev)
    g = torch.Generator("cuda").manual_seed(2)
    x64 = torch.randn(64, 16, 16, 4, device="cuda", generator=g)
    x128 = torch.cat([x64, x64])
    t64, t128 = (torch.full((n,), 500.0, device="cuda") for n in (64, 128))
    cc = torch.cat([torch.arange(64, device="cuda"),
                    torch.full((64,), -1, device="cuda")])
    img = torch.rand(1, 128, 128, 3, device="cuda", generator=g)
    with torch.inference_mode():
        out = dict(
            unet_b64_ms=cuda_ms(lambda: unc["model"](x64, t64, None), 20),
            unet_cfg_b128_ms=cuda_ms(lambda: cls["model"](
                x128, t128, {"class_cond": cc}), 20),
            decode_b64_ms=cuda_ms(lambda: unc["codec"].decode(x64), 5),
            encode_b1_ms=cuda_ms(lambda: unc["codec"].encode(img), 5))
        out.update(profile_batch(lambda: sampler(
            unc["model"], unc["codec"], torch.Generator("cuda").manual_seed(0),
            batch_size=64, n_steps=20, latent_shape=(16, 16, 4))))
    top = out.pop("top_kernels")
    print("serving breakdown: " + " ".join(f"{k}={v:.4f}" for k, v in out.items())
          + f" | card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.2f}" for name, ms in top), flush=True)
    out["top_kernels"] = top
    return out


def profile_batch(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall seconds (profiler on),
    the device's busy seconds (sum of kernel times on the card), its idle
    share, the device time of the NA2D kernels (K1, K2), and the kernels
    that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    na2d_ms = sum(e.self_device_time_total for e in kernels if "na2d" in e.key) / 1e3
    return dict(profiled_batch_s=wall, device_busy_s=busy,
                device_idle_share=1.0 - busy / wall, na2d_kernels_ms=na2d_ms,
                top_kernels=[(e.key, e.self_device_time_total / 1e3) for e in top])


def check_small_input(paths: dict) -> None:
    """The CFG model and the codec on the card against copies on the CPU:
    RK4 + CFG (4 grid points) and decode for 2 samples, and an encode."""
    from flocoder_torch import generate_samples as gs
    from flocoder_torch.evaluation import sampler
    from flocoder_torch.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = gs.load_models_once(Config({}), paths["cfg"], torch.device("cuda"))
    cpu_model = copy.deepcopy(b["model"]).to("cpu")
    cpu_codec = copy.deepcopy(b["codec"]).to("cpu")
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    img = torch.from_numpy(rng.uniform(size=(1, 128, 128, 3)).astype(np.float32))
    cc = torch.tensor([3, 77])
    kw = dict(method="rk4", batch_size=2, n_steps=4, n_classes=102,
              latent_shape=(16, 16, 4), cfg_strength=3.0)
    out = {}
    for dev, model, codec in (("cuda", b["model"], b["codec"]),
                              ("cpu", cpu_model, cpu_codec)):
        lat, dec, _ = sampler(model, codec, torch.Generator(dev),
                              cond={"class_cond": cc.to(dev)},
                              source=src.to(dev), **kw)
        with torch.inference_mode():
            enc = codec.encode(img.to(dev))
        out[dev] = [t.float().cpu() for t in (lat, dec, enc)]
    for name, a, ref in zip(("latents", "images", "encoded"), out["cuda"], out["cpu"]):
        err = (a - ref).abs().max().item()
        tol = 1e-3 * max(1.0, ref.abs().max().item())
        print(f"card vs CPU {name} {tuple(a.shape)}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e})", flush=True)
        if not (np.isfinite(err) and err < tol):
            fail(f"card and CPU disagree on {name}")


def write_pngs(folder: str, n: int = 320, size: int = 128, seed: int = 3) -> str:
    """``n`` seeded random RGB PNGs (at 128², 10% go to validation, the rest
    give 4 training steps of 64 per epoch)."""
    from PIL import Image
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"img_{i:04d}.png"), compress_level=1)
    return folder


def train_flowers(tmp: str, card: str, kernels) -> tuple:
    """flowers_vqgan at full width through flocoder_torch.train_vqgan.main:
    one warmup and one GAN epoch of 4 steps at batch 64, one validation
    batch. Checks the kernels' launch counts, the losses and the
    checkpoint."""
    from flocoder_torch import train_vqgan as tv

    data = write_pngs(os.path.join(tmp, "flowers"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    na2d_fwd, na2d_bwd = kernels
    na2d_fwd.launches = na2d_bwd.launches = 0
    t0 = time.time()
    res = tv.main(["--config-name", "flowers_vqgan.yaml", f"data={data}",
                   "codec.epochs=2", "codec.warmup_epochs=1", "+seed=0",
                   f"+ckpt_dir={os.path.join(tmp, 'ckpt')}",
                   f"+output_dir={os.path.join(tmp, 'train_out')}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"na2d_fwd": na2d_fwd.launches, "na2d_bwd": na2d_bwd.launches}
    n_steps = {ph: len(t) for ph, t in res["step_seconds"].items()}
    steps = sum(n_steps.values())
    expected = {"na2d_fwd": 6 * steps + 6 * len(res["val"]), "na2d_bwd": 6 * steps}
    print(f"train launches: {launches} (expected {expected}; {n_steps} steps, "
          f"{len(res['val'])} validation batch)", flush=True)
    if launches != expected or min(n_steps.values()) < 4:
        fail(f"training launched {launches}, expected {expected} ({n_steps} steps)")
    losses = [v for e in res["epochs"] + res["val"] for k, v in e.items()
              if k not in ("epoch", "phase")]
    if not np.isfinite(losses).all():
        fail(f"training losses are not finite: {res['epochs']} {res['val']}")
    if res["checkpoint"] is None or not os.path.exists(res["checkpoint"]):
        fail("training wrote no checkpoint")
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = dict(batch=64, wall_s=wall, peak_mem_gib=peak, card=card,
               epochs=res["epochs"], val=res["val"])
    for ph, secs in res["step_seconds"].items():
        steady = secs[1:]
        (ep,) = [e for e in res["epoch_seconds"] if e["phase"] == ph]
        rec[ph] = dict(step_s=secs, steady_step_s=float(np.median(steady)),
                       samples_per_s=64 / float(np.median(steady)),
                       epoch_s=ep["seconds"],
                       epoch_samples_per_s=ep["samples"] / ep["seconds"],
                       outside_steps_s=ep["seconds"] - sum(secs))
    print(f"train flowers_vqgan B=64 128²: " + ", ".join(
        f"{ph} {r['samples_per_s']:.2f} samples/s over steady steps, "
        f"{r['epoch_samples_per_s']:.2f} over the epoch ({r['epoch_s']:.4f} s, "
        f"{r['outside_steps_s']:.4f} s outside the steps; steps "
        f"{[round(x, 4) for x in r['step_s']]})"
        for ph, r in ((ph, rec[ph]) for ph in ("warmup", "gan")))
          + f", peak {peak:.2f} GiB, wall {wall:.1f} s | card: {card}", flush=True)
    for e in res["epochs"] + res["val"]:
        print("  " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in e.items()), flush=True)
    return res["state"], rec, launches


def gan_breakdown(state, card: str) -> dict:
    """Where a GAN step's time goes, by CUDA events around its parts (the
    mean of 3 steps after one warm step), then one step under the
    profiler for the device's idle share."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.perceptual import make_perceptual_fn
    from flocoder_torch.training.vqgan import make_vqgan_gan_step

    cfg = load_config("flowers_vqgan.yaml", CONFIG_DIR)
    step = make_vqgan_gan_step(cfg, make_perceptual_fn(device="cuda"))
    gen = torch.Generator("cuda").manual_seed(6)
    x = torch.rand(64, 128, 128, 3, device="cuda", generator=gen) * 2 - 1
    names = ["codec_forward", "d_step", "g_loss_backward", "optimizers"]
    totals = dict.fromkeys(names, 0.0)
    for it in range(4):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name, events=events):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)

        step(state, x, gen, mark)
        torch.cuda.synchronize()
        if it:
            for i, n in enumerate(names):
                totals[n] += events[i].elapsed_time(events[i + 1]) / 3
    out = {f"{n}_ms": v for n, v in totals.items()}
    out["step_ms"] = sum(totals.values())
    out.update(profile_batch(lambda: step(state, x, gen)))
    top = out.pop("top_kernels")
    print("GAN step breakdown (B=64, 128²): " + " ".join(
        f"{k}={v:.4f}" for k, v in out.items()) + f" | card: {card}", flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.2f}" for name, ms in top), flush=True)
    out["top_kernels"] = top
    return out


def check_train_small() -> None:
    """One warmup step and one GAN step of a small codec (hidden 64: head
    dims 8-32, which K1 and K2 take), deterministic, on the card and on
    the CPU from the same weights and batches, TF32 off. Adam moves each
    weight by about ±lr whatever its gradient's size, so the gradients are
    held through Adam's first moments (0.9·0.1·g_warmup + 0.1·g_GAN for the
    codec after the two steps, 0.1·g for the discriminator, each clipped),
    within 1e-3 of the largest first moment of that model."""
    from flocoder_torch.config import load_config
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.models.codecs import NATTENBlock, VQVAE
    from flocoder_torch.models.discriminator import (VQGANPlusPatchDiscriminator,
                                                     init_discriminator)
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.models.perceptual import VGG16Features, make_perceptual_fn
    from flocoder_torch.training.checkpoint import (DISC_PREFIXES, VQVAE_PREFIXES,
                                                    to_jax_flat)
    from flocoder_torch.training.vqgan import (create_vqgan_state,
                                               make_vqgan_gan_step,
                                               make_vqgan_warmup_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config("smoke_vqgan.yaml", CONFIG_DIR, overrides=["codec.lambda_perc=0.001"])
    codec = init_params(VQVAE(hidden_channels=64, num_downsamples=3, internal_dim=64,
                              vq_embedding_dim=4, vq_num_embeddings=16,
                              codebook_levels=2, commitment_weight=0.5),
                        torch.Generator().manual_seed(0))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):      # so that K2's gradients reach the
            m.gamma.data.fill_(0.5)         # attention's projections
    rng = np.random.default_rng(7)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({   # initialised, no dead codes: the step draws nothing
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    disc = init_discriminator(VQGANPlusPatchDiscriminator(hidden_channels=16),
                              torch.Generator().manual_seed(1))
    vgg = init_params(VGG16Features(), torch.Generator().manual_seed(2))
    batches = [torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
               for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_vqgan_state(copy.deepcopy(codec).to(dev),
                                   copy.deepcopy(disc).to(dev), 1e-4)
        feat = make_perceptual_fn(model=copy.deepcopy(vgg), device=dev)
        warm = make_vqgan_warmup_step(cfg, feat, deterministic=True)
        gan = make_vqgan_gan_step(cfg, feat, deterministic=True)
        _, aux_w, _ = warm(state, batches[0].to(dev), torch.Generator(dev))
        _, aux_g, _ = gan(state, batches[1].to(dev), torch.Generator(dev))
        losses = {f"warmup/{k}": float(v) for k, v in aux_w.items()}
        losses.update({f"gan/{k}": float(v) for k, v in aux_g.items()})
        moments = {name: {n: opt.adam.state[p]["exp_avg"].cpu().numpy()
                          for n, p in model.named_parameters() if p in opt.adam.state}
                   for name, model, opt in (("codec", state.codec, state.opt_g),
                                            ("discriminator", state.disc, state.opt_d))}
        out[dev] = (losses, {**to_jax_flat(state.codec, VQVAE_PREFIXES),
                             **to_jax_flat(state.disc, DISC_PREFIXES)}, moments)
    (l_card, p_card, m_card), (l_cpu, p_cpu, m_cpu) = out["cuda"], out["cpu"]
    grad_report = []
    for model, ref_m in m_cpu.items():
        if set(ref_m) != set(m_card[model]) or not ref_m:
            fail(f"card and CPU optimise different {model} parameters")
        tol = 1e-3 * max(float(np.abs(r).max()) for r in ref_m.values())
        errs = {n: float(np.abs(m_card[model][n] - r).max()) for n, r in ref_m.items()}
        worst_n = max(errs, key=errs.get)
        if not (tol > 0 and all(np.isfinite(e) and e < tol for e in errs.values())):
            fail(f"card and CPU gradients disagree on {model} {worst_n}: "
                 f"{errs[worst_n]:.3e} (tol {tol:.3e})")
        grad_report.append(f"{model} {len(ref_m)} tensors, worst {worst_n} "
                           f"max_abs_err={errs[worst_n]:.3e} (tol {tol:.3e})")
    worst = ("", 0.0, 1.0)
    for name, ref in list(l_cpu.items()) + list(p_cpu.items()):
        a = l_card[name] if name in l_card else p_card[name]
        ref = np.asarray(ref, np.float64)
        err = float(np.abs(np.asarray(a, np.float64) - ref).max())
        tol = 1e-3 * max(1.0, float(np.abs(ref).max()))
        if not (np.isfinite(err) and err < tol):
            fail(f"card and CPU disagree after a training step on {name}: "
                 f"{err:.3e} (tol {tol:.3e})")
        if err / tol > worst[1] / worst[2]:
            worst = (name, err, tol)
    print("card vs CPU, one warmup + one GAN step (hidden 64): losses "
          + " ".join(f"{k}={l_card[k]:.5f}/{l_cpu[k]:.5f}" for k in sorted(l_cpu))
          + f"; {len(p_cpu)} parameter tensors, worst {worst[0]} max_abs_err="
          f"{worst[1]:.3e} (tol {worst[2]:.3e}); Adam first moments: "
          + "; ".join(grad_report), flush=True)


def hold_picks(label, zq, idx, zq_ref, idx_ref, x64, cb, rel=1e-5) -> dict:
    """Prints and enforces flocoder_torch.ops.fused_vq.check_quantized: each
    token's picks equal the reference's or are ε-optimal under the fp64
    distances from ``x64`` (relative gap < 1e-5); z_q within
    ``rel``·max(1, max|ref|) where the picks agree."""
    from flocoder_torch.ops.fused_vq import check_quantized
    res = check_quantized(zq, idx, zq_ref, idx_ref, x64, cb, rel)
    print(f"{label}: {res['differ']} of {res['tokens']} tokens pick other codes than "
          f"the reference, max relative gap of those {res['max_gap']:.2e} (tol 1e-05); "
          f"z_q max_abs_err={res['max_abs_err']:.3e} where the picks agree (tol "
          f"{res['tol']:.3e}) {'ok' if res['ok'] else 'FAIL'}", flush=True)
    if not res["ok"]:
        fail(f"{label}: picks or z_q disagree")
    return res


def check_fused_vq() -> dict:
    """K4, K3 and K5 against their plain twins on the card, TF32 off, at
    every D the source instantiates (3, 4, 8): K4 at a pre-encode batch of
    tokens (8192×128 → 4, 4×96 codes), the probe's shape (1024×256, 3×512),
    a ragged N=77 and N=300 at D=8 and D=3; K3 at a pre-encode batch
    (32×16²×128, both layouts of h), a ragged 5×7 map, a 20×20 map larger
    than the block, D=3 with one group and D=8 with two; K5 at the probe's
    (4, 16, 16, 256) and a ragged one, against the twin and the fp64 oracle
    within 1e-5·max(1, max|ref|). Returns per kernel the worst numbers."""
    from flocoder_torch.ops import fused_vq as fvq
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(7)
    out = {}

    def worst(name, r):
        w = out.setdefault(name, {"max_abs_err": 0.0, "differ": 0, "tokens": 0,
                                  "max_gap": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], r["max_abs_err"])
        w["max_gap"] = max(w["max_gap"], r.get("max_gap", 0.0))
        w["differ"] += r.get("differ", 0)
        w["tokens"] += r.get("tokens", 0)

    for label, shape in (("pre-encode batch", (8192, 128, 4, 4, 96)),
                         ("probe", (1024, 256, 4, 3, 512)), ("ragged", (77, 128, 4, 4, 96)),
                         ("D=8", (300, 64, 8, 2, 64)), ("D=3", (300, 64, 3, 2, 64))):
        z, w, b, cb = fvq.random_vq_inputs(g, *shape)
        zq, idx = fvq.fused_compress_vq(z, w, b, cb)
        torch.cuda.synchronize()
        worst("fused_compress_vq", hold_picks(
            f"K4 check {label} N,Din,D,L,K={shape}", zq, idx,
            *fvq.fused_compress_vq_plain(z, w, b, cb),
            z.double() @ w.double() + b.double(), cb))
    for label, shape, nchw in (
            ("pre-encode batch", (32, 16, 16, 128, 4, 4, 96, 2), True),
            ("pre-encode batch, NHWC memory", (32, 16, 16, 128, 4, 4, 96, 2), False),
            ("ragged 5x7", (3, 5, 7, 128, 4, 4, 96, 2), True),
            ("20x20, more tokens than threads", (2, 20, 20, 128, 4, 4, 96, 2), True),
            ("D=3 groups=1", (4, 16, 16, 128, 3, 4, 96, 1), True),
            ("D=8 groups=2", (4, 16, 16, 128, 8, 4, 96, 2), True)):
        h, tail, cb = fvq.random_tail_inputs(g, *shape, nchw=nchw)
        groups = shape[-1]
        zq, idx = fvq.fused_compress_tail_vq(h, *tail, cb, groups)
        torch.cuda.synchronize()
        worst("fused_compress_tail_vq", hold_picks(
            f"K3 check {label} B,H,W,Din,D,L,K,groups={shape}", zq, idx,
            *fvq.fused_compress_tail_vq_plain(h, *tail, cb, groups),
            fvq.compress_tail_oracle(h, *tail, groups)[2], cb))
    for label, shape in (("probe", (4, 16, 16, 256, 4, 1, 1, 2)),
                         ("ragged 5x7 D=3", (3, 5, 7, 64, 3, 1, 1, 1))):
        h, tail, _ = fvq.random_tail_inputs(g, *shape)
        groups = shape[-1]
        ours = fvq.compress_tail_debug(h, *tail, groups)
        torch.cuda.synchronize()
        twin = fvq.compress_tail_debug_plain(h, *tail, groups)
        oracle = fvq.compress_tail_oracle(h, *tail, groups)
        for name, a, ref, ref64 in zip(("y1", "y2", "out"), ours, twin, oracle):
            for what, r in (("twin", ref), ("fp64 oracle", ref64)):
                err = (a.double() - r.double()).abs().max().item()
                tol = 1e-5 * max(1.0, r.abs().max().item())
                ok = bool(np.isfinite(err)) and err < tol
                print(f"K5 check {label} {shape[:5]} {name} vs {what}: max_abs_err="
                      f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K5 disagrees with its {what} at {label} ({name})")
                worst("compress_tail_debug", {"max_abs_err": err})
    return out


def fused_vq_bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """(least ms, 'bytes' or 'operations') against HBM bytes and fp32 FLOPs."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_fused_vq(card: str) -> dict:
    """K4, K3 and K5 at their main shapes (K3 and K4: one pre-encode batch of
    flowers_vqgan, 32×16² tokens of 128 channels → D=4, 4×96 codes; K5: the
    probe's 4×16²×256), TF32 off: CUDA events over back-to-back calls, the
    profiler's device time of the kernel alone, the plain twin, and the
    unfused torch path (cuBLAS/cuDNN 1×1 conv → GroupNorm → SiLU → 3×3 conv
    → ``rvq_apply``, as the codec's ``quantize(encode(x))`` runs it; for K4
    ``addmm`` → ``rvq_apply``): no single PyTorch call computes these
    functions, so that path is the library yardstick. The bound counts each
    input read once and each output written once, against the fp32
    operations: 2·Din·D per token for the 1×1, 18·D² for the 3×3, 10·D for
    GroupNorm + SiLU, and L·(K·(2·D + 3) + 2·D) for the search."""
    import torch.nn.functional as F
    from flocoder_torch.ops import fused_vq as fvq
    from flocoder_torch.ops.rvq import RVQState, rvq_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(8)
    out = {}

    def state(cb):
        st = RVQState(*cb.shape).cuda()
        st.codebooks.copy_(cb)
        return st

    def measure(name, key, kernel, plain, library, n_bytes, n_ops):
        with torch.inference_mode():
            ms = cuda_ms(kernel, 200, warmup=5)
            dev_ms = device_ms(kernel, key, iters=20)
            plain_ms = cuda_ms(plain, 50, warmup=3)
            library_ms = cuda_ms(library, 50, warmup=3)
        bound_ms, bound_by = fused_vq_bound_ms(n_bytes, n_ops)
        print(f"{name} time: kernel_ms={ms:.5f} device_ms={dev_ms:.5f} plain_ms="
              f"{plain_ms:.5f} library_ms={library_ms:.5f} (unfused torch path) "
              f"bound_ms={bound_ms:.5f} ({bound_by}; {n_bytes / 1e6:.3f} MB, "
              f"{n_ops / 1e6:.2f} MFLOP) | card: {card}", flush=True)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)

    def search_ops(n, D, L, K):
        return n * L * (K * (2 * D + 3) + 2 * D)

    N, Din, D, L, K = 8192, 128, 4, 4, 96
    z, w, b, cb = fvq.random_vq_inputs(g, N, Din, D, L, K)
    st = state(cb)
    measure("fused_compress_vq", "compress_vq_kernel",
            lambda: fvq.fused_compress_vq(z, w, b, cb),
            lambda: fvq.fused_compress_vq_plain(z, w, b, cb),
            lambda: rvq_apply(st, torch.addmm(b, z, w))[:2],
            4 * (N * Din + Din * D + D + L * K * D + N * D + N * L),
            2 * N * Din * D + search_ops(N, D, L, K))

    B, H, W, Din, groups = 32, 16, 16, 128, 2
    n = B * H * W
    h, tail, cb = fvq.random_tail_inputs(g, B, H, W, Din, D, L, K, groups)
    w1, b1, gs, gb, cw, cbias = tail
    st = state(cb)
    h_nchw = h.permute(0, 3, 1, 2)

    def unfused_tail(x):
        y = F.silu(F.group_norm(F.conv2d(x, w1, b1), groups, gs, gb, 1e-5))
        return F.conv2d(y, cw, cbias, padding=1)

    tail_bytes = 4 * (n * Din + D * Din + 4 * D + 9 * D * D)
    tail_ops = n * (2 * Din * D + 18 * D * D + 10 * D)
    with torch.inference_mode():
        lib_zq, lib_idx = rvq_apply(st, unfused_tail(h_nchw).permute(0, 2, 3, 1)
                                    .reshape(-1, D))[:2]
        zq, idx = fvq.fused_compress_tail_vq(h, *tail, cb, groups)
    hold_picks("K3 against the unfused torch path (its yardstick)", zq, idx, lib_zq,
               lib_idx, fvq.compress_tail_oracle(h, *tail, groups)[2], cb, rel=1e-4)
    measure("fused_compress_tail_vq", "tail_kernel<4, true>",
            lambda: fvq.fused_compress_tail_vq(h, *tail, cb, groups),
            lambda: fvq.fused_compress_tail_vq_plain(h, *tail, cb, groups),
            lambda: rvq_apply(st, unfused_tail(h_nchw).permute(0, 2, 3, 1)
                              .reshape(-1, D))[:2],
            tail_bytes + 4 * (L * K * D + n * D + n * L),
            tail_ops + search_ops(n, D, L, K))

    B, Din = 4, 256
    n = B * H * W
    h, tail, _ = fvq.random_tail_inputs(g, B, H, W, Din, D, 1, 1, groups)
    w1, b1, gs, gb, cw, cbias = tail
    h_nchw = h.permute(0, 3, 1, 2)
    measure("compress_tail_debug", "tail_kernel<4, false>",
            lambda: fvq.compress_tail_debug(h, *tail, groups),
            lambda: fvq.compress_tail_debug_plain(h, *tail, groups),
            lambda: unfused_tail(h_nchw),
            4 * (n * Din + D * Din + 4 * D + 9 * D * D + 3 * n * D),
            n * (2 * Din * D + 18 * D * D + 10 * D))
    torch.cuda.empty_cache()
    return out


def _tail_oracle_of(codec, h):
    """The fp64 compression tail of ``codec`` on its pre-compress
    activations ``h``."""
    from flocoder_torch.models.codecs import gn_groups
    from flocoder_torch.ops.fused_vq import compress_tail_oracle
    enc = codec.encoder
    return compress_tail_oracle(h, enc.Conv_1.weight, enc.Conv_1.bias,
                                enc.GroupNorm_0.weight, enc.GroupNorm_0.bias,
                                enc.Conv_2.weight, enc.Conv_2.bias,
                                gn_groups(2, codec.vq_embedding_dim),
                                enc.GroupNorm_0.eps)[2]


def rebuilt_batches(argv: list, split: str):
    """The pixel batches that flocoder_torch.preencode_data.main(argv)
    encoded for ``split``, rebuilt by its open_split from the same config
    (the same seed gives the same pixels)."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.config import parse_cli
    from flocoder_torch.generate_samples import CONFIG_DIR
    _, _, batches = pe.open_split(parse_cli(argv, config_dir=CONFIG_DIR), split)
    return batches


def preencode_flowers(tmp: str, paths: dict, card: str, kernels: dict) -> tuple:
    """flowers_vqgan at full width (128², hidden 256, 3 downsamples, RVQ
    4×96×4) pre-encoded through flocoder_torch.preencode_data.main with
    ``preencoding.quantize=true preencoding.fused_vq=true``, batch 32 (the
    recipe's), ``augs_per=4`` (the recipe's 1024, cut for time) over 320
    seeded random 500² PNGs (decoding, rotating and cropping them costs the
    host what Oxford Flowers' ~500-px images cost): 4 val and 36 train
    batches. Checks the launch counts (5 K1 and 1 K3 per batch, no other
    kernel), reads the latents back through PreEncodedDataset, and holds the
    first batch's fused picks against the unfused path's, TF32 off. Times a
    batch's encode fused against unfused, and profiles one batch."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.data.datasets import PreEncodedDataset

    data = write_pngs(os.path.join(tmp, "pe_images"), n=320, size=500, seed=4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    argv = ["--config-name", "flowers_vqgan.yaml", f"data={data}",
            f"codec.checkpoint={paths['codec']}", "preencoding.quantize=true",
            "preencoding.fused_vq=true", "preencoding.augs_per=4", "+seed=0"]
    t0 = time.time()
    res = pe.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    splits = {s: res[s] for s in ("val", "train")}
    batches = sum(r["batches"] for r in splits.values())
    expected = dict.fromkeys(kernels, 0)
    expected.update(na2d_fwd=5 * batches, fused_compress_tail_vq=batches)
    print(f"pre-encode launches: {launches} (expected {expected}; {batches} batches)",
          flush=True)
    if launches != expected or [r["batches"] for r in splits.values()] != [4, 36]:
        fail(f"pre-encoding launched {launches}, expected {expected} "
             f"({[r['batches'] for r in splits.values()]} batches)")
    for split, r in splits.items():
        ds = PreEncodedDataset(r["out_dir"])
        lat = [ds.get(i, np.random.default_rng(0))[0] for i in range(len(ds))]
        if len(lat) != r["latents"] or r["latents"] != 32 * r["batches"] or any(
                a.shape != (16, 16, 4) or not np.isfinite(a).all() for a in lat):
            fail(f"pre-encode {split}: {len(lat)} latents read back of "
                 f"{r['latents']}, shapes {sorted({a.shape for a in lat})}")

    codec = res["codec"]
    val_batches = rebuilt_batches(argv, "val")
    x = torch.from_numpy(next(val_batches)["pixels"]).cuda()
    val_batches.close()
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        h = codec.encoder(x, stop_before_compress=True)
        layout = "NHWC" if h.is_contiguous() else "NCHW"
        print(f"pre-encode: the encoder hands K3 h {tuple(h.shape)} in {layout} "
              "memory", flush=True)
        zq_f, idx_f = codec.encode_quantize_fused(x)
        zq_u, idx_u, _, _ = codec.quantize(codec.encode(x))
        picks = hold_picks("pre-encode first batch, fused (K3) against unfused "
                           "(cuDNN + rvq_apply), TF32 off", zq_f, idx_f, zq_u, idx_u,
                           _tail_oracle_of(codec, h), codec.vq.codebooks)
    torch.backends.cudnn.allow_tf32 = True
    x_host = x.cpu().numpy()
    with torch.inference_mode():
        fused_ms = cuda_ms(lambda: codec.encode_quantize_fused(x), 10)
        unfused_ms = cuda_ms(lambda: codec.quantize(codec.encode(x))[0], 10)
        prof = profile_batch(lambda: codec.encode_quantize_fused(
            torch.from_numpy(x_host).cuda())[0].cpu())
    top = prof.pop("top_kernels")
    # K1's least time in one batch: the encoder's five NATTEN blocks at B=32
    # (two at 32²×512, two at 16²×1024, one at 16²×128; 8 heads, k=7)
    prof["na2d_bound_ms"] = sum(na2d_bound_ms(32, s, s, c, 7, torch.float32)[0]
                                for s, c in ((32, 512), (32, 512), (16, 1024),
                                             (16, 1024), (16, 128)))
    rec_out = dict(batch=32, batches=batches, wall_s=wall, peak_mem_gib=peak,
                   card=card, encode_fused_ms=fused_ms, encode_unfused_ms=unfused_ms,
                   first_batch_picks=picks, h_memory=layout, **prof,
                   **{f"{s}_latents_per_s": r["latents_per_s"] for s, r in splits.items()},
                   **{f"{s}_seconds": r["seconds"] for s, r in splits.items()})
    print(f"pre-encode flowers_vqgan B=32 128² (fused_vq): val "
          f"{splits['val']['latents_per_s']:.2f} latents/s ({splits['val']['seconds']:.3f} s),"
          f" train {splits['train']['latents_per_s']:.2f} latents/s "
          f"({splits['train']['seconds']:.3f} s), wall {wall:.1f} s, peak {peak:.2f} GiB; "
          f"encode per batch fused {fused_ms:.4f} ms, unfused {unfused_ms:.4f} ms "
          f"(CUDA events, cuDNN TF32 on); one batch under the profiler: "
          f"{prof['profiled_batch_s']:.4f} s wall, {prof['device_busy_s']:.4f} s busy, "
          f"idle share {prof['device_idle_share']:.4f}, K1 {prof['na2d_kernels_ms']:.4f} ms "
          f"of it (5 launches, bound {prof['na2d_bound_ms']:.4f} ms) | card: {card}",
          flush=True)
    print("  device time by kernel (ms): " + "; ".join(
        f"{name[:60]}={ms:.3f}" for name, ms in top), flush=True)
    del codec, res, x, h
    torch.cuda.empty_cache()
    return rec_out, launches


def check_preencode_small(tmp: str, config_dir: str) -> dict:
    """A small codec (flowers_vqgan at hidden 64, internal 64, 64² images)
    pre-encodes the same folder of 10 PNGs through
    flocoder_torch.preencode_data.main on the card and with +device=cpu,
    TF32 off (batch 8, augs_per 2: two batches of 1 in val, two of 8 in
    train). Each batch, rebuilt from the same config, is encoded by both
    runs' codecs: the card's picks must equal the CPU's or be ε-optimal
    under the fp64 tail of the card's own activations. The latent files
    must agree within 1e-4·max(1, |ref|) except at the tokens whose picks
    differ."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch.config import load_config
    from flocoder_torch.models.codecs import NATTENBlock, setup_codec
    from flocoder_torch.models.layers import init_params
    from flocoder_torch.training.checkpoint import (VQVAE_PREFIXES, save_checkpoint,
                                                    to_jax_flat)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = ["codec.hidden_channels=64", "codec.internal_dim=64", "codec.image_size=64"]
    cfg = load_config("flowers_vqgan.yaml", config_dir, small)
    codec = init_params(setup_codec(cfg, device="cuda"),
                        torch.Generator("cuda").manual_seed(10))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):
            m.gamma.data.fill_(1.0)
    scale_codebooks(codec, 64)
    ckpt = save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), 0,
                           ckpt_dir=os.path.join(tmp, "small_ckpt"), prefix="vqgan_")
    src = write_pngs(os.path.join(tmp, "pe_small"), n=10, size=64, seed=5)
    runs = {}
    for i, dev in enumerate(("cuda", "cpu")):
        data = f"{src}_{i}"
        shutil.copytree(src, data)
        argv = ["--config-name", "flowers_vqgan.yaml", f"data={data}", *small,
                f"codec.checkpoint={ckpt}", "preencoding.quantize=true",
                "preencoding.fused_vq=true", "preencoding.batch_size=8",
                "preencoding.augs_per=2", "preencoding.num_workers=2", "+seed=0"]
        runs[dev] = pe.main(argv + (["+device=cpu"] if dev == "cpu" else []))
    res_card, res_cpu = runs["cuda"], runs["cpu"]
    codec, codec_cpu = res_card["codec"], res_cpu["codec"]
    totals = {"tokens": 0, "differ": 0, "max_gap": 0.0, "max_abs_err": 0.0}
    n_batches = 0
    for split in ("val", "train"):
        for batch in rebuilt_batches(argv, split):
            x = torch.from_numpy(batch["pixels"])
            with torch.inference_mode():
                zq_c, idx_c = codec.encode_quantize_fused(x.cuda())
                zq_p, idx_p = codec_cpu.encode_quantize_fused(x)
                out64 = _tail_oracle_of(codec, codec.encoder(x.cuda(),
                                                             stop_before_compress=True))
            r = hold_picks(f"card vs CPU pre-encode {split} batch {tuple(x.shape)}",
                           zq_c.cpu(), idx_c.cpu(), zq_p, idx_p, out64.cpu(),
                           codec.vq.codebooks.cpu(), rel=1e-4)
            n_batches += 1
            for k in ("tokens", "differ"):
                totals[k] += r[k]
            for k in ("max_gap", "max_abs_err"):
                totals[k] = max(totals[k], r[k])
    if n_batches != 4:
        fail(f"small pre-encode: {n_batches} batches rebuilt, not 4")
    files = 0
    far = 0
    for split in ("val", "train"):
        a_dir, b_dir = res_card[split]["out_dir"], res_cpu[split]["out_dir"]
        names = sorted(os.path.relpath(os.path.join(r, f), a_dir)
                       for r, _, fs in os.walk(a_dir) for f in fs)
        names_cpu = sorted(os.path.relpath(os.path.join(r, f), b_dir)
                           for r, _, fs in os.walk(b_dir) for f in fs)
        if names != names_cpu or not names:
            fail(f"small pre-encode {split}: card and CPU wrote different files")
        for name in names:
            a, ref = np.load(os.path.join(a_dir, name)), np.load(os.path.join(b_dir, name))
            tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
            far += int((np.abs(a - ref).max(-1) > tol).sum())
            files += 1
    print(f"card vs CPU pre-encode (hidden 64, 64², {files} files): {far} latent "
          f"vectors off by more than 1e-4·max(1, |ref|), {totals['differ']} of "
          f"{totals['tokens']} tokens with other picks", flush=True)
    if far > totals["differ"]:
        fail("card and CPU latent files disagree beyond the tokens whose picks differ")
    return dict(totals, files=files, far_vectors=far)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.ops.kernels import fused_vq as fvk
    from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
    from flocoder_torch.ops.neighborhood_attention import (na2d, na2d_banded,
                                                          na2d_bwd_banded)
    kernels = {"na2d_fwd": na2d_fwd, "na2d_bwd": na2d_bwd,
               "fused_compress_vq": fvk.fused_compress_vq,
               "fused_compress_tail_vq": fvk.fused_compress_tail_vq,
               "compress_tail_debug": fvk.compress_tail_debug}
    fused = ("fused_compress_vq", "fused_compress_tail_vq", "compress_tail_debug")

    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:      # one nvcc per source, together
        for f in [pool.submit(k.build) for k in (na2d_fwd, na2d_bwd,
                                                  fvk.fused_compress_tail_vq)]:
            f.result()
    for name in fused:                       # the library fused_vq.cu built
        kernels[name].build()
    print(f"K1 + K2 + K3/K4/K5 build: {time.time() - t0:.1f} s", flush=True)
    errs = check_k1(na2d_fwd, na2d_banded)
    errs2 = check_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded)
    check_function(na2d, na2d_banded)
    timing, decode_err = time_k1(na2d_fwd, na2d_banded, card)
    errs[torch.float32] = max(errs[torch.float32], decode_err)
    timing2, train_err = time_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded, na2d, card)
    errs2[torch.float32] = max(errs2[torch.float32], train_err)
    shapes = time_na2d_shapes(na2d_fwd, na2d_bwd, card)
    fused_errs = check_fused_vq()
    fused_timing = time_fused_vq(card)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
        paths = write_checkpoints(tmp, CONFIG_DIR)
        torch.cuda.empty_cache()
        for name in ("na2d_bwd", *fused):
            kernels[name].launches = 0
        serving, serve_launches = serve(tmp, paths, card, na2d_fwd)
        if na2d_bwd.launches:
            fail(f"serving launched K2 {na2d_bwd.launches} times")
        parts = breakdown(paths, card)
        state, training, train_launches = train_flowers(tmp, card, (na2d_fwd, na2d_bwd))
        gan_parts = gan_breakdown(state, card)
        del state
        torch.cuda.empty_cache()
        if any(kernels[name].launches for name in fused):
            fail("serving or training launched a fused VQ kernel: "
                 f"{ {name: kernels[name].launches for name in fused} }")
        check_small_input(paths)
        check_train_small()
        preencode, pre_launches = preencode_flowers(tmp, paths, card, kernels)
        preencode_small = check_preencode_small(tmp, CONFIG_DIR)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"serving": serving, "breakdown": parts, "training": training,
                      "gan_breakdown": gan_parts, "preencode": preencode,
                      "preencode_card_vs_cpu": preencode_small}))

    def fused_entry(name, replaces):
        by_path = {"serve": 0, "train": 0, "preencode": pre_launches[name]}
        return {"name": name, "route": "cuda", "source": "flocoder_torch/csrc/fused_vq.cu",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, **fused_errs[name], **fused_timing[name]}

    print(json.dumps({"kernels": [
        {"name": "na2d_fwd", "route": "cuda",
         "source": "flocoder_torch/csrc/na2d_fwd.cu",
         "replaces": "flocoder_tpu/ops/pallas/na2d.py:40",
         "launches": serve_launches + train_launches["na2d_fwd"] + pre_launches["na2d_fwd"],
         "launches_by_path": {"serve": serve_launches,
                              "train": train_launches["na2d_fwd"],
                              "preencode": pre_launches["na2d_fwd"]},
         "max_abs_err": errs[torch.float32],
         "max_abs_err_bf16": errs[torch.bfloat16], **timing,
         "per_shape": [r for r in shapes if r["kernel"] == "na2d_fwd"]},
        {"name": "na2d_bwd", "route": "cuda",
         "source": "flocoder_torch/csrc/na2d_bwd.cu",
         "replaces": "flocoder_tpu/ops/pallas/na2d.py:148",
         "launches": train_launches["na2d_bwd"],
         "launches_by_path": {"serve": 0, "train": train_launches["na2d_bwd"],
                              "preencode": pre_launches["na2d_bwd"]},
         "max_abs_err": errs2[torch.float32],
         "max_abs_err_bf16": errs2[torch.bfloat16], **timing2,
         "per_shape": [r for r in shapes if r["kernel"] == "na2d_bwd"]},
        fused_entry("fused_compress_tail_vq", "flocoder_tpu/ops/pallas/fused_vq.py:134"),
        fused_entry("fused_compress_vq", "flocoder_tpu/ops/pallas/fused_vq.py:80"),
        fused_entry("compress_tail_debug", "benchmarks/fused_probe.py:129")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
