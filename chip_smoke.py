#!/usr/bin/env python3
"""Smoke test of flocoder_torch on one CUDA card (an H100).

    python3 chip_smoke.py

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the hand-written kernels from the sources in this checkout, one
   nvcc each, started together: K1, the NA2D forward
   (flocoder_torch/csrc/na2d_fwd.cu), and K2, the NA2D backward
   (flocoder_torch/csrc/na2d_bwd.cu).
3. Holds K1 against its plain PyTorch version (na2d_banded) on the card, TF32
   off: the codec's shapes at B=8 (32²×512 with head dim 64, 16²×1024 with
   head dim 128, 16²×128 with head dim 16) and at the serving runs' batches
   (64 for the decode, 1 for img2img's encode), a non-square map, a map
   smaller than the window, a ragged one; fp32 (max |Δ| < 1e-4) and bf16
   (against the plain version in fp32 on the same bf16 values, max |Δ| <
   2e-2: one bf16 rounding of outputs of magnitude up to ~4).
4. Holds K2 against its plain twin (na2d_bwd_banded) at the training shapes
   at B=8 and the same non-square, smaller-than-window and ragged maps: fp32
   max |Δ| < 1e-4·max(1, max|ref|), bf16 < 3e-2·max(1, max|ref|) against the
   twin in fp32 on the same bf16 values; and the gradients of na2d on the
   card (NA2DFunction: K1 forward, K2 backward) against torch autograd of
   na2d_banded.
5. Times K1 and K2 at the decoder's shape (B=64, 32², C=512, fp32), by
   CUDA events over back-to-back calls and by the profiler's device time of
   the kernels alone, beside the plain versions, the least time the card
   could take, and
   F.scaled_dot_product_attention with the neighborhood mask (forward for
   K1, forward + backward against K1 + K2 for K2: a yardstick only; the
   port never calls it).
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
    cases = [  # (label, (B, H, W, C), heads, kernel_size)
        ("decoder/encoder 32x32 C512 dh64", (8, 32, 32, 512), 8, 7),
        ("encoder 16x16 C1024 dh128", (8, 16, 16, 1024), 8, 7),
        ("encoder 16x16 C128 dh16", (8, 16, 16, 128), 8, 7),
        # the serving runs' own shapes: decode at batch 64, img2img's encode
        # of one image (the decode at 64 is held in time_k1)
        ("serving encode 32x32 C512 dh64 B1", (1, 32, 32, 512), 8, 7),
        ("serving encode 16x16 C1024 dh128 B1", (1, 16, 16, 1024), 8, 7),
        ("serving encode 16x16 C128 dh16 B1", (1, 16, 16, 128), 8, 7),
        ("non-square 24x40 dh32", (2, 24, 40, 64), 2, 7),
        ("smaller than k 5x6 dh8 (ks=5)", (2, 5, 6, 32), 4, 7),
        ("ragged tiles 17x13 dh24", (2, 17, 13, 48), 2, 7),
    ]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, heads, ks in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
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


def write_checkpoints(tmp: str, config_dir: str):
    """Seeded random-init checkpoints in the npz contract for flowers_vqgan
    as composed: the VQGAN codec (128², hidden 256, 3 downsamples), an
    unconditional U-Net (dim 16, dim_mults 1,2,4,8) and a class-conditional
    one (n_classes 102). NATTEN gates are set to 1 so that K1's output
    reaches the images."""
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
    save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), 0, ckpt_dir=tmp,
                    prefix="vqgan_")
    H, W, C = codec.latent_shape(128)
    paths = {}
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


def write_pngs(folder: str, n: int = 320, size: int = 128) -> str:
    """``n`` seeded random RGB PNGs: 10% go to validation, the rest give
    4 training steps of 64 per epoch."""
    from PIL import Image
    os.makedirs(folder)
    rng = np.random.default_rng(3)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"img_{i:04d}.png"))
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
    from flocoder_torch.ops.neighborhood_attention import (na2d, na2d_banded,
                                                          na2d_bwd_banded)

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:      # one nvcc per source, together
        for f in [pool.submit(k.build) for k in (na2d_fwd, na2d_bwd)]:
            f.result()
    print(f"K1 + K2 build: {time.time() - t0:.1f} s", flush=True)
    errs = check_k1(na2d_fwd, na2d_banded)
    errs2 = check_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded)
    check_function(na2d, na2d_banded)
    timing, decode_err = time_k1(na2d_fwd, na2d_banded, card)
    errs[torch.float32] = max(errs[torch.float32], decode_err)
    timing2, train_err = time_k2(na2d_fwd, na2d_bwd, na2d_bwd_banded, na2d, card)
    errs2[torch.float32] = max(errs2[torch.float32], train_err)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
        paths = write_checkpoints(tmp, CONFIG_DIR)
        torch.cuda.empty_cache()
        na2d_bwd.launches = 0
        serving, serve_launches = serve(tmp, paths, card, na2d_fwd)
        if na2d_bwd.launches:
            fail(f"serving launched K2 {na2d_bwd.launches} times")
        parts = breakdown(paths, card)
        state, training, train_launches = train_flowers(tmp, card, (na2d_fwd, na2d_bwd))
        gan_parts = gan_breakdown(state, card)
        del state
        torch.cuda.empty_cache()
        check_small_input(paths)
        check_train_small()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"serving": serving, "breakdown": parts, "training": training,
                      "gan_breakdown": gan_parts}))
    print(json.dumps({"kernels": [
        {"name": "na2d_fwd", "route": "cuda",
         "source": "flocoder_torch/csrc/na2d_fwd.cu",
         "replaces": "flocoder_tpu/ops/pallas/na2d.py:40",
         "launches": serve_launches + train_launches["na2d_fwd"],
         "launches_by_path": {"serve": serve_launches,
                              "train": train_launches["na2d_fwd"]},
         "max_abs_err": errs[torch.float32],
         "max_abs_err_bf16": errs[torch.bfloat16], **timing},
        {"name": "na2d_bwd", "route": "cuda",
         "source": "flocoder_torch/csrc/na2d_bwd.cu",
         "replaces": "flocoder_tpu/ops/pallas/na2d.py:148",
         "launches": train_launches["na2d_bwd"],
         "launches_by_path": {"serve": 0, "train": train_launches["na2d_bwd"]},
         "max_abs_err": errs2[torch.float32],
         "max_abs_err_bf16": errs2[torch.bfloat16], **timing2}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
