#!/usr/bin/env python3
"""Smoke test of flocoder_torch on one CUDA card (an H100).

    python3 chip_smoke.py

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds K1, the hand-written NA2D forward kernel
   (flocoder_torch/csrc/na2d_fwd.cu), from the sources in this checkout.
3. Holds K1 against its plain PyTorch version (na2d_banded) on the card, TF32
   off: the codec's shapes at B=8 (32²×512 with head dim 64, 16²×1024 with
   head dim 128, 16²×128 with head dim 16) and at the serving runs' batches
   (64 for the decode, 1 for img2img's encode), a non-square map, a map
   smaller than the window, a ragged one; fp32 (max |Δ| < 1e-4) and bf16 (against
   the plain version in fp32 on the same bf16 values, max |Δ| < 2e-2: one
   bf16 rounding of outputs of magnitude up to ~4).
4. Times K1 at the decoder's shape (B=64, 32², C=512, fp32) beside the plain
   version, the least time the card could take, and one
   F.scaled_dot_product_attention call with the neighborhood mask (a
   yardstick only; the port never calls it).
5. Serves flowers_vqgan at full width through the port's entry point
   (flocoder_torch.generate_samples.main) from seeded random-init
   checkpoints: unconditional, class-conditional with CFG (n_classes=102),
   and img2img from an init image (which runs the encoder). K1's launch
   count is zeroed before and read after these runs. Then times the parts
   of a serving batch: a U-Net forward, a decode, an encode.
6. Checks a small input end to end against the same models on the CPU
   (RK4 + CFG sampler and decode, and the encoder), TF32 off.

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
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) | bf16: kernel_ms={bf16_ms:.4f} "
          f"bound_ms={bf16_bound:.4f} | card: {card}", flush=True)
    del q, k, v, qb, kb, vb, qs, ks_, vs, lib, out
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by), err


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
    share, and the kernels that took the most device time."""
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
    return dict(profiled_batch_s=wall, device_busy_s=busy,
                device_idle_share=1.0 - busy / wall,
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from flocoder_torch.generate_samples import CONFIG_DIR
    from flocoder_torch.ops.kernels.na2d import na2d_fwd
    from flocoder_torch.ops.neighborhood_attention import na2d_banded

    t0 = time.time()
    na2d_fwd.build()
    print(f"K1 build: {time.time() - t0:.1f} s", flush=True)
    errs = check_k1(na2d_fwd, na2d_banded)
    timing, decode_err = time_k1(na2d_fwd, na2d_banded, card)
    errs[torch.float32] = max(errs[torch.float32], decode_err)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
        paths = write_checkpoints(tmp, CONFIG_DIR)
        torch.cuda.empty_cache()
        serving, launches = serve(tmp, paths, card, na2d_fwd)
        parts = breakdown(paths, card)
        check_small_input(paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"serving": serving, "breakdown": parts}))
    print(json.dumps({"kernels": [{
        "name": "na2d_fwd", "route": "cuda",
        "source": "flocoder_torch/csrc/na2d_fwd.cu",
        "replaces": "flocoder_tpu/ops/pallas/na2d.py:40",
        "launches": launches, "max_abs_err": errs[torch.float32],
        "max_abs_err_bf16": errs[torch.bfloat16], **timing}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
