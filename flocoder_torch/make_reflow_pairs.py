"""Make a paired (noise, sample) dataset from a trained flow checkpoint on the
CUDA card, for a rectified-flow reflow pass — the port of the repo's
``tools/make_reflow_pairs.py``.

Usage:
    python -m flocoder_torch.make_reflow_pairs --config-name flowers_hdit.yaml \\
        +flow_checkpoint=checkpoints/flowema_100.npz +out_dir=data_reflow_pairs \\
        +n_pairs=50000 [+val_frac=0.05] [+method=rk4] [+n_steps=50] \\
        [+cfg_strength=3.0] [+batch_size=256] [+seed=0]

Without ``+flow_checkpoint`` the newest ``checkpoints/flowema_*`` (else
``flow_*``) is the teacher. The teacher is loaded as serving loads it
(``generate_samples.load_models_once``): it samples in the dtype it was
trained in (bf16 for ``flow.bf16=true``; ``+bf16=false`` asks for fp32).
Each batch is a full ``batch_size``: ``batch_size`` noises from a
``torch.Generator`` seeded with ``seed`` on the device, and labels drawn
uniformly by ``np.random.default_rng(seed)`` as the JAX tool draws them, are
integrated from t=0 to 1 with ``method`` over ``n_steps`` grid points and
CFG at ``cfg_strength``; the pairs beyond ``n_pairs`` in the last batch are
discarded. Writes ``out_dir/{train,val}/<label %04d, or data without
classes>/b<batch %06d>_<i %03d>.npz``, each holding exactly
``target_latents`` (the sample) and ``source_latents`` (the noise it was
integrated from), both float32 — the JAX tool's tree, which both packages'
``PreEncodedDataset`` read. Every ``1/val_frac``-th pair goes to ``val``
until it holds ``int(n_pairs · val_frac)``. A non-empty ``out_dir`` is
refused. Retrain with ``python -m flocoder_torch.train_flow ...
data=<out_dir> +reflow=true``, then serve at few steps with
``generate_samples +method=euler +n_steps=5`` (4 NFE).

The noise cannot equal the JAX tool's (Philox is not threefry):
``sample_pairs`` takes the noise and the labels, so tests inject both.
``+device=cpu`` runs on the CPU; without it the run needs a CUDA device.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import ldcfg, parse_cli
from .generate_samples import CONFIG_DIR, load_models_once
from .models.codecs import latest_checkpoint
from .sampling import generate_latents
from .utils.device import resolve_device

__all__ = ["sample_pairs", "make_reflow_pairs", "main"]


@torch.inference_mode()
def sample_pairs(model, noise: torch.Tensor, labels, n_classes: int,
                 method: str = "rk4", n_steps: int = 50,
                 cfg_strength: float = 3.0) -> tuple:
    """Integrate ``noise`` (B, H, W, C) to samples with the velocity field
    ``model(x, t, cond)``, class-conditioned on ``labels`` (B,) with CFG when
    ``n_classes > 0``. Returns ``(latents, nfe)``."""
    cond = (None if n_classes == 0 else
            {"class_cond": torch.as_tensor(labels, device=noise.device).long(),
             "mask_cond": None})
    return generate_latents(model, tuple(noise.shape), None, method=method,
                            n_steps=n_steps, cond=cond, cfg_strength=cfg_strength,
                            source=noise)


def make_reflow_pairs(config, device=None) -> dict:
    """Returns ``{'out_dir', 'train', 'val' (pairs written), 'batches',
    'nfe' (per batch), 'batch_seconds', 'seconds', 'pairs_per_s'}``; the
    seconds run from the first batch's noise to the last file written."""
    device = resolve_device(device if device is not None else config.get("device", None))
    flow_ckpt = str(config.get("flow_checkpoint", "") or
                    ldcfg(config, "flow_checkpoint", ""))
    if not flow_ckpt:
        flow_ckpt = (latest_checkpoint("checkpoints", "flowema_") or
                     latest_checkpoint("checkpoints", "flow_") or "")
    if not flow_ckpt or not os.path.exists(flow_ckpt):
        raise SystemExit(f"flow checkpoint not found: {flow_ckpt!r} "
                         "(pass +flow_checkpoint=...)")
    n_pairs = int(config.get("n_pairs", 10000))
    val_frac = float(config.get("val_frac", 0.05))
    batch_size = int(config.get("batch_size", ldcfg(config, "batch_size", 256)))
    n_steps = int(config.get("n_steps", ldcfg(config, "n_steps", 50)))
    method = str(config.get("method", "rk4"))
    cfg_strength = float(config.get("cfg_strength", ldcfg(config, "cfg_strength", 3.0)))
    out_dir = os.path.expanduser(str(config.get("out_dir", "data_reflow_pairs")))
    seed = int(config.get("seed", 0))
    if os.path.exists(out_dir) and os.listdir(out_dir):
        raise SystemExit(f"{out_dir} exists and is not empty — refusing to overwrite")

    b = load_models_once(config, flow_ckpt, device)
    model, n_classes = b["model"], b["n_classes"]
    H, W, C = b["latent_shape"]
    print(f"teacher {flow_ckpt}: {'bf16' if b['bf16'] else 'fp32'}, {n_classes} classes, "
          f"latents {H}x{W}x{C}; {method} n_steps={n_steps} cfg={cfg_strength} on {device}")

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed)
    n_val = int(n_pairs * val_frac)
    every = max(int(1 / max(val_frac, 1e-9)), 1)
    written = {"train": 0, "val": 0}
    batch_seconds, nfe, batch_idx = [], 0, 0
    t0 = time.time()
    with ThreadPoolExecutor(8) as writer:
        while written["train"] + written["val"] < n_pairs:
            t_b = time.time()
            noise = torch.randn((batch_size, H, W, C), generator=gen, device=device)
            labels = rng.integers(0, max(n_classes, 1), size=batch_size, dtype=np.int32)
            latents, nfe = sample_pairs(model, noise, labels, n_classes, method, n_steps,
                                        cfg_strength)
            latents = latents.float().cpu().numpy()
            noise_np = noise.cpu().numpy()
            batch_seconds.append(time.time() - t_b)
            for i in range(batch_size):
                total = written["train"] + written["val"]
                if total >= n_pairs:
                    break
                split = "val" if written["val"] < n_val and total % every == 0 else "train"
                d = os.path.join(out_dir, split,
                                 f"{labels[i]:04d}" if n_classes > 0 else "data")
                os.makedirs(d, exist_ok=True)
                writer.submit(np.savez, os.path.join(d, f"b{batch_idx:06d}_{i:03d}.npz"),
                              target_latents=latents[i], source_latents=noise_np[i])
                written[split] += 1
            batch_idx += 1
            done = written["train"] + written["val"]
            if batch_idx % 10 == 0 or done >= n_pairs:
                print(f"  {done}/{n_pairs} pairs ({done / max(time.time() - t0, 1e-9):.0f}/s)",
                      flush=True)
    seconds = time.time() - t0
    print(f"wrote {written['train']} train + {written['val']} val pairs to {out_dir}/ — "
          f"retrain with data={out_dir} +reflow=true")
    return {"out_dir": out_dir, **written, "batches": batch_idx, "nfe": nfe,
            "batch_seconds": batch_seconds, "seconds": seconds,
            "pairs_per_s": n_pairs / max(seconds, 1e-9)}


def main(argv=None) -> dict:
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    return make_reflow_pairs(config)


if __name__ == "__main__":
    main()
